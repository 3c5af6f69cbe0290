// float32 masked multi-head attention for Hopper (sm_90a): 3xTF32 products
// on the tensor cores (wgmma). Bound to Python with a plain C interface
// (ctypes) by asr2pass_tpu_torch/ops/attention.py, which also builds it
// and plans each shape's schedule (f32_schedule there). bfloat16 inputs go
// to csrc/attention_sm90.cu; both take their PTX helpers and the packed
// argument block from csrc/tma.cuh.
//
// Replaces, for float32 inputs, the three Pallas TPU kernels of the JAX
// package's ops/attention.py:
//   _mhss_kernel (mh_flash_attention, :129)  unsplit [B,T,D] / [B,T,2D]
//                                            projections, heads in d_k
//                                            column blocks, merged output
//   _ss_kernel   (_attention_ss, :261)       split-head [B,H,T,d], Tq != Tk
//   _kernel      (_attention_flash, :314)    split-head online softmax
// All three compute, per (batch, head, query row i):
//   s_j = (q_i . k_j) / sqrt(d),      j < Tk (keys past Tk: excluded)
//   s_j = -1e30 where kv_mask[j] <= 0 (finite, so a row with no valid key
//         averages V over the Tk real keys instead of producing NaN)
//   out_i = sum_j p_j v_j / max(sum_j p_j, 1e-30),  p_j = exp(s_j - m)
// and optionally write the rows whose q_mask is <= 0 as exact zeros.
//
// Precision. wgmma's .tf32 reads 32-bit words and ignores their low 13
// bits, so an fp32 operand fed as it is would be truncated to 11
// significant bits. Each operand x is split instead as hi = rna(x) (round
// to nearest, ties away, as cvt.rna.tf32.f32) and lo = x - hi, and each
// product is lo.hi + hi.lo + hi.hi, small terms first, into one fp32
// accumulator: about 22 significant bits against fp32's 24, which keeps
// the recognizer's card-vs-CPU check (a single TF32 product does not).
// The pre-pass rounds lo as well (rna(x - hi), tf32_split's planes); the
// Q and P splits in the product loop feed lo as it is, and wgmma's
// truncation of it moves a product by at most 2^-21 of |x y|, the order
// of the lo.lo term that 3xTF32 drops (two integer operations fewer a
// split: 6-8 % of the main kernel's time, PERF.md).
//
// What bounds it on this card: at the main-path shape (B=16, T=1024,
// D=512, 4 heads) the work is 4*B*T^2*D = 34 GFLOP, three times over on
// the tensor cores: 0.21 ms at 494.7 TFLOP/s, against 67 MB of input and
// output (20 us at 3.35 TB/s), so operations bound it; at the serving
// path's T = 256 bytes and launch latency do. The earlier design (one
// kernel a call) reached 10-34 % of its bound: every query block split K
// and V into hi and lo again, in lockstep with its products; a tile's
// loads waited on the products; grids of 8-100 blocks left most of the
// 132 SMs idle; and the host took longer than the device at T <= 260.
// The design answers each:
//   1. One pre-pass splits K and V once per (batch, head)
//      (attention_kernel_f32_presplit). It writes each tile of BK keys
//      (64; 32 at d = 256) as the exact shared-memory image the products
//      read: K hi, K lo (K-major, 32-column panels, 128-byte swizzle),
//      the tile's BK key states (1 valid, 0 masked, -1 past Tk), V^T hi,
//      V^T lo ([d, keys] in panels of 32 keys, the keys of each 8-group
//      in the order 0,2,4,6,1,3,5,7 that P's register layout needs, see
//      below); zeros past Tk and past d. It converts only the tiles up to
//      the batch's last valid key (all of them for a batch with none),
//      finds that bound on the device and leaves it, in tiles, for the
//      next kernels: no host sync.
//   2. The main kernel (attention_kernel_f32_sm90) has a producer that
//      keeps the tile images in flight, one bulk copy (no tensor map) for
//      each half: the K half (with the states) into a ring of K stages
//      as soon as both consumer warpgroups are done with S on the stage
//      it refills, the V half into a ring of V stages as soon as they are
//      done with P.V. At d = 128 one stage of each fits beside Q (64 KB
//      + 65 + 64 KB), and K(t+1) lands under the softmax and P.V of tile
//      t, V(t+1) under S(t+1); d = 64 has 2 stages, d = 32 has 4. No load
//      waits on a product of its own tile. The consumer warpgroups only
//      multiply and run the softmax: Q is loaded once, raw, by the warp
//      that uses its rows (no tensor map), and the A operand of S = Q.K^T
//      is split into hi and lo registers as it is used, two k8 slices at
//      a time in two alternating register sets; S as m64n64 wgmmas, the
//      online softmax on the S fragment, P split in registers, O += P.V.
//      The producer is a whole warpgroup beside two consumer warpgroups,
//      so that setmaxnreg can hand its registers to them (40 and 232; at
//      384 threads ptxas allocates 168, and each SM sub-partition then
//      holds two consumer warps and one producer warp, which is what
//      makes the exchange balance; launch refuses a build where it would
//      not). The two warpgroups of a block do not meet between tiles, so
//      one's softmax runs under the other's wgmmas wherever they drift
//      apart. An imposed ping-pong (each warpgroup issuing its S products
//      in turn on two named barriers) compiled without C7513 but timed
//      7-10 % slower: a turn is held while the S chain drains (PERF.md).
//   3. The grid fits 132 SMs: where ceil(Tq/rows)*H*B blocks leave a wave
//      short (8 at B=1 T=256, 36 at SenseVoice's 60 s, 1.45 and 2.4 waves
//      at B=2 T=3072 and 5120), f32_schedule splits the keys over S
//      blocks (S = 1..16, chosen by shape alone). Split s takes tiles
//      [s*per, (s+1)*per) of the batch's ceil(n/S) = per; it writes its
//      rows' (m, l, unnormalised O) to scratch, and a combine kernel
//      (attention_kernel_f32_combine) merges them: M = max m_s, out =
//      sum 2^(m_s-M) O_s / max(sum 2^(m_s-M) l_s, 1e-30). A split that
//      holds only masked keys carries m = -1e30 and drops out against a
//      valid one; a row with no valid key keeps the average over the Tk
//      real keys; an empty split is skipped.
//   4. The launch path is thin: ops/attention.py keeps a plan per shape,
//      strides and dtype with this call's int64 argument slots (tma.cuh's
//      PlanSlot), so a call is one ctypes call with the data pointers;
//      the launches, the device switch and the shared-memory opt-in
//      happen here.
// P comes from the S accumulator in registers: a thread holds columns 2t
// and 2t+1 of each 8-key group, while the A operand of a k8 step takes
// columns t and t+4. The sum over keys does not depend on their order,
// so V^T holds the keys of each group in the order 0,2,4,6,1,3,5,7, and P
// is split into hi and lo registers without going through shared memory.
// Shared memory a block: Q raw rows x d x 4 (d <= 128: 128 rows; d = 256:
// 64 rows), then the K and V rings: d = 128 64 KB + 65 KB + 64 KB; d =
// 256 (32-key tiles) the same; d = 64 32 KB + 2 x (33 + 32) KB; d = 32
// 16 KB + 4 x (17 + 16) KB (of 227 KB).
// The head dim is instantiated at 32, 64, 128 and 256 columns; any d <=
// 256 that is a multiple of 4 (the wrapper pads other head dims) runs on
// the next one up, with zeros past d. Grids: pre-pass (ceil(Tk/BK), H,
// B); main (ceil(Tq/rows) * S, H, B); combine (ceil(Tq*d/1024), H, B).
#include <math.h>

#include "tma.cuh"

namespace {

constexpr float kNeg = -1e30f;             // masked score (attention.py:34)
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kPanel = 32;                 // fp32 columns of a 128-byte panel
constexpr int kMaxSplits = 16;
constexpr int kPreThreads = 256;           // pre-pass and combine blocks
constexpr int kSmemLimit = 232448;         // dynamic shared memory a block

template <int D>
struct Cfg {
  static constexpr int WG = D <= 128 ? 2 : 1;     // consumer warpgroups
  static constexpr int ROWS = 64 * WG;            // query rows per block
  static constexpr int CWARPS = 4 * WG;           // consumer warps
  // the producer: a whole warpgroup beside two consumer warpgroups (so
  // that setmaxnreg can move its registers to them: each SM sub-partition
  // then holds two consumer warps and one producer warp), one warp beside
  // one (255 registers a thread are open to it anyway)
  static constexpr int PWARPS = WG == 2 ? 4 : 1;
  static constexpr int THREADS = 128 * WG + 32 * PWARPS;
  static constexpr int BK = D <= 128 ? 64 : 32;   // keys per tile
  static constexpr int Q_PANEL = ROWS * 128;
  static constexpr int KV_PANEL = BK * 128;       // K: BK keys x 32 columns
  static constexpr int VT_PANEL = D * 128;        // V^T: D rows x 32 keys
  static constexpr int PLANE = BK * D * 4;        // one hi or lo plane
  // a tile's image: K hi, K lo, the BK key states, then V^T hi, V^T lo;
  // the producer copies the K half (with the states) and the V half
  static constexpr int K_COPY = 2 * PLANE + BK * 4;
  static constexpr int V_COPY = 2 * PLANE;
  static constexpr int IMAGE = K_COPY + V_COPY;
  static constexpr int K_STAGE = (K_COPY + 1023) / 1024 * 1024;
  static constexpr int V_STAGE = V_COPY;
  static constexpr int Q_BYTES = ROWS * D * 4;
  static constexpr int FIT =
      (kSmemLimit - 1024 - 256 - Q_BYTES) / (K_STAGE + V_STAGE);
  static constexpr int NS = FIT >= 4 ? 4 : FIT;   // stages of each ring
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + NS * K_STAGE;
  // kfull[NS], kempty[NS], vfull[NS], vempty[NS]
  static constexpr int OFF_BAR = OFF_V + NS * V_STAGE;
  static constexpr int SMEM = OFF_BAR + 4 * NS * 8 + 1024;  // + alignment slack
  static_assert(NS >= 1 && SMEM <= kSmemLimit, "shared memory");
  static_assert(D % kPanel == 0 && BK % kPanel == 0 && Q_BYTES % 1024 == 0 &&
                    PLANE % 1024 == 0, "alignment");
  static_assert(K_COPY % 16 == 0, "bulk copies move multiples of 16 bytes");
};

// ---------------------------------------------------------------------------
// wgmma m64nNk8, tf32 in, fp32 accumulate: A from registers (4 tf32 words
// a thread), B from shared memory K-major, 128-byte swizzle; scale_d = 0
// overwrites d
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_tf32_n32(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n64(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_tf32_n256(float (&d)[128],
                                               const uint32_t (&a)[4],
                                               uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <int R>
__device__ __forceinline__ void wgmma_tf32(float (&d)[R], const uint32_t (&a)[4],
                                           uint64_t b, int scale_d) {
  if constexpr (R == 16) wgmma_tf32_n32(d, a, b, scale_d);
  else if constexpr (R == 32) wgmma_tf32_n64(d, a, b, scale_d);
  else if constexpr (R == 64) wgmma_tf32_n128(d, a, b, scale_d);
  else wgmma_tf32_n256(d, a, b, scale_d);
}

// round to the nearest tf32 value, ties away from zero, with its low 13
// bits zero, so wgmma reads it exactly: what cvt.rna.tf32.f32 gives for
// every finite value and inf (adding half of the dropped part's weight to
// the bit pattern rounds the magnitude; past the largest tf32 value it
// carries into inf). Two integer operations; the conversion instruction
// timed 9 % slower at every main-path shape (PERF.md)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, both tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// x = hi + lo with hi tf32 and lo the exact remainder, which wgmma reads
// truncated to tf32 (the product loop's split; see Precision above)
__device__ __forceinline__ void split_tf32_truncated_lo(float x, uint32_t& hi,
                                                        uint32_t& lo) {
  hi = to_tf32(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ float4 split4(float4 x, float4& lo) {
  uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
  split_tf32(x.x, h0, l0);
  split_tf32(x.y, h1, l1);
  split_tf32(x.z, h2, l2);
  split_tf32(x.w, h3, l3);
  lo = make_float4(__uint_as_float(l0), __uint_as_float(l1),
                   __uint_as_float(l2), __uint_as_float(l3));
  return make_float4(__uint_as_float(h0), __uint_as_float(h1),
                     __uint_as_float(h2), __uint_as_float(h3));
}

// byte offset of element (row, col) in a tile of 128-byte-swizzled
// 32-column panels, `panel` bytes apart: the layout wgmma reads as
// swizzle mode 1 (and TMA writes with CU_TENSOR_MAP_SWIZZLE_128B)
__device__ __forceinline__ int swz(int row, int col, int panel) {
  const int cc = col % kPanel;
  return (col / kPanel) * panel + row * 128 + (((cc / 4) ^ (row & 7)) * 16) +
         (cc % 4) * 4;
}

// ---------------------------------------------------------------------------
// the pre-pass: K and V of one tile (BK keys) of one (batch, head) split
// once into the tile's shared-memory image
// ---------------------------------------------------------------------------

// Tile t of (b, h) is read by the main kernel when a valid key sits at or
// after its first key, or when the batch has no valid key at all (then
// every key is averaged); those are the tiles up to the batch's last
// valid key. Block (0, 0, b) writes that count to tiles[b].
template <int D>
__global__ void __launch_bounds__(kPreThreads)
attention_kernel_f32_presplit(const float* __restrict__ k,
                              const float* __restrict__ v, Strides sk,
                              Strides sv, const float* __restrict__ kv_mask,
                              int heads, int tk, int d, int tiles_all,
                              uint8_t* __restrict__ images,
                              int* __restrict__ tiles) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  __shared__ float vs[BK][D + 1];    // the raw V tile (+1: no bank conflicts)
  __shared__ int last_key;
  const int t = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const float* mrow = kv_mask + static_cast<long long>(b) * tk;
  const int k0 = t * BK;
  if (t == 0 && h == 0) {
    if (tid == 0) last_key = -1;
    __syncthreads();
    int last = -1;
    for (int j = tid; j < tk; j += kPreThreads)
      if (mrow[j] > 0.f) last = j;
    last = __reduce_max_sync(0xffffffffu, last);
    if (tid % 32 == 0 && last >= 0) atomicMax(&last_key, last);
    __syncthreads();
    if (tid == 0) tiles[b] = last_key >= 0 ? last_key / BK + 1 : tiles_all;
  } else if (t > 0) {
    bool later = false;   // a valid key at or after k0
    for (int j0 = k0; j0 < tk; j0 += kPreThreads) {
      const int j = j0 + tid;
      if (__syncthreads_or(j < tk && mrow[j] > 0.f)) {
        later = true;
        break;
      }
    }
    if (!later) {
      for (int j0 = 0; j0 < k0; j0 += kPreThreads) {
        const int j = j0 + tid;
        if (__syncthreads_or(j < k0 && mrow[j] > 0.f)) return;  // not read
      }
    }
  }

  uint8_t* img = images + (static_cast<long long>(b * heads + h) * tiles_all +
                           t) * C::IMAGE;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  // K hi and lo in place of the wgmma B operand of S; the raw V tile into
  // shared memory; zeros past Tk and past d
#pragma unroll
  for (int u = 0; u < BK * D / 4 / kPreThreads; ++u) {
    const int i = tid + u * kPreThreads;
    const int r = i / (D / 4), col = 4 * (i % (D / 4));
    const int key = k0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
    if (key < tk && col < d) {
      x = *reinterpret_cast<const float4*>(kb + key * sk.t + col);
      y = *reinterpret_cast<const float4*>(vb + key * sv.t + col);
    }
    float4 lo;
    const float4 hi = split4(x, lo);
    const int at = swz(r, col, C::KV_PANEL);
    *reinterpret_cast<float4*>(img + at) = hi;
    *reinterpret_cast<float4*>(img + C::PLANE + at) = lo;
    vs[r][col] = y.x;
    vs[r][col + 1] = y.y;
    vs[r][col + 2] = y.z;
    vs[r][col + 3] = y.w;
  }
  if (tid < BK) {
    const int key = k0 + tid;
    reinterpret_cast<float*>(img + 2 * C::PLANE)[tid] =
        key < tk ? (mrow[key] > 0.f ? 1.f : 0.f) : -1.f;
  }
  __syncthreads();
  // V^T hi and lo, [D rows, BK keys] in panels of 32 keys, one 128-byte
  // swizzled row per head column: the 16-byte chunk at physical place p
  // of row c of panel n is logical chunk j = p ^ (c % 8), positions 32n +
  // 4j..4j+3, which hold keys 32n + 8(j/2) + (j%2) + 0, 2, 4, 6 (the keys
  // of each 8-group in the order 0,2,4,6,1,3,5,7)
  uint8_t* vt = img + C::K_COPY;
#pragma unroll
  for (int u = 0; u < D * 8 * (BK / 32) / kPreThreads; ++u) {
    const int i = tid + u * kPreThreads;
    const int n = i / (D * 8), c = (i / 8) % D, p = i % 8, j = p ^ (c & 7);
    const int key = 32 * n + 8 * (j / 2) + (j % 2);
    float4 lo;
    const float4 hi = split4(
        make_float4(vs[key][c], vs[key + 2][c], vs[key + 4][c],
                    vs[key + 6][c]),
        lo);
    const int at = n * C::VT_PANEL + c * 128 + p * 16;
    *reinterpret_cast<float4*>(vt + at) = hi;
    *reinterpret_cast<float4*>(vt + C::PLANE + at) = lo;
  }
}

// ---------------------------------------------------------------------------
// the main kernel
// ---------------------------------------------------------------------------

// Fragment layout of a wgmma accumulator (m64nN, fp32): thread t of a
// warpgroup holds N/2 values; value r sits at row 16*(t/32) + (t%32)/4 +
// 8*((r/2)%2) and column 8*(r/4) + 2*(t%4) + r%2. The register A operand of
// an m64nNk8 tf32 step: a0 (row g, column t%4), a1 (row g+8, column t%4),
// a2 (row g, column t%4+4), a3 (row g+8, column t%4+4), g = (t%32)/4.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
attention_kernel_f32_sm90(const float* __restrict__ q, Strides sq,
                          const uint8_t* __restrict__ images,
                          const int* __restrict__ tiles,
                          const float* __restrict__ q_mask,
                          float* __restrict__ out, Strides so,
                          float* __restrict__ part_o,
                          float* __restrict__ part_ml, int batch, int heads,
                          int tq, int tk, int d, int tiles_all, int splits,
                          float scale_log2) {
  using C = Cfg<D>;
  constexpr int NS = C::NS;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  const uint32_t bar = base + C::OFF_BAR;
  auto kfull = [&](int s) { return bar + 8 * s; };
  auto kempty = [&](int s) { return bar + 8 * (NS + s); };
  auto vfull = [&](int s) { return bar + 8 * (2 * NS + s); };
  auto vempty = [&](int s) { return bar + 8 * (3 * NS + s); };

  const int qblocks = (tq + C::ROWS - 1) / C::ROWS;
  const int qb = blockIdx.x % qblocks;
  const int split = blockIdx.x / qblocks;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qb * C::ROWS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // this block's key tiles: its split's share of the batch's tiles
  const int n_tiles = tk > 0 ? tiles[b] : 0;
  const int per = (n_tiles + splits - 1) / splits;
  const int t_begin = split * per;
  const int n = min(n_tiles, t_begin + per) - t_begin;
  if (splits > 1 && n <= 0) return;   // an empty split: the combine skips it

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(kfull(s), 1);
      mbar_init(kempty(s), C::CWARPS);   // one arrival per consumer warp
      mbar_init(vfull(s), 1);
      mbar_init(vempty(s), C::CWARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= C::CWARPS) {
    // ---- producer: one bulk copy a K half (with the key states) as soon
    // as the consumers are done with the K stage it goes to, one a V half
    // as soon as they are done with the V stage; NS tiles ahead ----
    if constexpr (C::PWARPS == 4)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
    if (warp == C::CWARPS && lane == 0) {
      const uint8_t* src =
          images + (static_cast<long long>(b * heads + h) * tiles_all + t_begin) *
                       C::IMAGE;
      for (int i = 0; i < n; ++i) {
        const int s = i % NS;
        const uint8_t* img = src + static_cast<long long>(i) * C::IMAGE;
        if (i >= NS) mbar_wait(kempty(s), ((i / NS) + 1) & 1);
        mbar_expect_tx(kfull(s), C::K_COPY);
        bulk_load(base + C::OFF_K + s * C::K_STAGE, img, C::K_COPY, kfull(s));
        if (i >= NS) mbar_wait(vempty(s), ((i / NS) + 1) & 1);
        mbar_expect_tx(vfull(s), C::V_COPY);
        bulk_load(base + C::OFF_V + s * C::V_STAGE, img + C::K_COPY, C::V_COPY,
                  vfull(s));
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  if constexpr (C::PWARPS == 4)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
  const int wg = warp / 4;
  const int g = lane / 4;         // row within the warp's 8-row group
  const int t4 = lane % 4;
  const int c2 = 2 * t4;          // first of the thread's column pair
  const int rw = wg * 64 + (warp % 4) * 16;  // the warp's first row
  const int r0 = rw + g;          // the thread's first row

  // the warp's 16 rows of Q, raw, into the swizzled panels (zeros past Tq
  // and past d); only this warp reads them
  {
    const float* qrow = q + b * sq.b + h * sq.h;
#pragma unroll
    for (int u = 0; u < D / 8; ++u) {   // 16 rows x D/4 float4s, 32 lanes
      const int i = lane + 32 * u;
      const int r = rw + i / (D / 4), col = 4 * (i % (D / 4));
      const int row = q0 + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < tq && col < d)
        x = *reinterpret_cast<const float4*>(qrow + row * sq.t + col);
      *reinterpret_cast<float4*>(smem + swz(r, col, C::Q_PANEL)) = x;
    }
    __syncwarp();
  }

  float o[D / 2];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) o[r] = 0.f;
  float m[2] = {kNeg, kNeg};      // running max of rows g and g+8 (log2 units)
  float l[2] = {0.f, 0.f};        // this thread's share of the row sums

  const uint8_t* qs = smem;
  // the A operand of S: rows r0 and r0+8 (both have row & 7 == g), the
  // k8 slice's columns t4 and t4+4 sit in 16-byte chunks 2(kk%4) and +1
  auto q_slice = [&](int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
    const int pbase = (kk / 4) * C::Q_PANEL + t4 * 4;
    const int ch = 2 * (kk % 4);
    const float x0 = *reinterpret_cast<const float*>(
        qs + pbase + r0 * 128 + ((ch ^ g) * 16));
    const float x1 = *reinterpret_cast<const float*>(
        qs + pbase + (r0 + 8) * 128 + ((ch ^ g) * 16));
    const float x2 = *reinterpret_cast<const float*>(
        qs + pbase + r0 * 128 + (((ch + 1) ^ g) * 16));
    const float x3 = *reinterpret_cast<const float*>(
        qs + pbase + (r0 + 8) * 128 + (((ch + 1) ^ g) * 16));
    split_tf32_truncated_lo(x0, hi[0], lo[0]);
    split_tf32_truncated_lo(x1, hi[1], lo[1]);
    split_tf32_truncated_lo(x2, hi[2], lo[2]);
    split_tf32_truncated_lo(x3, hi[3], lo[3]);
  };

  for (int i = 0; i < n; ++i) {
    const int s = i % NS;
    const uint32_t parity = (i / NS) & 1;
    const uint32_t ks = base + C::OFF_K + s * C::K_STAGE;
    const uint32_t vs = base + C::OFF_V + s * C::V_STAGE;
    const float* st = reinterpret_cast<const float*>(
        smem + C::OFF_K + s * C::K_STAGE + 2 * C::PLANE);
    mbar_wait(kfull(s), parity);

    // the key states of the thread's BK/4 columns as bits: valid, past Tk
    uint32_t valid_bits = 0, past_bits = 0;
#pragma unroll
    for (int jj = 0; jj < BK / 8; ++jj) {
      const float2 x = *reinterpret_cast<const float2*>(st + 8 * jj + c2);
      valid_bits |= (x.x > 0.f ? 1u : 0u) << (2 * jj);
      valid_bits |= (x.y > 0.f ? 1u : 0u) << (2 * jj + 1);
      past_bits |= (x.x < 0.f ? 1u : 0u) << (2 * jj);
      past_bits |= (x.y < 0.f ? 1u : 0u) << (2 * jj + 1);
    }
    const bool all_valid = __all_sync(
        0xffffffffu, valid_bits == (BK / 4 == 32 ? ~0u : (1u << (BK / 4)) - 1));

    // S = Q K^T over the head dim: D/8 k8 slices, two at a time, each as
    // Qlo.Khi + Qhi.Klo + Qhi.Khi
    float sc[BK / 2];
    uint32_t a_hi[2][2][4], a_lo[2][2][4];
    const uint32_t khi = ks, klo = ks + C::PLANE;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const int set = c & 1;
      if (c >= 2) {
        wgmma_wait<1>();   // chunk c-2, the last reader of this set, is done
        fence_regs(a_hi[set]);
        fence_regs(a_lo[set]);
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) q_slice(2 * c + u, a_hi[set][u], a_lo[set][u]);
      fence_regs(a_hi[set]);
      fence_regs(a_lo[set]);
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kk = 2 * c + u;
        const int off = (kk / 4) * C::KV_PANEL + (kk % 4) * 32;
        const uint64_t bh = make_desc(khi + off, 16, 1024, 1);
        const uint64_t bl = make_desc(klo + off, 16, 1024, 1);
        wgmma_tf32(sc, a_lo[set][u], bh, kk > 0);
        wgmma_tf32(sc, a_hi[set][u], bl, 1);
        wgmma_tf32(sc, a_hi[set][u], bh, 1);
      }
      wgmma_commit();
    }
    wgmma_wait_all();
    fence_regs(sc);
    // this warp is done with the K stage: the producer may refill it
    // while the softmax and P.V run
    __syncwarp();
    if (lane == 0) mbar_arrive(kempty(s));

    // scale into log2 units and mask; -1e30 and -inf after scaling
    if (all_valid) {
#pragma unroll
      for (int r = 0; r < BK / 2; ++r) sc[r] *= scale_log2;
    } else {
#pragma unroll
      for (int r = 0; r < BK / 2; ++r) {
        const int bit = 2 * (r / 4) + (r % 2);
        sc[r] = (valid_bits >> bit) & 1u ? sc[r] * scale_log2
                : ((past_bits >> bit) & 1u ? -INFINITY : kNeg);
      }
    }

    // online softmax on rows g (half 0) and g+8 (half 1)
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int r = 0; r < BK / 2; ++r) {
      const int half = (r / 2) % 2;
      mx[half] = fmaxf(mx[half], sc[r]);
    }
    float alpha[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      alpha[half] = exp2f(m[half] - mx[half]);
      m[half] = mx[half];
    }
    // P as the A operand of P.V, split: slice j takes keys 8j..8j+7 in
    // the order 0,2,4,6,1,3,5,7 (V^T is written in that order)
    float sum[2] = {0.f, 0.f};
    uint32_t p_hi[BK / 8][4], p_lo[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = exp2f(sc[4 * j] - mx[0]);      // row g,   key 2t
      const float p1 = exp2f(sc[4 * j + 1] - mx[0]);  // row g,   key 2t+1
      const float p2 = exp2f(sc[4 * j + 2] - mx[1]);  // row g+8, key 2t
      const float p3 = exp2f(sc[4 * j + 3] - mx[1]);  // row g+8, key 2t+1
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      split_tf32_truncated_lo(p0, p_hi[j][0], p_lo[j][0]);
      split_tf32_truncated_lo(p2, p_hi[j][1], p_lo[j][1]);
      split_tf32_truncated_lo(p1, p_hi[j][2], p_lo[j][2]);
      split_tf32_truncated_lo(p3, p_hi[j][3], p_lo[j][3]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) l[half] = l[half] * alpha[half] + sum[half];
    // rescale the accumulator only where a row's max moved (warp-uniform)
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int r = 0; r < D / 2; ++r) o[r] *= alpha[(r / 2) % 2];
    }

    // O += P V over the tile's keys: BK/8 k8 slices, Plo.Vhi + Phi.Vlo +
    // Phi.Vhi; V^T is [d, keys], K-major, in panels of 32 keys
    mbar_wait(vfull(s), parity);
    const uint32_t vh = vs, vl = vs + C::PLANE;
    fence_regs(o);
    fence_regs(p_hi);
    fence_regs(p_lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const int off = (kk / 4) * C::VT_PANEL + (kk % 4) * 32;
      const uint64_t bh = make_desc(vh + off, 16, 1024, 1);
      const uint64_t bl = make_desc(vl + off, 16, 1024, 1);
      wgmma_tf32(o, p_lo[kk], bh, 1);
      wgmma_tf32(o, p_hi[kk], bl, 1);
      wgmma_tf32(o, p_hi[kk], bh, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    // this warp is done with the V stage
    __syncwarp();
    if (lane == 0) mbar_arrive(vempty(s));
  }

  // the row sums over the 4 threads of a row
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
  }
  if (splits == 1) {
    // normalise, zero the q_mask rows, store fp32 pairs
    float* ob = out + b * so.b + h * so.h;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + r0 + 8 * half;
      if (row >= tq) continue;
      const float inv = 1.f / fmaxf(l[half], 1e-30f);
      const bool zero = q_mask != nullptr &&
                        !(q_mask[static_cast<long long>(b) * tq + row] > 0.f);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + c2;
        if (col >= d) continue;
        const float x0 = zero ? 0.f : o[4 * j + 2 * half] * inv;
        const float x1 = zero ? 0.f : o[4 * j + 2 * half + 1] * inv;
        *reinterpret_cast<float2*>(ob + row * so.t + col) = make_float2(x0, x1);
      }
    }
    return;
  }
  // a split's partials: the rows' m and l, and O unnormalised,
  // [split, batch, head, row] (x d for O)
  const long long slot =
      (static_cast<long long>(split) * batch + b) * heads + h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + 8 * half;
    if (row >= tq) continue;
    const long long at = slot * tq + row;
    if (t4 == 0)
      *reinterpret_cast<float2*>(part_ml + 2 * at) = make_float2(m[half], l[half]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + c2;
      if (col >= d) continue;
      *reinterpret_cast<float2*>(part_o + at * d + col) =
          make_float2(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// the combine: the splits' partials of each row merged, normalised, the
// q_mask rows zeroed; one thread a row's 4 columns
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kPreThreads)
attention_kernel_f32_combine(const float* __restrict__ part_o,
                             const float* __restrict__ part_ml,
                             const int* __restrict__ tiles,
                             const float* __restrict__ q_mask,
                             float* __restrict__ out, Strides so, int batch,
                             int heads, int tq, int d, int splits) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int cols = d / 4;
  const int i = blockIdx.x * kPreThreads + threadIdx.x;
  if (i >= tq * cols) return;
  const int row = i / cols, col = 4 * (i % cols);
  // the splits that hold tiles, as the main kernel divided them
  const int n_tiles = tiles[b];
  const int per = (n_tiles + splits - 1) / splits;
  const int used = (n_tiles + per - 1) / per;
  const long long stride = static_cast<long long>(batch) * heads * tq;
  const long long at0 = (static_cast<long long>(b) * heads + h) * tq + row;
  float mmax = -INFINITY;
  for (int s = 0; s < used; ++s) mmax = fmaxf(mmax, part_ml[2 * (s * stride + at0)]);
  float lsum = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < used; ++s) {
    const long long at = s * stride + at0;
    const float2 ml = *reinterpret_cast<const float2*>(part_ml + 2 * at);
    const float w = exp2f(ml.x - mmax);
    lsum += w * ml.y;
    const float4 x = *reinterpret_cast<const float4*>(part_o + at * d + col);
    acc.x += w * x.x;
    acc.y += w * x.y;
    acc.z += w * x.z;
    acc.w += w * x.w;
  }
  const bool zero = q_mask != nullptr &&
                    !(q_mask[static_cast<long long>(b) * tq + row] > 0.f);
  const float inv = 1.f / fmaxf(lsum, 1e-30f);
  *reinterpret_cast<float4*>(out + b * so.b + h * so.h + row * so.t + col) =
      zero ? make_float4(0.f, 0.f, 0.f, 0.f)
           : make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
}

// ---------------------------------------------------------------------------
// host side: the three launches of one call
// ---------------------------------------------------------------------------

template <int D>
cudaError_t set_smem_f32() {
  static std::atomic<uint64_t> done{0};
  static std::atomic<int> regs_checked{0};
  if (Cfg<D>::PWARPS == 4 && !regs_checked.load(std::memory_order_acquire)) {
    // setmaxnreg moves a producer warp's registers (down to 40) to the two
    // consumer warps (up to 232) of its SM sub-partition: that balances
    // only where ptxas gave the kernel the 168 registers that 384 threads
    // allow; with fewer, the consumers' setmaxnreg.inc would never return
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, attention_kernel_f32_sm90<D>);
    if (err != cudaSuccess) return err;
    if (2 * 232 + 40 > 3 * attr.numRegs) return cudaErrorInvalidConfiguration;
    regs_checked.store(1, std::memory_order_release);
  }
  return set_smem_once(attention_kernel_f32_sm90<D>, Cfg<D>::SMEM, done);
}

// steps: 1 the pre-pass, 2 the main kernel, 4 the combine (7: a whole
// call; the others leave the scratch for the card's tests)
template <int D>
int launch(const long long* plan, const float* q, const float* k,
           const float* v, const float* kv_mask, const float* q_mask,
           float* out, uint8_t* scratch, cudaStream_t stream, int steps) {
  using C = Cfg<D>;
  const int batch = static_cast<int>(plan[kSlotBatch]);
  const int heads = static_cast<int>(plan[kSlotHeads]);
  const int tq = static_cast<int>(plan[kSlotTq]);
  const int tk = static_cast<int>(plan[kSlotTk]);
  const int d = static_cast<int>(plan[kSlotD]);
  const int splits = static_cast<int>(plan[kSlotSplits]);
  const int tiles_all = static_cast<int>(plan[kSlotTiles]);
  if (tiles_all != (tk + C::BK - 1) / C::BK || splits < 1 ||
      splits > kMaxSplits || (splits > 1 && tk == 0) || batch < 1 ||
      heads < 1 || tq < 1 || tk < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq = plan_strides(plan, 0), sk = plan_strides(plan, 1),
                sv = plan_strides(plan, 2), so = plan_strides(plan, 3);
  int* tiles = reinterpret_cast<int*>(scratch + plan[kSlotOffTiles]);
  uint8_t* images = scratch + plan[kSlotOffImages];
  float* part_o = reinterpret_cast<float*>(scratch + plan[kSlotOffPartO]);
  float* part_ml = reinterpret_cast<float*>(scratch + plan[kSlotOffPartMl]);
  const float scale =
      static_cast<float>(1.0 / sqrt(static_cast<double>(plan[kSlotDScale])));
  cudaError_t err = set_smem_f32<D>();
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((steps & 1) && tk > 0) {
    attention_kernel_f32_presplit<D>
        <<<dim3(tiles_all, heads, batch), kPreThreads, 0, stream>>>(
            k, v, sk, sv, kv_mask, heads, tk, d, tiles_all, images, tiles);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (steps & 2) {
    const int qblocks = (tq + C::ROWS - 1) / C::ROWS;
    attention_kernel_f32_sm90<D>
        <<<dim3(qblocks * splits, heads, batch), C::THREADS, C::SMEM, stream>>>(
            q, sq, images, tiles, q_mask, out, so, part_o, part_ml, batch,
            heads, tq, tk, d, tiles_all, splits, scale * kLog2e);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if ((steps & 4) && splits > 1) {
    const int items = tq * (d / 4);
    attention_kernel_f32_combine<<<
        dim3((items + kPreThreads - 1) / kPreThreads, heads, batch),
        kPreThreads, 0, stream>>>(part_o, part_ml, tiles, q_mask, out, so,
                                  batch, heads, tq, d, splits);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

int dispatch(const long long* plan, const void* q, const void* k,
             const void* v, const void* kv_mask, const void* q_mask,
             void* out, void* scratch, void* stream, int steps) {
  const int d = static_cast<int>(plan[kSlotD]);
  if (d < 4 || d > 256 || d % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(static_cast<int>(plan[kSlotDevice]));
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* km = static_cast<const float*>(kv_mask);
  const float* qm = static_cast<const float*>(q_mask);
  float* of = static_cast<float*>(out);
  uint8_t* sc = static_cast<uint8_t*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 32) return launch<32>(plan, qf, kf, vf, km, qm, of, sc, s, steps);
  if (d <= 64) return launch<64>(plan, qf, kf, vf, km, qm, of, sc, s, steps);
  if (d <= 128) return launch<128>(plan, qf, kf, vf, km, qm, of, sc, s, steps);
  return launch<256>(plan, qf, kf, vf, km, qm, of, sc, s, steps);
}

}  // namespace

// One call of the kernel: the pre-pass, the main kernel and, for a split
// schedule, the combine, on `stream`, on the plan's device.
// plan: the packed block (tma.cuh PlanSlot), written by ops/attention.py
// for this shape: strides of q, k, v, out as (batch, head, row) element
// strides (multiples of 4; q, k, v 16-byte aligned; out 16-byte aligned),
// the head dim (a multiple of 4 up to 256), the schedule and the scratch
// offsets. kv_mask: float32 [batch, tk]; q_mask: float32 [batch, tq] or
// null. scratch: the wrapper's buffer of f32_schedule's size.
// Returns a cudaError_t (0 on success).
extern "C" int asr2pass_attention_f32(const long long* plan, const void* q,
                                      const void* k, const void* v,
                                      const void* kv_mask, const void* q_mask,
                                      void* out, void* scratch, void* stream) {
  return dispatch(plan, q, k, v, kv_mask, q_mask, out, scratch, stream, 7);
}

// The same call limited to some of its launches (steps: 1 pre-pass, 2
// main, 4 combine), so that the card's tests can read the scratch each
// step leaves against its plain version in ops/attention.py.
extern "C" int asr2pass_attention_f32_steps(const long long* plan,
                                            const void* q, const void* k,
                                            const void* v, const void* kv_mask,
                                            const void* q_mask, void* out,
                                            void* scratch, void* stream,
                                            int steps) {
  return dispatch(plan, q, k, v, kv_mask, q_mask, out, scratch, stream, steps);
}

// Dynamic shared memory of one main-kernel block for a head dim (0 if out
// of range).
extern "C" int asr2pass_attention_f32_smem(int d_head) {
  if (d_head < 1 || d_head > 256) return 0;
  if (d_head <= 32) return Cfg<32>::SMEM;
  if (d_head <= 64) return Cfg<64>::SMEM;
  if (d_head <= 128) return Cfg<128>::SMEM;
  return Cfg<256>::SMEM;
}

template <int D>
int image_fact(int what) {
  return what == 0 ? Cfg<D>::IMAGE : what == 1 ? Cfg<D>::NS : Cfg<D>::BK;
}

// For a head dim (0 if out of range): what 0, the bytes of one key
// tile's image in the scratch (f32_schedule's image_bytes); 1, the stages
// of the K and V rings; 2, the keys of a tile.
extern "C" int asr2pass_attention_f32_image(int d_head, int what) {
  if (d_head < 1 || d_head > 256) return 0;
  if (d_head <= 32) return image_fact<32>(what);
  if (d_head <= 64) return image_fact<64>(what);
  if (d_head <= 128) return image_fact<128>(what);
  return image_fact<256>(what);
}
