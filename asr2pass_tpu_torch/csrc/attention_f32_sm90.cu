// float32 masked multi-head attention for Hopper (sm_90a): 3xTF32 products
// on the tensor cores (wgmma) fed by TMA. Bound to Python with a plain C
// interface (ctypes) by asr2pass_tpu_torch/ops/attention.py, which also
// builds it. bfloat16 inputs go to csrc/attention_sm90.cu; both kernels
// take their tensor maps and PTX helpers from csrc/tma.cuh.
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
// significant bits. Each operand x is split instead as hi = rna(x), lo =
// rna(x - hi) (round to nearest, ties away, as cvt.rna.tf32.f32), and each
// product is lo.hi + hi.lo + hi.hi, small terms first, into one fp32
// accumulator: about 22 significant bits against fp32's 24, which keeps
// the recognizer's card-vs-CPU check (a single TF32 product does not).
//
// What bounds it on this card: at the main-path shape (B=16, T=1024,
// D=512, 4 heads) the work is 4*B*T^2*D = 34 GFLOP, three times over on
// the tensor cores: 0.21 ms at 494.7 TFLOP/s, against 67 MB of input and
// output (20 us at 3.35 TB/s). Operations bound it. The design keeps all
// six products on the tensor cores and the [Tq,Tk] scores out of device
// memory:
//   - a block owns 128 query rows of one (batch, head) for head dims up
//     to 128 (two consumer warpgroups of 64 rows, wgmma's M), 64 rows for
//     d = 256 (one warpgroup); thread 0 issues the TMA loads;
//   - Q arrives once, raw, in 128-byte-swizzled panels of 32 columns. It
//     is the register A operand of S = Q.K^T: each k8 slice is read from
//     shared memory and split into hi and lo registers as it is used, two
//     slices at a time in two alternating register sets, so one set's
//     wgmmas run while the next is split;
//   - K arrives raw into its hi buffer in the same swizzled layout that
//     wgmma reads as a K-major B operand; the consumers split it in place
//     (hi over the raw value, lo into a second buffer at the same offset),
//     then fence.proxy.async before the product;
//   - V arrives raw. wgmma takes .tf32 operands K-major only (no transpose
//     flag), and V is [keys, d] with d contiguous, so the conversion pass
//     writes V^T as hi and lo, [d, keys], swizzled;
//   - P comes from the S accumulator in registers: a thread holds columns
//     2t and 2t+1 of each 8-key group, while the A operand of a k8 step
//     takes columns t and t+4. The sum over keys does not depend on their
//     order, so V^T holds the keys of each group in the order
//     0,2,4,6,1,3,5,7, and P is split into hi and lo registers without
//     going through shared memory. The online softmax (exp2, fp32 m, l
//     and O) runs on the S fragment as in the bf16 kernel.
// Shared memory a block (one stage of each buffer):
//   Q raw  rows x d x 4          d<=128: 128 rows;  d=256: 64 rows
//   K hi, K lo, V raw, V^T hi, V^T lo: 5 x keys x d x 4
//                                d<=128: 64 keys;   d=256: 32 keys
//   d = 128: 64 KB + 5 x 32 KB = 224 KB; d = 256: 64 KB + 5 x 32 KB, the
//   same; d = 64: 112 KB; d = 32: 56 KB (of 227 KB).
// One stage, and the conversion passes under the products: a tile's K
// is split while the previous tile's P.V product runs (tile 0's first),
// its V^T written while its own S product runs. The two warpgroups meet
// at two named barriers a tile: before S (K split, V^T free) and after
// it (V^T written; K and raw V free, so thread 0 loads the next tile's,
// which land during the softmax and P.V).
// A block skips the key tiles after its batch's last valid key: they add
// exactly nothing to a row that has a valid key, so the work follows the
// masks' lengths (as the bound does) rather than Tk.
// The head dim is instantiated at 32, 64, 128 and 256 columns; any d <=
// 256 that is a multiple of 4 (TMA's 16-byte rule; the wrapper pads other
// head dims) runs on the next one up: TMA's zero fill, not the next
// head's columns, pads the tile. Grid: (ceil(Tq/rows), H, B).
#include <math.h>

#include "tma.cuh"

namespace {

constexpr float kNeg = -1e30f;             // masked score (attention.py:34)
constexpr float kLog2e = 1.4426950408889634f;
constexpr CUtensorMapDataType kF32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
constexpr int kPanel = 32;                 // fp32 columns of a 128-byte panel

template <int D>
struct Cfg {
  static constexpr int WG = D <= 128 ? 2 : 1;     // consumer warpgroups
  static constexpr int ROWS = 64 * WG;            // query rows per block
  static constexpr int THREADS = 128 * WG;
  static constexpr int BK = D <= 128 ? 64 : 32;   // keys per tile
  static constexpr int NP = D / kPanel;           // column panels of Q, K, V
  static constexpr int Q_PANEL = ROWS * 128;
  static constexpr int KV_PANEL = BK * 128;       // one panel of K or V raw
  static constexpr int VT_PANEL = D * 128;        // 32 keys of V^T
  static constexpr int Q_BYTES = ROWS * D * 4;
  static constexpr int KV_BYTES = BK * D * 4;
  static constexpr int OFF_KHI = Q_BYTES;
  static constexpr int OFF_KLO = OFF_KHI + KV_BYTES;
  static constexpr int OFF_V = OFF_KLO + KV_BYTES;
  static constexpr int OFF_VTHI = OFF_V + KV_BYTES;
  static constexpr int OFF_VTLO = OFF_VTHI + KV_BYTES;
  static constexpr int OFF_STATE = OFF_VTLO + KV_BYTES;  // float [BK]
  static constexpr int OFF_FLAG = OFF_STATE + BK * 4;    // int [2]
  static constexpr int OFF_BAR = OFF_FLAG + 16;          // 3 mbarriers
  static constexpr int SMEM = OFF_BAR + 3 * 8 + 1024;    // + alignment slack
  // the conversion passes: float4s of K a thread, (32 keys x 4 columns)
  // items of V a warp, and how many of each are loaded at once
  static constexpr int K_PER = KV_BYTES / 16 / THREADS;
  static constexpr int V_PER = (BK / 32) * (D / 4) / (THREADS / 32);
  static constexpr int K_GROUP = K_PER < 8 ? K_PER : 8;
  static constexpr int V_GROUP = V_PER < 8 ? V_PER : 8;
  static_assert(K_PER % K_GROUP == 0 && V_PER % V_GROUP == 0, "passes");
  static_assert(D % kPanel == 0 && BK % kPanel == 0, "tile");
  static_assert(Q_BYTES % 1024 == 0 && KV_BYTES % 1024 == 0, "alignment");
  static_assert(SMEM <= 232448, "shared memory");
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

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// all consumer threads of the block (named barrier 1)
template <int N>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(N) : "memory");
}

// byte offset of element (row, col) in a tile of 128-byte-swizzled
// 32-column panels, `panel` bytes apart: the layout TMA writes with
// CU_TENSOR_MAP_SWIZZLE_128B and wgmma reads as swizzle mode 1
__device__ __forceinline__ int swz(int row, int col, int panel) {
  const int cc = col % kPanel;
  return (col / kPanel) * panel + row * 128 + (((cc / 4) ^ (row & 7)) * 16) +
         (cc % 4) * 4;
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// Fragment layout of a wgmma accumulator (m64nN, fp32): thread t of a
// warpgroup holds N/2 values; value r sits at row 16*(t/32) + (t%32)/4 +
// 8*((r/2)%2) and column 8*(r/4) + 2*(t%4) + r%2. The register A operand of
// an m64nNk8 tf32 step: a0 (row g, column t%4), a1 (row g+8, column t%4),
// a2 (row g, column t%4+4), a3 (row g+8, column t%4+4), g = (t%32)/4.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
attention_kernel_f32_sm90(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v, Perm pq,
                          Perm pk, Perm pv, const float* __restrict__ kv_mask,
                          const float* __restrict__ q_mask,
                          float* __restrict__ out, int tq, int tk, int d,
                          Strides so, float scale_log2) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  constexpr int NT = C::THREADS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  float* key_state = reinterpret_cast<float*>(smem + C::OFF_STATE);
  int* tile_valid = reinterpret_cast<int*>(smem + C::OFF_FLAG);
  const uint32_t bar_q = base + C::OFF_BAR;
  const uint32_t bar_k = bar_q + 8;
  const uint32_t bar_v = bar_q + 16;

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * C::ROWS;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int all_tiles = (tk + BK - 1) / BK;

  auto load_k = [&](int t) {
    mbar_expect_tx(bar_k, C::KV_BYTES);
    for (int p = 0; p < C::NP; ++p)
      tma_load(base + C::OFF_KHI + p * C::KV_PANEL, &map_k, bar_k, p * kPanel,
               t * BK, h, b, pk);
  };
  auto load_v = [&](int t) {
    mbar_expect_tx(bar_v, C::KV_BYTES);
    for (int p = 0; p < C::NP; ++p)
      tma_load(base + C::OFF_V + p * C::KV_PANEL, &map_v, bar_v, p * kPanel,
               t * BK, h, b, pv);
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_k, 1);
    mbar_init(bar_v, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar_q, C::Q_BYTES);
    for (int p = 0; p < C::NP; ++p)
      tma_load(base + p * C::Q_PANEL, &map_q, bar_q, p * kPanel, q0, h, b, pq);
    if (all_tiles > 0) {
      load_k(0);
      load_v(0);
    }
    tile_valid[1] = -1;
  }
  __syncthreads();

  // The tiles after the one holding the last valid key are all masked or
  // past Tk: to a row with a valid key they add exactly nothing (p =
  // exp2(-1e30 - m) = 0, alpha = 1), so they are skipped. A batch with no
  // valid key averages V over all Tk keys and runs every tile.
  {
    const float* mrow = kv_mask + static_cast<long long>(b) * tk;
    int last = -1;
    for (int j = tid; j < tk; j += NT)
      if (mrow[j] > 0.f) last = j;
    last = __reduce_max_sync(0xffffffffu, last);
    if (lane == 0 && last >= 0) atomicMax(tile_valid + 1, last);
  }
  __syncthreads();
  const int n_tiles = tile_valid[1] >= 0 ? tile_valid[1] / BK + 1 : all_tiles;

  const int wg = warp / 4;
  const int g = lane / 4;         // row within the warp's 8-row group
  const int t4 = lane % 4;
  const int c2 = 2 * t4;          // first of the thread's column pair
  const int r0 = wg * 64 + (warp % 4) * 16 + g;  // the thread's first row
  float o[D / 2];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) o[r] = 0.f;
  float m[2] = {kNeg, kNeg};      // running max of rows g and g+8 (log2 units)
  float l[2] = {0.f, 0.f};        // this thread's share of the row sums

  float4* khi4 = reinterpret_cast<float4*>(smem + C::OFF_KHI);
  float4* klo4 = reinterpret_cast<float4*>(smem + C::OFF_KLO);
  const uint8_t* qs = smem;
  const uint8_t* vraw = smem + C::OFF_V;
  uint8_t* vthi = smem + C::OFF_VTHI;
  uint8_t* vtlo = smem + C::OFF_VTLO;
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
    split_tf32(x0, hi[0], lo[0]);
    split_tf32(x1, hi[1], lo[1]);
    split_tf32(x2, hi[2], lo[2]);
    split_tf32(x3, hi[3], lo[3]);
  };

  // split K of tile t in place: hi over the raw value, lo at the same
  // offset; then fence it for wgmma's reads
  auto split_k = [&](int t) {
    mbar_wait(bar_k, t & 1);
    // C::K_GROUP float4s a thread at a time, all loads issued first
    for (int n0 = 0; n0 < C::K_PER; n0 += C::K_GROUP) {
      float4 x[C::K_GROUP];
#pragma unroll
      for (int n = 0; n < C::K_GROUP; ++n) x[n] = khi4[tid + (n0 + n) * NT];
#pragma unroll
      for (int n = 0; n < C::K_GROUP; ++n) {
        uint32_t h0, h1, h2, h3, l0, l1, l2, l3;
        split_tf32(x[n].x, h0, l0);
        split_tf32(x[n].y, h1, l1);
        split_tf32(x[n].z, h2, l2);
        split_tf32(x[n].w, h3, l3);
        const int i = tid + (n0 + n) * NT;
        khi4[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                              __uint_as_float(h2), __uint_as_float(h3));
        klo4[i] = make_float4(__uint_as_float(l0), __uint_as_float(l1),
                              __uint_as_float(l2), __uint_as_float(l3));
      }
    }
    fence_proxy_async();
  };

  mbar_wait(bar_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const uint32_t parity = t & 1;

    // key states of the tile: 1 valid, 0 masked (-1e30), -1 past Tk
    if (warp == 0) {
      const float* mrow = kv_mask + static_cast<long long>(b) * tk;
      bool all_valid = true;
      for (int j = lane; j < BK; j += 32) {
        const int key = t * BK + j;
        const float st = key < tk ? (mrow[key] > 0.f ? 1.f : 0.f) : -1.f;
        key_state[j] = st;
        all_valid &= st > 0.f;
      }
      all_valid = __all_sync(0xffffffffu, all_valid);
      if (lane == 0) tile_valid[0] = all_valid;
    }

    // tile 0's K is split here, every later tile's during the previous
    // tile's P.V product
    if (t == 0) split_k(0);
    consumers_sync<NT>();

    // S = Q K^T over the head dim: D/8 k8 slices, two at a time, each as
    // Qlo.Khi + Qhi.Klo + Qhi.Khi
    float sc[BK / 2];
    uint32_t a_hi[2][2][4], a_lo[2][2][4];
    const uint32_t khi = base + C::OFF_KHI, klo = base + C::OFF_KLO;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const int set = c & 1;
      if (c >= 2) {
        wgmma_wait<1>();   // chunk c-2, the last reader of this set, is done
        fence_regs(a_hi[set]);
        fence_regs(a_lo[set]);
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) q_slice(2 * c + s, a_hi[set][s], a_lo[set][s]);
      fence_regs(a_hi[set]);
      fence_regs(a_lo[set]);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int kk = 2 * c + s;
        const int off = (kk / 4) * C::KV_PANEL + (kk % 4) * 32;
        const uint64_t bh = make_desc(khi + off, 16, 1024, 1);
        const uint64_t bl = make_desc(klo + off, 16, 1024, 1);
        wgmma_tf32(sc, a_lo[set][s], bh, kk > 0);
        wgmma_tf32(sc, a_hi[set][s], bl, 1);
        wgmma_tf32(sc, a_hi[set][s], bh, 1);
      }
      wgmma_commit();
    }
    // while S runs: V^T hi and lo from the raw tile. A warp takes 32 keys
    // (one per lane) by 4 columns; the lane's key goes to position
    // 8(k/8) + L of the 32-key panel, L = 0,4,1,5,2,6,3,7 for k%8 = 0..7
    mbar_wait(bar_v, parity);
    {
      const int lk = (lane / 8) * 8 + (lane % 2) * 4 + (lane % 8) / 2;
      // C::V_GROUP items a warp at a time, all loads issued first
      for (int n0 = 0; n0 < C::V_PER; n0 += C::V_GROUP) {
        float4 x[C::V_GROUP];
#pragma unroll
        for (int n = 0; n < C::V_GROUP; ++n) {
          const int item = warp + (n0 + n) * (NT / 32);
          x[n] = *reinterpret_cast<const float4*>(
              vraw + swz(32 * (item / (D / 4)) + lane, 4 * (item % (D / 4)),
                         C::KV_PANEL));
        }
#pragma unroll
        for (int n = 0; n < C::V_GROUP; ++n) {
          const int item = warp + (n0 + n) * (NT / 32);
          const int kb = item / (D / 4);
          const int col = 4 * (item % (D / 4));
          const float xs[4] = {x[n].x, x[n].y, x[n].z, x[n].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            uint32_t hi, lo;
            split_tf32(xs[e], hi, lo);
            const int at = swz(col + e, 32 * kb + lk, C::VT_PANEL);
            *reinterpret_cast<uint32_t*>(vthi + at) = hi;
            *reinterpret_cast<uint32_t*>(vtlo + at) = lo;
          }
        }
      }
    }
    fence_proxy_async();
    wgmma_wait_all();
    fence_regs(sc);

    // both warpgroups are done with K and the raw V: load the next tile's
    consumers_sync<NT>();
    if (tid == 0 && t + 1 < n_tiles) {
      load_k(t + 1);
      load_v(t + 1);
    }

    // scale into log2 units and mask; -1e30 and -inf after scaling
    if (tile_valid[0]) {
#pragma unroll
      for (int r = 0; r < BK / 2; ++r) sc[r] *= scale_log2;
    } else {
#pragma unroll
      for (int r = 0; r < BK / 2; ++r) {
        const float state = key_state[8 * (r / 4) + c2 + (r % 2)];
        sc[r] = state > 0.f ? sc[r] * scale_log2
                            : (state == 0.f ? kNeg : -INFINITY);
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
      split_tf32(p0, p_hi[j][0], p_lo[j][0]);
      split_tf32(p2, p_hi[j][1], p_lo[j][1]);
      split_tf32(p1, p_hi[j][2], p_lo[j][2]);
      split_tf32(p3, p_hi[j][3], p_lo[j][3]);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) l[half] = l[half] * alpha[half] + sum[half];
    // rescale the accumulator only where a row's max moved (warp-uniform)
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int r = 0; r < D / 2; ++r) o[r] *= alpha[(r / 2) % 2];
    }


    // O += P V over the tile's keys: BK/8 k8 slices, Plo.Vhi + Phi.Vlo +
    // Phi.Vhi; V^T is [d, keys], K-major
    const uint32_t vh = base + C::OFF_VTHI, vl = base + C::OFF_VTLO;
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
    if (t + 1 < n_tiles) split_k(t + 1);
    wgmma_wait_all();
    fence_regs(o);
  }

  // normalise, zero the q_mask rows, store fp32 pairs
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
  }
  float* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r0 + 8 * half;
    if (row >= tq) continue;
    const float inv = 1.f / fmaxf(l[half], 1e-30f);
    const bool zero =
        q_mask != nullptr && !(q_mask[static_cast<long long>(b) * tq + row] > 0.f);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + c2;
      if (col >= d) continue;
      const float x0 = zero ? 0.f : o[4 * j + 2 * half] * inv;
      const float x1 = zero ? 0.f : o[4 * j + 2 * half + 1] * inv;
      *reinterpret_cast<float2*>(ob + row * so.t + col) = make_float2(x0, x1);
    }
  }
}

// ---------------------------------------------------------------------------
// host side: launch (the tensor maps are made in tma.cuh)
// ---------------------------------------------------------------------------

template <int D>
cudaError_t set_smem_f32() {
  static std::atomic<uint64_t> done{0};
  return set_smem_once(attention_kernel_f32_sm90<D>, Cfg<D>::SMEM, done);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const float* kv_mask,
           const float* q_mask, void* out, int batch, int heads, int tq,
           int tk, int d, Strides sq, Strides sk, Strides sv, Strides so,
           float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap mq, mk, mv;
  Perm pq, pk, pv;
  int err = make_map(&mq, &pq, kF32, q, d, tq, heads, batch, sq, kPanel, C::ROWS, sw);
  if (err == 0)
    err = make_map(&mk, &pk, kF32, k, d, tk, heads, batch, sk, kPanel, C::BK, sw);
  if (err == 0)
    err = make_map(&mv, &pv, kF32, v, d, tk, heads, batch, sv, kPanel, C::BK, sw);
  if (err != 0) return err;
  const cudaError_t cerr = set_smem_f32<D>();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid((tq + C::ROWS - 1) / C::ROWS, heads, batch);
  attention_kernel_f32_sm90<D><<<grid, C::THREADS, C::SMEM, stream>>>(
      mq, mk, mv, pq, pk, pv, kv_mask, q_mask, static_cast<float*>(out), tq,
      tk, d, so, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 element strides, (batch, head, row) for q, k, v and out;
// d_head: a multiple of 4 up to 256, every stride a multiple of 4 and
// q, k, v 16-byte aligned (TMA's rules), out 8-byte aligned.
// kv_mask: float32 [batch, tk]; q_mask: float32 [batch, tq] or null.
// scale: the softmax scale, 1/sqrt(the caller's head dim).
// Returns a cudaError_t (0 on success).
extern "C" int asr2pass_attention_f32(const void* q, const void* k,
                                      const void* v, const void* kv_mask,
                                      const void* q_mask, void* out,
                                      int batch, int heads, int tq, int tk,
                                      int d_head, const long long* st,
                                      float scale, void* stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  const float* km = static_cast<const float*>(kv_mask);
  const float* qm = static_cast<const float*>(q_mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_head < 4 || d_head > 256 || d_head % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (d_head <= 32)
    return launch<32>(q, k, v, km, qm, out, batch, heads, tq, tk, d_head, sq, sk, sv, so, scale, s);
  if (d_head <= 64)
    return launch<64>(q, k, v, km, qm, out, batch, heads, tq, tk, d_head, sq, sk, sv, so, scale, s);
  if (d_head <= 128)
    return launch<128>(q, k, v, km, qm, out, batch, heads, tq, tk, d_head, sq, sk, sv, so, scale, s);
  return launch<256>(q, k, v, km, qm, out, batch, heads, tq, tk, d_head, sq, sk, sv, so, scale, s);
}

// Dynamic shared memory of one block for a head dim (0 if out of range).
extern "C" int asr2pass_attention_f32_smem(int d_head) {
  if (d_head < 1 || d_head > 256) return 0;
  if (d_head <= 32) return Cfg<32>::SMEM;
  if (d_head <= 64) return Cfg<64>::SMEM;
  if (d_head <= 128) return Cfg<128>::SMEM;
  return Cfg<256>::SMEM;
}
