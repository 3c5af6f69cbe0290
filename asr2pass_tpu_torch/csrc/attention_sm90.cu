// bf16 masked multi-head attention for Hopper (sm_90a): tensor-core
// (wgmma) products fed by TMA. Bound to Python with a plain C interface
// (ctypes) by asr2pass_tpu_torch/ops/attention.py, which also builds it.
//
// Replaces, for bfloat16 inputs, the three Pallas TPU kernels of the JAX
// package's ops/attention.py (float32 inputs go to the 3xTF32 kernel
// of csrc/attention_f32_sm90.cu; both include csrc/tma.cuh):
//   _mhss_kernel (mh_flash_attention, :129)  unsplit [B,T,D] / [B,T,2D]
//                                            projections, heads in d_k
//                                            column blocks, merged output
//   _ss_kernel   (_attention_ss, :261)       split-head [B,H,T,d], Tq != Tk
//   _kernel      (_attention_flash, :314)    split-head online softmax
// All three compute, per (batch, head, query row i):
//   s_j = (q_i . k_j) / sqrt(d),      j < Tk (keys past Tk: -inf)
//   s_j = -1e30 where kv_mask[j] <= 0 (finite, so a row with no valid key
//         averages V over the Tk real keys instead of producing NaN)
//   out_i = sum_j p_j v_j / max(sum_j p_j, 1e-30),  p_j = exp(s_j - m)
// and optionally write the rows whose q_mask is <= 0 as exact zeros. As
// in the TPU kernels (attention.py:67,96,184) the statistics m, l and the
// accumulator are fp32 and P is rounded to bf16 before the P.V product.
//
// What bounds it on this card: at the main-path shapes (B=16, T=1024,
// D=512, 4 heads) the work is 4*B*T^2*D = 34 GFLOP against 67 MB of
// input and output: 35 us on the bf16 tensor cores, 20 us at 3.35 TB/s,
// so operations bound it. The design therefore keeps both products on
// the tensor cores and the [Tq,Tk] scores out of device memory:
//   - a block owns 128 query rows of one (batch, head); two consumer
//     warpgroups take 64 rows each (wgmma's M), one producer warp issues
//     TMA loads: the Q tile once, then K and V tiles (128 keys for d <=
//     128, 64 for d = 256) into a 2-stage shared-memory ring guarded by
//     mbarriers (full: TMA bytes landed; empty: both warpgroups done);
//   - S = Q.K^T is a wgmma with both operands in shared memory, K-major,
//     swizzled, fp32 accumulators; the online softmax runs on that
//     register fragment (exp2 with 1/sqrt(d)*log2(e) folded into the
//     scale), and the fragment is repacked in registers as the bf16 A
//     operand of O += P.V, a wgmma whose B (V, [keys, d], d contiguous)
//     is read MN-major from shared memory. P never leaves registers;
//   - every operand is read through its own 4-D TMA tensor map (column,
//     and row/head/batch with the caller's strides, sorted by stride), so
//     the unsplit layout and split-head views of a fused projection need
//     no copy. The column extent is the real d: TMA's zero fill, not the
//     next head's columns, pads an instantiation wider than d, and the
//     ragged row edges (query rows past Tq, keys past Tk) come in as
//     zeros; keys past Tk are excluded explicitly, rows past Tq are not
//     stored.
// The head dim is instantiated at 32, 64, 128 and 256 columns; any
// d <= 256 that is a multiple of 8 (TMA's 16-byte rule; the wrapper pads
// other head dims) runs on the next one up. Grid: (ceil(Tq/128), H, B).
//
// Each warpgroup waits for its S product before the softmax and for its
// P.V product before the next tile; the two warpgroups of a block, and
// the blocks' own phases, keep the tensor cores fed meanwhile. A variant
// that overlapped each tile's softmax with the previous tile's P.V
// product inside one warpgroup (a third, register-donating warpgroup via
// setmaxnreg) timed slower on the H100 at every main-path shape: ptxas
// serialised its wgmmas (C7513), so it was not kept (PERF.md).
#include <cuda_bf16.h>
#include <math.h>

#include "tma.cuh"

namespace {

constexpr int kRows = 128;                 // query rows per block
constexpr int kConsumers = 2;              // warpgroups of 64 rows
constexpr int kThreads = 128 * kConsumers + 32;  // + one producer warp
constexpr int kStages = 2;                 // K/V shared-memory ring
constexpr float kNeg = -1e30f;             // masked score (attention.py:34)
constexpr float kLog2e = 1.4426950408889634f;
constexpr CUtensorMapDataType kBf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

template <int D>
struct Cfg {
  static constexpr int BK = D <= 128 ? 128 : 64;   // keys per tile
  static constexpr int PW = D < 64 ? D : 64;       // columns per swizzle panel
  static constexpr int RB = PW * 2;                // bytes per panel row
  static constexpr int NP = D / PW;                // panels per tile
  static constexpr int STEPS = PW / 16;            // k16 steps per panel
  static constexpr uint64_t SWIZZLE = RB == 128 ? 1 : 2;  // wgmma layout code
  static constexpr int Q_PANEL = kRows * RB;
  static constexpr int KV_PANEL = BK * RB;
  static constexpr int Q_BYTES = kRows * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + kStages * KV_BYTES;
  static constexpr int OFF_STATE = OFF_V + kStages * KV_BYTES;  // float [2][BK]
  static constexpr int OFF_FLAG = OFF_STATE + kStages * BK * 4;  // int [2]
  static constexpr int OFF_BAR = OFF_FLAG + 16;                  // 7 mbarriers
  static constexpr int SMEM = OFF_BAR + 7 * 8 + 1024;  // + alignment slack
  static_assert(D % PW == 0 && PW % 16 == 0, "head dim");
  static_assert(OFF_K % 1024 == 0 && KV_BYTES % 1024 == 0, "alignment");
};

// wgmma m64nNk16, bf16 in, fp32 accumulate. _ss: A and B from shared
// memory, both K-major; scale_d = 0 overwrites d. _rs: A from registers
// (4 x bf16x2 per thread), B from shared memory MN-major (transposed),
// accumulating into d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
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
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int R>
__device__ __forceinline__ void wgmma_ss(float (&d)[R], uint64_t a, uint64_t b,
                                         int scale_d) {
  if constexpr (R == 32) wgmma_ss_n64(d, a, b, scale_d);
  else wgmma_ss_n128(d, a, b, scale_d);
}

template <int R>
__device__ __forceinline__ void wgmma_rs(float (&d)[R], const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (R == 16) wgmma_rs_n32(d, a, b);
  else if constexpr (R == 32) wgmma_rs_n64(d, a, b);
  else if constexpr (R == 64) wgmma_rs_n128(d, a, b);
  else wgmma_rs_n256(d, a, b);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

// Fragment layout of a wgmma accumulator (m64nN, fp32): thread t of a
// warpgroup holds N/2 values; value r sits at row 16*(t/32) + (t%32)/4 +
// 8*((r/2)%2) and column 8*(r/4) + 2*(t%4) + r%2. The A operand of a k16
// step taken from registers has the same layout as values 8k..8k+7 of
// that fragment, which is what lets S become P without shared memory.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
attention_kernel_sm90(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v, Perm pq,
                      Perm pk, Perm pv, const float* __restrict__ kv_mask,
                      const float* __restrict__ q_mask,
                      __nv_bfloat16* __restrict__ out, int tq, int tk, int d,
                      Strides so, float scale_log2) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(smem);
  float* key_state = reinterpret_cast<float*>(smem + C::OFF_STATE);
  int* tile_valid = reinterpret_cast<int*>(smem + C::OFF_FLAG);
  const uint32_t bar = base + C::OFF_BAR;
  const uint32_t bar_q = bar;
  auto bar_k = [&](int s) { return bar + 8 * (1 + s); };
  auto bar_v = [&](int s) { return bar + 8 * (3 + s); };
  auto bar_empty = [&](int s) { return bar + 8 * (5 + s); };

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_tiles = (tk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k(s), 32);               // 32 producer lanes (key states)
      mbar_init(bar_v(s), 1);
      mbar_init(bar_empty(s), 4 * kConsumers);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {
    // ---- producer warp: TMA loads and the key states of each tile ----
    if (lane == 0) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int p = 0; p < C::NP; ++p)
        tma_load(base + p * C::Q_PANEL, &map_q, bar_q, p * C::PW, q0, h, b, pq);
    }
    const float* mrow = kv_mask + static_cast<long long>(b) * tk;
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      if (t >= kStages) mbar_wait(bar_empty(s), ((t / kStages) + 1) & 1);
      bool all_valid = true;
      for (int j = lane; j < BK; j += 32) {
        const int key = t * BK + j;
        // 1 valid, 0 masked (-1e30), -1 past Tk (excluded)
        const float st = key < tk ? (mrow[key] > 0.f ? 1.f : 0.f) : -1.f;
        key_state[s * BK + j] = st;
        all_valid &= st > 0.f;
      }
      all_valid = __all_sync(0xffffffffu, all_valid);
      if (lane == 0) {
        tile_valid[s] = all_valid;
        const uint32_t ks = base + C::OFF_K + s * C::KV_BYTES;
        const uint32_t vs = base + C::OFF_V + s * C::KV_BYTES;
        mbar_expect_tx(bar_k(s), C::KV_BYTES);
        for (int p = 0; p < C::NP; ++p)
          tma_load(ks + p * C::KV_PANEL, &map_k, bar_k(s), p * C::PW, t * BK, h,
                   b, pk);
        mbar_expect_tx(bar_v(s), C::KV_BYTES);
        for (int p = 0; p < C::NP; ++p)
          tma_load(vs + p * C::KV_PANEL, &map_v, bar_v(s), p * C::PW, t * BK, h,
                   b, pv);
      } else {
        mbar_arrive(bar_k(s));
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----
  const int wg = warp / 4;
  const int g = lane / 4;       // row within the warp's 8-row group
  const int c2 = 2 * (lane % 4);  // first of the thread's column pair
  float o[D / 2];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) o[r] = 0.f;
  float m[2] = {kNeg, kNeg};    // running max of rows g and g+8 (log2 units)
  float l[2] = {0.f, 0.f};      // this thread's share of the row sums

  const uint32_t q_base = base + wg * 64 * C::RB;
  mbar_wait(bar_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    const uint32_t ks = base + C::OFF_K + s * C::KV_BYTES;
    const uint32_t vs = base + C::OFF_V + s * C::KV_BYTES;

    // S = Q K^T over the head dim, D/16 steps of k16
    float sc[BK / 2];
    mbar_wait(bar_k(s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / C::STEPS, off = (kk % C::STEPS) * 32;
      const uint64_t da = make_desc(q_base + p * C::Q_PANEL + off, 16,
                                    8 * C::RB, C::SWIZZLE);
      const uint64_t db = make_desc(ks + p * C::KV_PANEL + off, 16,
                                    8 * C::RB, C::SWIZZLE);
      wgmma_ss(sc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scale into log2 units and mask; -1e30 and -inf after scaling
    const float* st = key_state + s * BK;
    if (tile_valid[s]) {
#pragma unroll
      for (int r = 0; r < BK / 2; ++r) sc[r] *= scale_log2;
    } else {
#pragma unroll
      for (int r = 0; r < BK / 2; ++r) {
        const float state = st[8 * (r / 4) + c2 + (r % 2)];
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
    float sum[2] = {0.f, 0.f};
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int r = 0; r < BK / 2; r += 2) {
      const int half = (r / 2) % 2;
      const float p0 = exp2f(sc[r] - mx[half]);
      const float p1 = exp2f(sc[r + 1] - mx[half]);
      sum[half] += p0 + p1;
      pa[r / 8][(r % 8) / 2] = pack_bf16(p0, p1);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) l[half] = l[half] * alpha[half] + sum[half];
    // rescale the accumulator only where a row's max moved (warp-uniform)
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int r = 0; r < D / 2; ++r) o[r] *= alpha[(r / 2) % 2];
    }

    // O += P V over the tile's keys, BK/16 steps of k16; V is [keys, d]
    // with d contiguous: MN-major B, panels LBO apart, 8-key groups SBO
    mbar_wait(bar_v(s), parity);
    fence_regs(o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = make_desc(vs + kk * 16 * C::RB, C::KV_PANEL,
                                    8 * C::RB, C::SWIZZLE);
      wgmma_rs(o, pa[kk], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty(s));
  }

  // normalise, round once, zero the q_mask rows, store bf16 pairs
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
  }
  __nv_bfloat16* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + wg * 64 + (warp % 4) * 16 + g + 8 * half;
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
      *reinterpret_cast<__nv_bfloat162*>(ob + row * so.t + col) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
}

// ---------------------------------------------------------------------------
// host side: launch (the tensor maps are made in tma.cuh)
// ---------------------------------------------------------------------------

template <int D>
cudaError_t set_smem_bf16() {
  static std::atomic<uint64_t> done{0};
  return set_smem_once(attention_kernel_sm90<D>, Cfg<D>::SMEM, done);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const float* kv_mask,
           const float* q_mask, void* out, int batch, int heads, int tq,
           int tk, int d, Strides sq, Strides sk, Strides sv, Strides so,
           float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  const CUtensorMapSwizzle swizzle =
      C::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap mq, mk, mv;
  Perm pq, pk, pv;
  int err = make_map(&mq, &pq, kBf16, q, d, tq, heads, batch, sq, C::PW, kRows, swizzle);
  if (err == 0)
    err = make_map(&mk, &pk, kBf16, k, d, tk, heads, batch, sk, C::PW, C::BK, swizzle);
  if (err == 0)
    err = make_map(&mv, &pv, kBf16, v, d, tk, heads, batch, sv, C::PW, C::BK, swizzle);
  if (err != 0) return err;
  const cudaError_t cerr = set_smem_bf16<D>();
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const dim3 grid((tq + kRows - 1) / kRows, heads, batch);
  attention_kernel_sm90<D><<<grid, kThreads, C::SMEM, stream>>>(
      mq, mk, mv, pq, pk, pv, kv_mask, q_mask,
      static_cast<__nv_bfloat16*>(out), tq, tk, d, so, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Same C signature as asr2pass_attention_f32 (csrc/attention_f32_sm90.cu).
// plan: the packed block (tma.cuh PlanSlot) that ops/attention.py writes
// once per shape: strides of q, k, v and out as (batch, head, row)
// element strides (multiples of 8; q, k, v 16-byte aligned: TMA's rules;
// out 4-byte aligned), the head dim (a multiple of 8 up to 256), the
// caller's head dim for the scale 1/sqrt(it), the device. kv_mask:
// float32 [batch, tk]; q_mask: float32 [batch, tq] or null. scratch: not
// used (null). Returns a cudaError_t (0 on success).
extern "C" int asr2pass_attention_bf16(const long long* plan, const void* q,
                                       const void* k, const void* v,
                                       const void* kv_mask, const void* q_mask,
                                       void* out, void* scratch, void* stream) {
  (void)scratch;
  const int batch = static_cast<int>(plan[kSlotBatch]);
  const int heads = static_cast<int>(plan[kSlotHeads]);
  const int tq = static_cast<int>(plan[kSlotTq]);
  const int tk = static_cast<int>(plan[kSlotTk]);
  const int d_head = static_cast<int>(plan[kSlotD]);
  const Strides sq = plan_strides(plan, 0), sk = plan_strides(plan, 1),
                sv = plan_strides(plan, 2), so = plan_strides(plan, 3);
  const float scale =
      static_cast<float>(1.0 / sqrt(static_cast<double>(plan[kSlotDScale])));
  const float* km = static_cast<const float*>(kv_mask);
  const float* qm = static_cast<const float*>(q_mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_head < 8 || d_head > 256 || d_head % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(static_cast<int>(plan[kSlotDevice]));
  if (d_head <= 32)
    return launch<32>(q, k, v, km, qm, out, batch, heads, tq, tk, d_head, sq, sk, sv, so, scale, s);
  if (d_head <= 64)
    return launch<64>(q, k, v, km, qm, out, batch, heads, tq, tk, d_head, sq, sk, sv, so, scale, s);
  if (d_head <= 128)
    return launch<128>(q, k, v, km, qm, out, batch, heads, tq, tk, d_head, sq, sk, sv, so, scale, s);
  return launch<256>(q, k, v, km, qm, out, batch, heads, tq, tk, d_head, sq, sk, sv, so, scale, s);
}

// Dynamic shared memory of one block for a head dim (0 if out of range).
extern "C" int asr2pass_attention_bf16_smem(int d_head) {
  if (d_head < 1 || d_head > 256) return 0;
  if (d_head <= 32) return Cfg<32>::SMEM;
  if (d_head <= 64) return Cfg<64>::SMEM;
  if (d_head <= 128) return Cfg<128>::SMEM;
  return Cfg<256>::SMEM;
}
