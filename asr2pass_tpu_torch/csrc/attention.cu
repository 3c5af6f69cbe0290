// float32 masked multi-head attention for Hopper (sm_90a), bound to Python
// with a plain C interface (ctypes) by asr2pass_tpu_torch/ops/attention.py.
// bfloat16 inputs go to the tensor-core kernel of csrc/attention_sm90.cu.
//
// Replaces, for float32 inputs, the three Pallas TPU kernels of
// asr2pass_tpu/ops/attention.py:
//   _mhss_kernel (mh_flash_attention, :129)  unsplit [B,T,D] / [B,T,2D]
//                                            projections, heads in d_k
//                                            column blocks, merged output
//   _ss_kernel   (_attention_ss, :261)       split-head [B,H,T,d], Tq != Tk
//   _kernel      (_attention_flash, :314)    split-head online softmax
// All three compute, per (batch, head, query row i):
//   s_j = (q_i . k_j) * scale,       j < Tk
//   s_j = -1e30 where kv_mask[j] <= 0 (finite, never -inf)
//   out_i = sum_j exp(s_j - m) v_j / max(sum_j exp(s_j - m), 1e-30)
// and optionally zero the rows whose q_mask is <= 0. One kernel serves all
// three because Q, K, V and the output are read and written through
// (batch, head, row) strides with a unit column stride: the unsplit layout
// is head stride d_k and row stride D (or 2D for the fused K/V block), the
// split layout head stride T*d and row stride d. No head split, merge or
// copy is made.
//
// What bounds it on this card: at the main-path shapes (B=16, T=1024,
// D=512) the work is 4*B*T^2*D = 34 GFLOP against 67 MB of input and
// output, so the exact operation is compute-bound (bf16 tensor cores: about
// 35 us; fp32 without TF32: about 0.5 ms). The TPU kernels held a whole
// [Tk, 2D] K/V block in VMEM; that does not fit in 227 KB of shared memory.
// This design streams 32-key tiles of K and V through shared memory with an
// online softmax (fp32 running max m, sum l and accumulator), so the
// [B,H,Tq,Tk] score tensor never reaches device memory and shared memory
// stays at 75 KB per block (three blocks per SM at d=128). The products run
// on the CUDA cores in true fp32 (no TF32): the recognizer's card-vs-CPU
// check needs fp32 products. Register tiling or 3xTF32 on the tensor cores
// is later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;     // query rows per block
constexpr int kBlockK = 32;     // keys per shared-memory tile
constexpr int kLanes = 16;      // threads sharing one group of query rows
constexpr int kThreads = 256;   // 16 row groups x 16 lanes
constexpr int kRows = kBlockQ / (kThreads / kLanes);  // query rows per thread
constexpr int kCols = kBlockK / kLanes;               // scores per row per thread
constexpr float kNeg = -1e30f;  // masked score (attention.py:34)

struct Strides {
  long long b, h, t;  // elements between batches, heads and rows
};

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

template <int D>
constexpr size_t smem_floats() {
  return kBlockQ * (D + 1)      // Q tile, padded rows
         + kBlockK * (D + 1)    // K tile, padded rows
         + kBlockK * D          // V tile
         + kBlockQ * (kBlockK + 1)  // probabilities, padded rows
         + kBlockK;             // key state of the tile
}

// grid: (ceil(Tq / 64), H, B); block: 256 threads. Thread (ty, tx) owns
// query rows ty*4 .. ty*4+3 of the tile, score columns tx + 16*j and output
// columns tx + 16*c. The 16 lanes of a row group are consecutive lanes of
// one warp, so row maxima and sums reduce with warp shuffles.
// D is the instantiated head dim and d <= D the real one: columns d..D-1
// of the Q, K and V tiles hold zeros, which add nothing to the scores, and
// are not stored, so every head dim up to 256 runs on one of four
// instantiations (32, 64, 128, 256).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ kv_mask,
                 const float* __restrict__ q_mask, T* __restrict__ out,
                 int tq, int tk, int d, Strides sq, Strides sk, Strides sv,
                 Strides so, float scale) {
  static_assert(D % kLanes == 0, "head dim must be a multiple of 16");
  constexpr int QS = D + 1;
  constexpr int PS = kBlockK + 1;
  constexpr int kAcc = D / kLanes;  // output columns per thread

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockQ * QS;
  float* vs = ks + kBlockK * QS;
  float* ps = vs + kBlockK * D;
  float* key_state = ps + kBlockQ * PS;  // 1 valid, 0 masked, -1 past Tk

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int tid = threadIdx.x;
  const int ty = tid / kLanes;
  const int tx = tid % kLanes;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const float* mb = kv_mask + static_cast<long long>(b) * tk;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = q0 + r;
    qs[r * QS + c] = row < tq && c < d ? to_float(qb[row * sq.t + c]) : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kAcc];
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    m[ii] = kNeg;
    l[ii] = 0.f;
#pragma unroll
    for (int c = 0; c < kAcc; ++c) acc[ii][c] = 0.f;
  }

  for (int k0 = 0; k0 < tk; k0 += kBlockK) {
    __syncthreads();  // the previous tile is no longer read
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int key = k0 + r;
      float kval = 0.f, vval = 0.f;
      if (key < tk && c < d) {
        kval = to_float(kb[key * sk.t + c]);
        vval = to_float(vb[key * sv.t + c]);
      }
      ks[r * QS + c] = kval;
      vs[r * D + c] = vval;
    }
    if (tid < kBlockK) {
      const int key = k0 + tid;
      key_state[tid] = key < tk ? (mb[key] > 0.f ? 1.f : 0.f) : -1.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int ii = 0; ii < kRows; ++ii)
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) s[ii][jj] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii) qv[ii] = qs[(ty * kRows + ii) * QS + c];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) kv[jj] = ks[(tx + kLanes * jj) * QS + c];
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii)
#pragma unroll
        for (int jj = 0; jj < kCols; ++jj) s[ii][jj] = fmaf(qv[ii], kv[jj], s[ii][jj]);
    }

#pragma unroll
    for (int ii = 0; ii < kRows; ++ii) {
      float row_max = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        const float state = key_state[tx + kLanes * jj];
        // keys past Tk (the ragged tile edge) are excluded outright; masked
        // keys score the finite -1e30, so a row with no valid key averages
        // V instead of producing NaN
        const float x = state > 0.f ? s[ii][jj] * scale
                        : (state == 0.f ? kNeg : -INFINITY);
        s[ii][jj] = x;
        row_max = fmaxf(row_max, x);
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off /= 2)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[ii], row_max);
      const float alpha = expf(m[ii] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        const float p = expf(s[ii][jj] - m_new);
        ps[(ty * kRows + ii) * PS + tx + kLanes * jj] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = kLanes / 2; off > 0; off /= 2)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[ii] = l[ii] * alpha + row_sum;
      m[ii] = m_new;
#pragma unroll
      for (int c = 0; c < kAcc; ++c) acc[ii][c] *= alpha;
    }
    __syncwarp();  // P rows of a row group are written and read by one warp

#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      float pv[kRows];
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii) pv[ii] = ps[(ty * kRows + ii) * PS + j];
#pragma unroll
      for (int c = 0; c < kAcc; ++c) {
        const float vval = vs[j * D + tx + kLanes * c];
#pragma unroll
        for (int ii = 0; ii < kRows; ++ii) acc[ii][c] = fmaf(pv[ii], vval, acc[ii][c]);
      }
    }
  }

  T* ob = out + b * so.b + h * so.h;
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    const int row = q0 + ty * kRows + ii;
    if (row >= tq) continue;
    const float denom = fmaxf(l[ii], 1e-30f);
    const bool zero =
        q_mask != nullptr && !(q_mask[static_cast<long long>(b) * tq + row] > 0.f);
#pragma unroll
    for (int c = 0; c < kAcc; ++c) {
      const int col = tx + kLanes * c;
      if (col < d) ob[row * so.t + col] = from_float<T>(zero ? 0.f : acc[ii][c] / denom);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* kv_mask,
           const void* q_mask, void* out, int batch, int heads, int tq,
           int tk, int d, Strides sq, Strides sk, Strides sv, Strides so,
           float scale, void* stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((tq + kBlockQ - 1) / kBlockQ, heads, batch);
  attention_kernel<T, D><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(kv_mask),
      static_cast<const float*>(q_mask), static_cast<T*>(out), tq, tk, d, sq,
      sk, sv, so, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* kv_mask,
             const void* q_mask, void* out, int batch, int heads, int tq,
             int tk, int d_head, const long long* st, float scale,
             void* stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]};
  // the smallest instantiation that holds d_head
  if (d_head < 1 || d_head > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (d_head <= 32)
    return launch<T, 32>(q, k, v, kv_mask, q_mask, out, batch, heads, tq, tk, d_head, sq, sk, sv, so, scale, stream);
  if (d_head <= 64)
    return launch<T, 64>(q, k, v, kv_mask, q_mask, out, batch, heads, tq, tk, d_head, sq, sk, sv, so, scale, stream);
  if (d_head <= 128)
    return launch<T, 128>(q, k, v, kv_mask, q_mask, out, batch, heads, tq, tk, d_head, sq, sk, sv, so, scale, stream);
  return launch<T, 256>(q, k, v, kv_mask, q_mask, out, batch, heads, tq, tk, d_head, sq, sk, sv, so, scale, stream);
}

}  // namespace

// strides: 12 element strides, (batch, head, row) for q, k, v and out.
// kv_mask: float32 [batch, tk]; q_mask: float32 [batch, tq] or null.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int asr2pass_attention_f32(const void* q, const void* k,
                                      const void* v, const void* kv_mask,
                                      const void* q_mask, void* out,
                                      int batch, int heads, int tq, int tk,
                                      int d_head, const long long* strides,
                                      float scale, void* stream) {
  return dispatch<float>(q, k, v, kv_mask, q_mask, out, batch, heads, tq, tk,
                         d_head, strides, scale, stream);
}

// Dynamic shared memory of one block for a head dim (0 if out of range).
extern "C" int asr2pass_attention_f32_smem(int d_head) {
  if (d_head < 1 || d_head > 256) return 0;
  if (d_head <= 32) return static_cast<int>(smem_floats<32>() * sizeof(float));
  if (d_head <= 64) return static_cast<int>(smem_floats<64>() * sizeof(float));
  if (d_head <= 128) return static_cast<int>(smem_floats<128>() * sizeof(float));
  return static_cast<int>(smem_floats<256>() * sizeof(float));
}
