// What the attention kernels of this directory share (attention_sm90.cu
// for bf16, attention_f32_sm90.cu for fp32): the packed argument block of
// a launch (PlanSlot) and the device switch around it, mbarriers, TMA
// tensor-map loads (bf16) and plain bulk copies (fp32), wgmma descriptors
// and fences, and the bf16 kernel's tensor maps with their cache.
// Header-only: each kernel source includes it, and each gets its own copy
// of the map cache.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace {

struct Strides {
  long long b, h, t;  // elements between batches, heads and rows
};

// The packed argument block of one launch: int64 slots that
// ops/attention.py fills once per shape, strides and schedule (in the
// order of its PLAN_SLOTS), so that a call hands the C side one pointer
// beside its data pointers. Both kernels' entry points read it.
enum PlanSlot : int {
  kSlotBatch = 0,
  kSlotHeads,
  kSlotTq,
  kSlotTk,
  kSlotD,          // the head dim the kernel reads (padded to 16 bytes)
  kSlotDScale,     // the caller's head dim: scale = 1 / sqrt(it)
  kSlotDevice,     // CUDA device index of the operands
  kSlotSplits,     // fp32: key splits of the schedule (1: none)
  kSlotTiles,      // fp32: key tiles of Tk, ceil(Tk / the tile's keys)
  kSlotStrides,    // 12 slots: (batch, head, row) of q, k, v and out
  kSlotOffTiles = kSlotStrides + 12,  // fp32 scratch byte offsets
  kSlotOffImages,
  kSlotOffPartO,
  kSlotOffPartMl,
  kSlotCount
};

inline Strides plan_strides(const long long* plan, int which) {
  const long long* s = plan + kSlotStrides + 3 * which;
  return Strides{s[0], s[1], s[2]};
}

// Runs the launches of one call on the plan's device: switches the
// calling thread's current device only where it differs, and back.
struct DeviceGuard {
  int prev = -1;
  explicit DeviceGuard(int dev) {
    int cur = 0;
    if (cudaGetDevice(&cur) == cudaSuccess && cur != dev) {
      prev = cur;
      cudaSetDevice(dev);
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// where the row, head and batch coordinates sit in a tensor map's dims
struct Perm {
  int row, head, batch;
};

// ---------------------------------------------------------------------------
// device side: PTX of mbarriers, TMA loads and wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one TMA tile load of a 4-D tensor map into shared memory, completion
// reported to `bar` as transaction bytes
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head, int batch, Perm p) {
  const int c1 = p.row == 1 ? row : (p.head == 1 ? head : batch);
  const int c2 = p.row == 2 ? row : (p.head == 2 ? head : batch);
  const int c3 = p.row == 3 ? row : (p.head == 3 ? head : batch);
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// one bulk copy of `bytes` (a multiple of 16) contiguous bytes from
// device memory into shared memory, completion reported to `bar` as
// transaction bytes; no tensor map
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout in bits 62-63
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }

// keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// ---------------------------------------------------------------------------
// host side: tensor maps, cached
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

inline int element_bytes(CUtensorMapDataType type) {
  return type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
}

// A 4-D map of one operand of element type `type`: column (extent d, unit
// stride), then row, head and batch sorted by stride. TMA takes a
// 16-byte-aligned base and strides in multiples of 16 bytes, so d and
// every stride must be multiples of 16 / element_bytes(type) elements.
// The box is `panel` columns by `box_rows` rows of one head of one batch;
// out-of-range elements are filled with zeros.
inline int encode_map(CUtensorMap* map, Perm* perm, CUtensorMapDataType type,
                      const void* ptr, int d, int rows, int heads, int batch,
                      Strides st, int panel, int box_rows,
                      CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int es = element_bytes(type);
  const int per = 16 / es;
  struct Dim {
    long long extent, stride;
    int box, which;
  } dims[3] = {{rows, st.t, box_rows, 0}, {heads, st.h, 1, 1},
               {batch, st.b, 1, 2}};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && dims[j].stride < dims[j - 1].stride; --j) {
      Dim tmp = dims[j];
      dims[j] = dims[j - 1];
      dims[j - 1] = tmp;
    }
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || d % per != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cuuint64_t gdim[4] = {static_cast<cuuint64_t>(d), 0, 0, 0};
  cuuint64_t gstride[3];
  cuuint32_t box[4] = {static_cast<cuuint32_t>(panel), 0, 0, 0};
  cuuint32_t estride[4] = {1, 1, 1, 1};
  int pos[3];
  for (int i = 0; i < 3; ++i) {
    if (dims[i].stride <= 0 || dims[i].stride % per != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    gdim[i + 1] = static_cast<cuuint64_t>(dims[i].extent);
    gstride[i] = static_cast<cuuint64_t>(dims[i].stride) * es;
    box[i + 1] = static_cast<cuuint32_t>(dims[i].box);
    pos[dims[i].which] = i + 1;
  }
  *perm = Perm{pos[0], pos[1], pos[2]};
  CUresult res = encode(map, type, 4, const_cast<void*>(ptr), gdim, gstride,
                        box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The parameters a tensor map is made from: equal keys give equal maps.
struct MapKey {
  const void* ptr;
  long long type, d, rows, heads, batch, sb, sh, st, panel, box_rows, swizzle;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && type == o.type && d == o.d && rows == o.rows &&
           heads == o.heads && batch == o.batch && sb == o.sb && sh == o.sh &&
           st == o.st && panel == o.panel && box_rows == o.box_rows &&
           swizzle == o.swizzle;
  }
};

// Encoded maps by key, direct-mapped: a model's layers reuse the same
// buffers, shapes and strides, so most launches encode no map (an encode
// is host time on every call otherwise).
constexpr int kMapCache = 256;
struct MapSlot {
  bool used = false;
  MapKey key;
  CUtensorMap map;
  Perm perm;
};
MapSlot map_cache[kMapCache];
std::mutex map_cache_mutex;

// encode_map through the cache
inline int make_map(CUtensorMap* map, Perm* perm, CUtensorMapDataType type,
                    const void* ptr, int d, int rows, int heads, int batch,
                    Strides st, int panel, int box_rows,
                    CUtensorMapSwizzle swizzle) {
  const MapKey key{ptr,  static_cast<long long>(type), d, rows, heads,
                   batch, st.b, st.h, st.t, panel, box_rows,
                   static_cast<long long>(swizzle)};
  uint64_t hash = reinterpret_cast<uintptr_t>(ptr) >> 4;
  for (long long x : {key.type, key.d, key.rows, key.heads, key.batch, key.sb,
                      key.sh, key.st, key.panel, key.box_rows})
    hash = (hash ^ static_cast<uint64_t>(x)) * 0x100000001b3ull;
  MapSlot& slot = map_cache[(hash ^ (hash >> 29)) % kMapCache];
  std::lock_guard<std::mutex> lock(map_cache_mutex);
  if (slot.used && slot.key == key) {
    *map = slot.map;
    *perm = slot.perm;
    return 0;
  }
  const int err = encode_map(map, perm, type, ptr, d, rows, heads, batch, st,
                             panel, box_rows, swizzle);
  if (err == 0) {
    slot.used = true;
    slot.key = key;
    slot.map = *map;
    slot.perm = *perm;
  }
  return err;
}

// Opt a kernel in to `bytes` of dynamic shared memory, once per device.
// `done` is the caller's own flag word (one bit per device).
template <typename Kernel>
cudaError_t set_smem_once(Kernel kernel, int bytes,
                          std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ull << (dev % 64);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace
