// Masked segment-sum for Hopper (sm_90a):
//   out[C, K] = sum over rows r with 0 <= ids[r] < C of
//               onehot(ids[r]) * where(valid, values[r, :], 0)
//
// Replaces the JAX package's Pallas TPU kernel tidb_tpu/ops/pallas_agg.py
// (_kernel, _kernel_masked, segment_sum_pallas: lines 65-155). There the
// sum is a one-hot [C, T] x [T, K] matmul per 512-row tile on the MXU,
// accumulated in a VMEM-resident [C, K] block across a sequential grid. On
// this card blocks run in parallel and in no order, so the accumulator
// becomes a per-block table in shared memory, merged into the output with
// global atomics; and the one-hot product becomes one atomic add per
// (row, lane), which needs no matmul unit and stays exact for int64.
//
// Bound: the kernel must read each input once, n * (4 + K * sizeof(T) +
// mask bytes) bytes (ids, values, the row or lane mask) and write C * K *
// sizeof(T); it does one add per (row, lane). At Q1's shape (2^18 rows x
// 12 int64 lanes, row mask) that is about 26 MB, so it is bound by device
// memory bandwidth (about 8 us at 3.35 TB/s), not by operations. The
// design reads each row's ids and values once per lane tile (once when all
// K lanes fit one table), keeps every add in shared memory, and sends to
// device memory only the non-zero entries of each block's table.
//
// Layout: values [n, K] row-major, ids [n] int32, valid [n] (mask_mode 1)
// or [n, K] (mask_mode 2) bytes, out [C, K] zeroed by the caller. The grid
// is (row blocks x lane tiles); a lane tile holds as many lanes Kt as let
// a [C, Kt] table fit in the block's opt-in shared memory (227 KB). Ids
// outside [0, C) are dropped (jax.ops.segment_sum's semantics). A dead
// lane is skipped by a select, never by a multiply, so a NaN under a dead
// mask never reaches the sum. int64 adds go through the 64-bit unsigned
// atomicAdd: two's-complement wrap keeps them exact, and no value ever
// goes through float. When not even one lane's table fits, the blocks add
// straight into device memory.
//
// Known weakness, the first suspect for its time: TPC-H Q1 has six live
// groups (3 return flags x 2 line statuses), so every thread of a block
// adds into the same few shared-memory words and the atomics serialise.
// Warp-level pre-aggregation, or a tensor-core one-hot product, is the
// next step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

template <typename T>
__device__ __forceinline__ void add_to(T* p, T v);

template <>
__device__ __forceinline__ void add_to<float>(float* p, float v) {
  atomicAdd(p, v);
}

template <>
__device__ __forceinline__ void add_to<double>(double* p, double v) {
  atomicAdd(p, v);
}

template <>
__device__ __forceinline__ void add_to<long long>(long long* p, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p),
            static_cast<unsigned long long>(v));
}

// MASK: 0 = no mask, 1 = one flag per row, 2 = one flag per (row, lane).
// SHARED: accumulate in a [C, Kt] shared-memory table, else in `out`.
template <typename T, int MASK, bool SHARED>
__global__ void __launch_bounds__(kThreads)
segsum_kernel(const T* __restrict__ vals, const int32_t* __restrict__ ids,
              const uint8_t* __restrict__ valid, T* __restrict__ out,
              long long n, int K, int C, int Kt) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* table = reinterpret_cast<T*>(smem_raw);
  const int k0 = blockIdx.y * Kt;
  const int kt = min(Kt, K - k0);
  if (SHARED) {
    for (int i = threadIdx.x; i < C * kt; i += blockDim.x) table[i] = T(0);
    __syncthreads();
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < n; r += stride) {
    const int id = ids[r];
    if (id < 0 || id >= C) continue;
    if (MASK == 1 && !valid[r]) continue;
    const T* vr = vals + r * K + k0;
    for (int k = 0; k < kt; ++k) {
      if (MASK == 2 && !valid[r * K + k0 + k]) continue;
      const T v = vr[k];
      if (SHARED) {
        add_to(&table[id * kt + k], v);
      } else {
        add_to(&out[(long long)id * K + k0 + k], v);
      }
    }
  }
  if (SHARED) {
    __syncthreads();
    for (int i = threadIdx.x; i < C * kt; i += blockDim.x) {
      const T v = table[i];
      if (v != T(0)) {
        const int c = i / kt;
        add_to(&out[(long long)c * K + k0 + (i - c * kt)], v);
      }
    }
  }
}

template <typename T, int MASK, bool SHARED>
cudaError_t launch(const void* vals, const int32_t* ids, const uint8_t* valid,
                   void* out, long long n, int K, int C, int Kt, size_t smem,
                   int sms, cudaStream_t stream) {
  auto kern = segsum_kernel<T, MASK, SHARED>;
  cudaError_t err;
  if (SHARED) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  long long need = (n + kThreads - 1) / kThreads;
  long long cap = (long long)sms * per_sm;
  int gx = (int)(need < cap ? need : cap);
  if (gx < 1) gx = 1;
  int gy = (K + Kt - 1) / Kt;
  kern<<<dim3(gx, gy), kThreads, smem, stream>>>(
      static_cast<const T*>(vals), ids, valid, static_cast<T*>(out), n, K, C,
      Kt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_mask(int mask_mode, bool shared, const void* vals,
                          const int32_t* ids, const uint8_t* valid, void* out,
                          long long n, int K, int C, int Kt, size_t smem,
                          int sms, cudaStream_t s) {
#define SEGSUM_CASE(M)                                                       \
  return shared ? launch<T, M, true>(vals, ids, valid, out, n, K, C, Kt,     \
                                     smem, sms, s)                           \
                : launch<T, M, false>(vals, ids, valid, out, n, K, C, Kt,    \
                                      smem, sms, s)
  if (mask_mode == 1) { SEGSUM_CASE(1); }
  if (mask_mode == 2) { SEGSUM_CASE(2); }
  SEGSUM_CASE(0);
#undef SEGSUM_CASE
}

}  // namespace

extern "C" {

// Lanes per shared-memory table for C segments of `elem` bytes and K
// lanes; 0 when not even one lane's table fits (the global-atomic path).
int tidb_segsum_lane_tile(int elem, int C, int K) {
  int dev = 0, max_smem = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&max_smem,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return -1;
  long long fit = (long long)max_smem / ((long long)C * elem);
  if (fit < 1) return 0;
  long long tiles = (K + fit - 1) / fit;
  return (int)((K + tiles - 1) / tiles);
}

// dtype: 0 float32, 1 float64, 2 int64. mask_mode: 0 none, 1 per row,
// 2 per lane. Launches on `stream`, does not synchronise, and returns
// the cudaError_t of the launch (0 = launched).
int tidb_segsum(int dtype, const void* vals, const void* ids,
                const void* valid, int mask_mode, void* out, long long n,
                int K, int C, void* stream) {
  static const int elems[3] = {4, 8, 8};
  if (dtype < 0 || dtype > 2 || K < 1 || C < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int Kt = tidb_segsum_lane_tile(elems[dtype], C, K);
  if (Kt < 0) return (int)cudaErrorInvalidValue;
  bool shared = Kt > 0;
  if (!shared) Kt = K;
  size_t smem = shared ? (size_t)C * Kt * elems[dtype] : 0;
  const int32_t* id = static_cast<const int32_t*>(ids);
  const uint8_t* vm = static_cast<const uint8_t*>(valid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch_mask<float>(mask_mode, shared, vals, id, vm, out, n,
                                       K, C, Kt, smem, sms, s);
    case 1:
      return (int)dispatch_mask<double>(mask_mode, shared, vals, id, vm, out,
                                        n, K, C, Kt, smem, sms, s);
    default:
      return (int)dispatch_mask<long long>(mask_mode, shared, vals, id, vm,
                                           out, n, K, C, Kt, smem, sms, s);
  }
}

const char* tidb_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
