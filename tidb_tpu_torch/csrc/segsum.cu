// Masked segment-sum for Hopper (sm_90a):
//   out[C, K] += sum over rows r with 0 <= ids[r] < C of
//                onehot(ids[r]) * where(valid, values[r, :], 0)
//
// Replaces the JAX package's Pallas TPU kernel segment_sum_pallas
// (tidb_tpu/ops/pallas_agg.py:106-155, pallas_call at :147; bodies _kernel
// :65 and _kernel_masked :82). There the sum is a one-hot [C, T] x [T, K]
// matmul per 512-row tile on the MXU, accumulated in a VMEM-resident
// [C, K] block across a sequential grid. Here blocks run in parallel and
// in no order, and Q1's lanes are int64, which the tensor cores do not
// take: the kernel stays on the CUDA cores, adds exactly in int64, and
// merges per-block tables into `out` with global atomics.
//
// Bound: each input byte is read once, n * (4 + K * sizeof(T) + mask
// bytes), and C * K * sizeof(T) are written; one add per (row, lane). At
// Q1's shape (2^18 rows x 12 int64 lanes, lane mask, C = 4096) that is
// 29.75 MB, about 8.9 us at 3.35 TB/s: the kernel is bound by device
// memory, and the design is about keeping bytes in flight and doing
// little else per byte. What it does about each suspect of the first
// version (one atomic per (row, lane), two lane-tile passes, scalar
// strided loads, O(C) table work, per-call device queries):
//
// 1. Contended atomics. SASS finding (cuobjdump -sass, sm_90a): a 64-bit
//    atomicAdd on shared memory has no native instruction; it compiles to
//    a compare-and-swap loop (ATOMS.CAST.SPIN.64; float32 to
//    ATOMS.CAST.SPIN), so each collision of the first version's
//    one-add-per-(row, lane) design was a retry. Now a warp groups its 32
//    rows by slot with __match_any_sync and sums each group's lanes in
//    registers with a log-step shuffle tree (int64 and double move as two
//    32-bit halves inside __shfl_sync; int64 adds stay exact, in unsigned
//    64-bit arithmetic, so their wrap is defined). One leader lane per
//    distinct slot then adds,
//    for Q1 at most 7 adds per lane per 32 rows instead of 32, into a
//    table private to its warp: a slot has one leader per warp, so the
//    adds are plain loads and stores and the kernel issues no atomic in
//    shared memory at all (a table shared by the block, with the CAS loop
//    for the leaders' adds, measured slower at both of PERF.md's shapes).
//    When every live slot of a warp is distinct (ids spread over 4096
//    slots) the grouping is skipped by a warp vote.
// 2. Two passes. There is no lane-tile grid axis: a warp's table keeps
//    all K lanes of its slots, so each input byte is read once.
// 3. Scalar strided loads. A persistent grid (SMs x blocks per SM) walks
//    contiguous row tiles. Each tile's ids, values and mask bytes are
//    contiguous in memory whatever K is, so they are staged into shared
//    memory with 16-byte cp.async copies, one tile a block at a time.
//    Rows of whole 16-byte chunks are read back as 16-byte vectors.
//    Neighbouring lanes of a row leave for global memory together, so a
//    row's atomics fall on one or two cache lines. The bytes in flight
//    come from the other blocks of the SM: 4 blocks of 256 threads (32
//    warps, the most 64 registers a thread allow) fit an SM, and their
//    copies overlap each block's reduction. Double buffering fits only
//    with fewer warps, and measured slower (PERF.md).
// 4. O(C) table work. A table holds W slots: the first W - 1 slots and
//    slot C - 1 (the dead slot of the direct group table, where Q1's
//    filtered rows land). W = C when the whole [C, K] table of every warp
//    fits the plan's budget (several blocks per SM); otherwise W fills
//    that budget, and slots outside the window go to global atomics after
//    the warp's pre-aggregation. Zeroing and the flush cost O(W * K), and
//    only non-zero entries are flushed.
// 5. Per-call device queries. The launch plan (W, tile, threads, grid,
//    shared bytes) is computed once per shape class in Python
//    (ops/segsum.py) from device limits read once per device, and the
//    shared-memory opt-in of every variant is set once per device
//    (tidb_segsum_init). A launch is one cudaLaunchKernel.
//
// What bounds it now: the per-warp reduction (match, shuffle rounds,
// table adds) is latency-bound; the kernel runs faster the more warps an
// SM holds (PERF.md).
//
// Layout: values [n, K] row-major, ids [n] int32, valid [n] (mask_mode 1)
// or [n, K] (mask_mode 2) bytes, all 16-byte aligned; out [C, K] zeroed by
// the caller. Ids outside [0, C) are dropped (jax.ops.segment_sum's
// semantics). A dead lane is replaced by 0 with a select, never
// multiplied by 0, so a NaN under a dead mask never reaches the sum.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 256;
// Blocks of kMaxThreads an SM must be able to hold: caps registers at 64
// a thread, so 32 warps fit an SM (ops/segsum.REGS_PER_THREAD).
constexpr int kMinBlocks = 4;
// Shuffle rounds of the peer tree: 32 peers need 5 (each round retires
// the peers whose relative position has the round's bit set).
constexpr int kRounds = 5;
// Lanes a thread holds in registers at once: independent loads, shuffles
// and adds, so one row's lanes overlap instead of queueing on latency.
// A chunk's lane mask loads as one 32-bit word, so it is 4 lanes.
constexpr int kChunk = 4;

__host__ __device__ __forceinline__ int round16(int x) {
  return (x + 15) & ~15;
}

// Bytes of one staged tile; the same formula as ops/segsum.stage_bytes.
__host__ __device__ __forceinline__ int stage_bytes(int elem, int K, int mask,
                                                    int tile) {
  const int mbytes = mask == 2 ? tile * K : (mask == 1 ? tile : 0);
  return round16(tile * K * elem) + tile * 4 + round16(mbytes);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Waits until every cp.async this thread issued has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copies `bytes` from 16-byte aligned global memory to 16-byte aligned
// shared memory: whole 16-byte chunks with cp.async, a ragged tail (only
// the last tile has one) with plain byte stores.
__device__ __forceinline__ void stage_copy(unsigned char* dst,
                                           const unsigned char* src,
                                           int bytes) {
  const int chunks = bytes >> 4;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x)
    cp_async16(dst + c * 16, src + c * 16);
  if (threadIdx.x == 0)
    for (int b = chunks * 16; b < bytes; ++b) dst[b] = src[b];
}

// x[i] = p[i] for each 16-byte piece of the chunk that starts below
// `live`, from 16-byte aligned shared memory holding whole pieces.
template <typename T>
__device__ __forceinline__ void load_lanes(const T* p, int live, T* x) {
  constexpr int per = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < kChunk; i += per) {
    if (i < live) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + i);
      memcpy(x + i, &u, 16);
    }
  }
}

// a + b; int64 adds in unsigned 64-bit arithmetic, so a sum that
// overflows wraps as two's complement by definition.
template <typename T>
__device__ __forceinline__ T add(T a, T b) {
  return a + b;
}
template <>
__device__ __forceinline__ long long add(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}

__device__ __forceinline__ void atomic_add(float* p, float v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void atomic_add(double* p, double v) {
  atomicAdd(p, v);
}
__device__ __forceinline__ void atomic_add(long long* p, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p),
            static_cast<unsigned long long>(v));
}

// Table row of slot `id` in a window of W slots (the first W - 1 slots
// and slot C - 1), or -1 when the slot lies outside the window.
__device__ __forceinline__ int window_row(int id, int W, int C) {
  if (id < W - 1) return id;
  return id == C - 1 ? W - 1 : -1;
}

// One warp's 32 staged rows r0.. into its table `wt` ([W, K]) and `out`.
// sv/si/sm are the tile's staged values, ids and mask bytes; the warp
// owns its rows in them and rewrites them in place.
template <typename T, int MASK>
__device__ __forceinline__ void reduce_rows(T* sv, int32_t* si, uint8_t* sm,
                                            int r0, int rows, T* wt,
                                            T* __restrict__ out, int K,
                                            int C, int W) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int r = r0 + lane;
  int id = -1;
  if (r < rows) {
    id = si[r];
    if (id < 0 || id >= C) id = -1;
    if (MASK == 1 && !sm[r]) id = -1;
  }
  // group the warp's rows by slot; the lowest lane of a group leads
  const unsigned peers = __match_any_sync(kFull, id);
  T* rv = sv + r * K;
  bool masked = MASK == 2;
  if (__all_sync(kFull, id < 0 || peers == (1u << lane))) {
    // every live slot distinct: the staged rows go to the pass below as
    // they are
    si[r] = id;
  } else {
    const bool leader = (peers & below) == 0;
    // the shuffle schedule of the peer tree, shared by all K lanes: in
    // round j a lane adds the value of lane nxt[j] (its next live peer)
    int nxt[kRounds] = {-1, -1, -1, -1, -1};
    int rounds = 0;
    {
      unsigned rest = peers & ~(below | (1u << lane));
      unsigned rel = __popc(peers & below);
#pragma unroll
      for (int j = 0; j < kRounds; ++j) {
        if (!__any_sync(kFull, rest != 0)) break;
        nxt[j] = rest ? __ffs(rest) - 1 : -1;
        rest &= __ballot_sync(kFull, (rel & 1) == 0);
        rel >>= 1;
        rounds = j + 1;
      }
    }
    const int row = id >= 0 ? window_row(id, W, C) : -1;
    const uint8_t* rm = sm + r * K;
    // whole 16-byte chunks of lanes load as vectors, 4 mask bytes as one
    const bool vec = (K * (int)sizeof(T)) % 16 == 0;
    for (int k0 = 0; k0 < K; k0 += kChunk) {
      T x[kChunk];
      if (vec) {
        load_lanes(rv + k0, K - k0, x);
        uint32_t live = 0xffffffffu;
        if (MASK == 2 && K % 4 == 0)
          live = *reinterpret_cast<const uint32_t*>(rm + k0);
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const int k = k0 + c;
          const bool on = MASK != 2 ? true
                          : (K % 4 == 0 ? ((live >> (8 * c)) & 0xff) != 0
                                        : k < K && rm[k]);
          if (!(k < K && id >= 0 && on)) x[c] = T(0);
        }
      } else {
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const int k = k0 + c;
          x[c] = T(0);
          if (k < K && id >= 0 && (MASK != 2 || rm[k])) x[c] = rv[k];
        }
      }
#pragma unroll
      for (int j = 0; j < kRounds; ++j) {
        if (j < rounds) {
          const int src = nxt[j] < 0 ? lane : nxt[j];
#pragma unroll
          for (int c = 0; c < kChunk; ++c) {
            const T y = __shfl_sync(kFull, x[c], src);
            if (nxt[j] >= 0) x[c] = add(x[c], y);
          }
        }
      }
      if (leader && id >= 0) {
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const int k = k0 + c;
          if (k >= K) break;
          if (row >= 0) {
            // one leader a slot: a plain load and store
            if (x[c] != T(0)) wt[row * K + k] = add(wt[row * K + k], x[c]);
          } else {
            rv[k] = x[c];     // the group's sum, for the pass below
          }
        }
      }
    }
    // only the sums of slots outside the window are left for the pass
    si[r] = leader && row < 0 ? id : -1;
    masked = false;
  }
  __syncwarp();
  if (__any_sync(kFull, r < rows && si[r] >= 0)) {
    // element e = (row e / K, lane e % K) of the warp's rows: neighbouring
    // lanes take neighbouring lanes of a row, so the global atomics of a
    // row fall on one or two cache lines
    const int step_r = 32 / K, step_k = 32 % K;
    int er = lane / K, ek = lane % K;
    for (int e = lane; e < 32 * K; e += 32) {
      const int s = si[r0 + er];
      if (s >= 0 && (!masked || sm[(r0 + er) * K + ek])) {
        const T v = sv[(r0 + er) * K + ek];
        if (v != T(0)) {
          const int wr = window_row(s, W, C);
          if (wr >= 0)   // slots of the warp's rows are distinct
            wt[wr * K + ek] = add(wt[wr * K + ek], v);
          else
            atomic_add(&out[(long long)s * K + ek], v);
        }
      }
      er += step_r;
      ek += step_k;
      if (ek >= K) {
        ek -= K;
        ++er;
      }
    }
  }
  __syncwarp();
}

// MASK: 0 = no mask, 1 = one flag per row, 2 = one flag per (row, lane).
// Each warp keeps its own [W, K] table; the tables are summed into `out`
// at the end.
template <typename T, int MASK>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
segsum_kernel(const T* __restrict__ vals, const int32_t* __restrict__ ids,
              const uint8_t* __restrict__ valid, T* __restrict__ out,
              long long n, int K, int C, int W, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int vbytes = round16(tile * K * (int)sizeof(T));
  const int ibytes = tile * 4;
  const int stage = stage_bytes((int)sizeof(T), K, MASK, tile);
  T* table = reinterpret_cast<T*>(smem + stage);
  const int words = W * K;
  const int nwarps = blockDim.x >> 5;
  T* wt = table + (threadIdx.x >> 5) * words;

  for (int i = threadIdx.x; i < nwarps * words; i += blockDim.x)
    table[i] = T(0);

  const long long ntiles = (n + tile - 1) / tile;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long row0 = t * tile;
    const int rows = (int)min((long long)tile, n - row0);
    stage_copy(smem, reinterpret_cast<const unsigned char*>(vals + row0 * K),
               rows * K * (int)sizeof(T));
    stage_copy(smem + vbytes,
               reinterpret_cast<const unsigned char*>(ids + row0), rows * 4);
    if (MASK == 1) stage_copy(smem + vbytes + ibytes, valid + row0, rows);
    if (MASK == 2)
      stage_copy(smem + vbytes + ibytes, valid + row0 * K, rows * K);
    cp_async_wait_all();
    __syncthreads();
    for (int r0 = threadIdx.x & ~31; r0 < tile; r0 += blockDim.x)
      reduce_rows<T, MASK>(reinterpret_cast<T*>(smem),
                           reinterpret_cast<int32_t*>(smem + vbytes),
                           smem + vbytes + ibytes, r0, rows, wt, out, K, C,
                           W);
    __syncthreads();              // the tile is restaged next round
  }

  __syncthreads();
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    T v = table[i];
    for (int w = 1; w < nwarps; ++w) v = add(v, table[w * words + i]);
    if (v != T(0)) {
      const int row = i / K;
      const int slot = row < W - 1 ? row : C - 1;
      atomic_add(&out[(long long)slot * K + (i - row * K)], v);
    }
  }
}

template <typename T>
const void* pick_dtype(int mask) {
  if (mask == 1) return (const void*)segsum_kernel<T, 1>;
  if (mask == 2) return (const void*)segsum_kernel<T, 2>;
  return (const void*)segsum_kernel<T, 0>;
}

const void* pick(int dtype, int mask) {
  if (dtype == 0) return pick_dtype<float>(mask);
  if (dtype == 1) return pick_dtype<double>(mask);
  return pick_dtype<long long>(mask);
}

const int kElem[3] = {4, 8, 8};

}  // namespace

extern "C" {

// Device limits the launch plan needs, read once per device:
// out = {SMs, opt-in shared bytes per block, shared bytes per SM,
//        threads per SM, shared bytes the system reserves per block,
//        32-bit registers per SM}.
int tidb_segsum_device_limits(int dev, int* out) {
  const cudaDeviceAttr attrs[6] = {
      cudaDevAttrMultiProcessorCount, cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrMaxThreadsPerMultiProcessor,
      cudaDevAttrReservedSharedMemoryPerBlock,
      cudaDevAttrMaxRegistersPerMultiprocessor};
  for (int i = 0; i < 6; ++i) {
    cudaError_t err = cudaDeviceGetAttribute(&out[i], attrs[i], dev);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// Lets every variant take up to `max_smem` bytes of dynamic shared memory
// on the current device. Called once per device, before any launch.
int tidb_segsum_init(int max_smem) {
  for (int d = 0; d < 3; ++d)
    for (int m = 0; m < 3; ++m) {
      cudaError_t err = cudaFuncSetAttribute(
          pick(d, m), cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
      if (err != cudaSuccess) return (int)err;
    }
  return 0;
}

// out[C, K] += the segment sums of values [n, K] by ids, as above.
// dtype: 0 float32, 1 float64, 2 int64. mask_mode: 0 none, 1 per row,
// 2 per lane. The launch plan comes from ops/segsum.launch_plan: W window
// slots, tile rows per staged tile, threads, grid and smem bytes. Launches on `stream`, does not synchronise, and
// returns the cudaError_t of the launch (0 = launched).
int tidb_segsum(int dtype, const void* vals, const void* ids,
                const void* valid, int mask_mode, void* out, long long n,
                int K, int C, void* stream, int W, int tile, int threads,
                int grid, int smem) {
  if (dtype < 0 || dtype > 2 || mask_mode < 0 || mask_mode > 2 || n < 1 ||
      K < 1 || C < 1 || W < 1 || W > C || tile < 32 || tile % 32 ||
      threads < 32 || threads > kMaxThreads || threads % 32 ||
      tile % threads || grid < 1)
    return (int)cudaErrorInvalidValue;
  const long long need =
      (long long)stage_bytes(kElem[dtype], K, mask_mode, tile) +
      (long long)(threads / 32) * W * K * kElem[dtype];
  if ((long long)smem < need) return (int)cudaErrorInvalidValue;
  const uintptr_t align = (uintptr_t)vals | (uintptr_t)ids |
                          (mask_mode ? (uintptr_t)valid : 0);
  if (align & 15) return (int)cudaErrorInvalidValue;
  void* args[] = {&vals, &ids, &valid, &out, &n, &K, &C, &W, &tile};
  cudaError_t err = cudaLaunchKernel(pick(dtype, mask_mode), dim3(grid),
                                     dim3(threads), args, (size_t)smem,
                                     static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* tidb_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
