// DFG count on Hopper: Psi[a, b] = #{ pairs e : valid_e, src_e = a, dst_e = b
//                                              [, t0 <= ts_src_e < t1,
//                                                 t0 <= ts_dst_e < t1] }
//
// Replaces the TPU kernels
//   src/repro/kernels/dfg_count/kernel.py:dfg_kernel       (plain count, B1)
//   src/repro/kernels/dfg_count/kernel.py:dfg_dice_kernel  (count with the
//                                                           WHERE window, B2)
// with one kernel template and a compile-time window flag.
//
// What the TPU design did and why it is not carried over: scatters
// serialize on the TPU, so the Pallas kernel turns counting into one-hot
// tiles contracted on the matrix unit, accumulated in f32 (exact only to
// 2^24 per cell), with the events padded to a block multiple.  On Hopper
// the same function is an integer histogram on the key src*A + dst, built
// with atomics.  Nothing is padded: the grid strides over the pairs and
// masks the ragged edge itself.
//
// Semantics (held bit for bit against dfg_count_plain and the numpy oracle):
//   * pairs whose src or dst lies outside [0, A) are dropped, as the
//     reference oracle does (src/repro/kernels/dfg_count/ref.py), so no
//     atomic ever lands outside the output;
//   * the window is compared in f64 (the reference kernel casts timestamps
//     to f32, a TPU limitation: at epoch or 1e7-second scale f32 steps are a
//     second or more);
//   * counts are integers throughout.  Integer adds commute, so the result
//     is the same bit for bit from run to run, whatever order the atomics
//     land in.
//
// Bound.  The kernel reads each input byte once and writes the int64
// (A, A) output, 8*A^2 B.  The query engine passes src and dst as views
// src = act[:-1], dst = act[1:] of one int32 activity column, and ts_src,
// ts_dst likewise of one f64 timestamp column; neighbouring threads read
// the same cache lines, so memory serves 4 B ids + 1 B valid = 5 B/pair
// plain, + 8 B timestamps = 13 B/pair diced (9 and 25 B/pair when the
// columns are separate buffers).  It does ~1 integer add per pair, so it
// is bound by bytes: at 3.35 TB/s, 7.2 M pairs take >= ~11 us plain and
// >= ~28 us diced.  The likely obstacle between the kernel and that bound
// is atomic contention on hot cells (a process log concentrates its pairs
// on a few cells per row).  The design keeps the atomics close to the SM:
//
//   * shared-memory branch (A^2 * 4 B fits the 227 KB a block may use,
//     A <= 238): each block keeps int32 counters for the whole matrix in
//     dynamic shared memory, counts its slice of the pairs there with
//     shared-memory atomics, and flushes its nonzero cells with one 64-bit
//     atomicAdd each into the global output.  The flush costs up to
//     blocks x A^2 global atomics, so the grid is the SM count times the
//     blocks that fit on an SM, cut to at most E / A^2 blocks: every block
//     then counts at least A^2 pairs, and the flush never issues more
//     global atomics than there are pairs (at A = 32, 7.2 M pairs: 1,056
//     blocks of ~6,800 pairs, each flushing at most 1,024 cells).
//   * global branch (larger A; PAPER_EVAL's A = 600 needs 1.44 MB of
//     counters): every pair adds straight into the int64 output with a
//     64-bit atomic.  The output (2.9 MB at A = 600) stays resident in the
//     50 MB L2, where the atomics execute.
//
// Interface: plain C, loaded with ctypes (no PyTorch headers).  The caller
// zeroes `out`, passes contiguous device pointers and the current stream,
// and checks the returned cudaError_t; the launch does not synchronize.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kWindow>
__device__ __forceinline__ bool pair_key(
    long long i, const int32_t* __restrict__ src,
    const int32_t* __restrict__ dst, const uint8_t* __restrict__ valid,
    const double* __restrict__ ts_src, const double* __restrict__ ts_dst,
    double t0, double t1, int A, int* key) {
  if (!valid[i]) return false;
  const int s = src[i];
  const int d = dst[i];
  // one unsigned compare rejects both negative ids and ids >= A
  if (static_cast<unsigned>(s) >= static_cast<unsigned>(A) ||
      static_cast<unsigned>(d) >= static_cast<unsigned>(A))
    return false;
  if (kWindow) {
    const double a = ts_src[i];
    const double b = ts_dst[i];
    // NaN compares false, so a NaN timestamp never counts (as in numpy)
    if (!(a >= t0 && a < t1 && b >= t0 && b < t1)) return false;
  }
  *key = s * A + d;
  return true;
}

template <bool kWindow>
__global__ void __launch_bounds__(kThreads) dfg_count_smem_kernel(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const uint8_t* __restrict__ valid, const double* __restrict__ ts_src,
    const double* __restrict__ ts_dst, double t0, double t1, long long n,
    int A, unsigned long long* __restrict__ out) {
  extern __shared__ int counts[];
  const int cells = A * A;
  for (int c = threadIdx.x; c < cells; c += blockDim.x) counts[c] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    int key;
    if (pair_key<kWindow>(i, src, dst, valid, ts_src, ts_dst, t0, t1, A,
                          &key))
      atomicAdd(&counts[key], 1);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    const int v = counts[c];
    if (v) atomicAdd(&out[c], static_cast<unsigned long long>(v));
  }
}

template <bool kWindow>
__global__ void __launch_bounds__(kThreads) dfg_count_global_kernel(
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const uint8_t* __restrict__ valid, const double* __restrict__ ts_src,
    const double* __restrict__ ts_dst, double t0, double t1, long long n,
    int A, unsigned long long* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    int key;
    if (pair_key<kWindow>(i, src, dst, valid, ts_src, ts_dst, t0, t1, A,
                          &key))
      atomicAdd(&out[key], 1ULL);
  }
}

using KernelFn = void (*)(const int32_t*, const int32_t*, const uint8_t*,
                          const double*, const double*, double, double,
                          long long, int, unsigned long long*);

}  // namespace

extern "C" {

// Launch one count.  `num_sms` is the card's SM count; the chosen grid,
// dynamic shared-memory bytes and branch (1 = shared memory, 0 = global)
// are written back for reports.  Returns the cudaError_t of the launch.
int dfg_count_launch(const void* src, const void* dst, const void* valid,
                     const void* ts_src, const void* ts_dst, double t0,
                     double t1, int has_window, long long n, int A,
                     void* out, int num_sms, void* stream, int* grid_out,
                     int* smem_out, int* branch_out) {
  *grid_out = 0;
  *smem_out = 0;
  *branch_out = -1;
  if (n <= 0 || A <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;

  const long long cells = static_cast<long long>(A) * A;
  const long long smem_bytes = cells * static_cast<long long>(sizeof(int));
  const bool use_smem = smem_bytes <= max_smem;
  KernelFn kernel;
  int smem = 0;
  if (use_smem) {
    if (has_window)
      kernel = &dfg_count_smem_kernel<true>;
    else
      kernel = &dfg_count_smem_kernel<false>;
    smem = static_cast<int>(smem_bytes);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
  } else {
    if (has_window)
      kernel = &dfg_count_global_kernel<true>;
    else
      kernel = &dfg_count_global_kernel<false>;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;

  long long grid = static_cast<long long>(num_sms) * per_sm;
  // no block without pairs to count
  const long long by_pairs = (n + kThreads - 1) / kThreads;
  if (grid > by_pairs) grid = by_pairs;
  // shared-memory branch: every block counts >= A^2 pairs, so the flush
  // issues no more global atomics than there are pairs
  if (use_smem && grid > n / cells) grid = n / cells;
  if (grid < 1) grid = 1;

  kernel<<<static_cast<unsigned>(grid), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
      static_cast<const uint8_t*>(valid), static_cast<const double*>(ts_src),
      static_cast<const double*>(ts_dst), t0, t1, n, A,
      static_cast<unsigned long long*>(out));
  *grid_out = static_cast<int>(grid);
  *smem_out = smem;
  *branch_out = use_smem ? 1 : 0;
  return cudaGetLastError();
}

const char* dfg_count_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
