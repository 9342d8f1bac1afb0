// Segment count on Hopper: out[s] = #{ i : valid_i, ids_i = s },  0 <= s < S
// (np.bincount(ids[valid], minlength=S), ids outside [0, S) dropped).
//
// Replaces the TPU kernel
//   src/repro/kernels/segment_count/kernel.py:segment_count_kernel  (B3)
// which graph construction runs once per build for the :OF_TYPE node
// degrees (events per Activity node, src/repro/graph/build.py:_node_counts).
//
// What the TPU design did and why it is not carried over: scatters
// serialize on the TPU, so the Pallas kernel turns the histogram into
// one-hot (BN x BS) tiles summed on the vector unit, accumulated in f32
// (exact only to 2^24 per segment), over ids padded to a block multiple and
// segments padded to a tile multiple.  On Hopper a histogram is what
// atomics are for: the grid strides over the ids, masks the ragged edge
// itself, and counts in integers.  Nothing is padded.
//
// Semantics (held bit for bit against segment_count_plain):
//   * ids outside [0, S) and rows whose valid byte is 0 are dropped, so no
//     atomic ever lands outside the output; `valid` may be null (no mask);
//   * counts are int32 per block in shared memory and int64 in the output.
//     Integer adds commute, so the result is the same bit for bit from run
//     to run, whatever order the atomics land in.  The reference kernel's
//     f32 sums round past 2^24 per segment; this one does not (it follows
//     np.bincount, the reference's CPU oracle).
//
// Bound.  The kernel reads each id once (4 B), the valid byte when there
// is one (1 B), and writes the int64 output (8*S B).  It does one integer
// add per id, so it is bound by bytes: at 3.35 TB/s the graph build's
// 7.2 M ids over S = 600 segments take >= ~8.6 us (~10.7 us with valid).
// Measured on an H100 at those shapes: ~19% of the bound, and uniform ids
// run as fast as the log's skewed ones, so hot segments are not what holds
// it back; the shared-memory atomic rate is the likely limit.  The design
// keeps the atomics close to the SM:
//
//   * shared-memory branch (S * 4 B fits the 227 KB a block may use,
//     S <= 58,112 on an H100): each block keeps int32 counters for every
//     segment in dynamic shared memory (opted in above 48 KB with
//     cudaFuncSetAttribute), counts its slice of the ids there with
//     shared-memory atomics, and flushes its nonzero bins with one 64-bit
//     atomicAdd each.  The grid is the SM count times the blocks that fit
//     on an SM, cut to at most N / S blocks: every block then counts at
//     least S ids, so zeroing and flushing the bins never cost more than
//     counting did, and the flush never issues more global atomics than
//     there are ids (at S = 600, 7.2 M ids: 1,056 blocks of ~6,800 ids);
//   * global branch (larger S): every id adds straight into the int64
//     output with a 64-bit atomic; the output stays in the 50 MB L2 up to
//     S ~ 6 M.
//
// Interface: plain C, loaded with ctypes (no PyTorch headers).  The caller
// zeroes `out`, passes contiguous device pointers (valid may be null) and
// the current stream, and checks the returned cudaError_t; the launch does
// not synchronize.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <bool kValid>
__device__ __forceinline__ bool segment_of(long long i,
                                           const int32_t* __restrict__ ids,
                                           const uint8_t* __restrict__ valid,
                                           int S, int* seg) {
  if (kValid && !valid[i]) return false;
  const int s = ids[i];
  // one unsigned compare rejects both negative ids and ids >= S
  if (static_cast<unsigned>(s) >= static_cast<unsigned>(S)) return false;
  *seg = s;
  return true;
}

template <bool kValid>
__global__ void __launch_bounds__(kThreads) segment_count_smem_kernel(
    const int32_t* __restrict__ ids, const uint8_t* __restrict__ valid,
    long long n, int S, unsigned long long* __restrict__ out) {
  extern __shared__ int bins[];
  for (int c = threadIdx.x; c < S; c += blockDim.x) bins[c] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    int s;
    if (segment_of<kValid>(i, ids, valid, S, &s)) atomicAdd(&bins[s], 1);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < S; c += blockDim.x) {
    const int v = bins[c];
    if (v) atomicAdd(&out[c], static_cast<unsigned long long>(v));
  }
}

template <bool kValid>
__global__ void __launch_bounds__(kThreads) segment_count_global_kernel(
    const int32_t* __restrict__ ids, const uint8_t* __restrict__ valid,
    long long n, int S, unsigned long long* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    int s;
    if (segment_of<kValid>(i, ids, valid, S, &s)) atomicAdd(&out[s], 1ULL);
  }
}

using KernelFn = void (*)(const int32_t*, const uint8_t*, long long, int,
                          unsigned long long*);

}  // namespace

extern "C" {

// Launch one count.  `valid` may be null.  `num_sms` is the card's SM
// count; the chosen grid, dynamic shared-memory bytes and branch (1 =
// shared memory, 0 = global) are written back for reports.  Returns the
// cudaError_t of the launch.
int segment_count_launch(const void* ids, const void* valid, long long n,
                         int S, void* out, int num_sms, void* stream,
                         int* grid_out, int* smem_out, int* branch_out) {
  *grid_out = 0;
  *smem_out = 0;
  *branch_out = -1;
  if (n <= 0 || S <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;

  const bool has_valid = valid != nullptr;
  const long long smem_bytes =
      static_cast<long long>(S) * static_cast<long long>(sizeof(int));
  const bool use_smem = smem_bytes <= max_smem;
  KernelFn kernel;
  int smem = 0;
  if (use_smem) {
    kernel = has_valid ? &segment_count_smem_kernel<true>
                       : &segment_count_smem_kernel<false>;
    smem = static_cast<int>(smem_bytes);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
  } else {
    kernel = has_valid ? &segment_count_global_kernel<true>
                       : &segment_count_global_kernel<false>;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;

  long long grid = static_cast<long long>(num_sms) * per_sm;
  // no block without ids to count
  const long long by_ids = (n + kThreads - 1) / kThreads;
  if (grid > by_ids) grid = by_ids;
  // shared-memory branch: every block counts >= S ids
  if (use_smem && grid > n / S) grid = n / S;
  if (grid < 1) grid = 1;

  kernel<<<static_cast<unsigned>(grid), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), static_cast<const uint8_t*>(valid), n,
      S, static_cast<unsigned long long*>(out));
  *grid_out = static_cast<int>(grid);
  *smem_out = smem;
  *branch_out = use_smem ? 1 : 0;
  return cudaGetLastError();
}

const char* segment_count_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
