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
// atomics are for: the kernel counts in integers and masks the ragged edge
// itself.  Nothing is padded.
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
// add per id, so it is bound by bytes: at 3.35 TB/s, (4 B x 7,200,010 ids
// + 8 B x 600 segments) take >= 8.6 us at the graph build's shapes (10.8 us
// with a valid column).
//
// What held the first design back (one 4-byte load per thread per step and
// a shared atomic before the next, 1,056 blocks of 256 threads, each
// flushing all its nonzero bins): the loads.  Measured with chip_smoke.py
// on an NVIDIA H100 80GB HBM3 at 700 W, alone on the card after an L2
// flush: 0.0338 ms at those shapes, 0.85 TB/s, 25% of the bound; uniform
// ids as fast (0.0344), and every id one activity faster (0.0252), so
// neither hot bins nor shared atomics set the pace.  2,048 threads x 4 B =
// 8 KB of loads in flight per SM cannot cover the memory's latency.
//
// Design.
//   * Loads with bytes in flight: the ids are read as 16-byte int4 vectors,
//     kVec = 4 of them (64 B, 16 ids) issued by a thread before the first
//     atomic on any of them; 1,024 threads a block, one block per SM (the
//     occupancy the ~40 registers allow): 64 KB in flight per SM.  A valid
//     column is read as one 32-bit word per int4 (its byte k masks the
//     vector's lane k).  A column whose base is not 16-byte aligned (a view
//     at any 4-byte offset) has up to three head ids before the first
//     aligned vector; they and the up to three ids after the last whole
//     vector are counted one by one by the first block.  A valid column
//     whose bytes for the aligned body do not start on a 4-byte boundary
//     is read byte by byte.  Each byte is read once, with __ldcs
//     (ld.global.cs: the kernel never writes the columns, and a line read
//     once is marked first to evict, so it does not push other lines out
//     of the L2).  Timed against __ldg in the same build, that was faster
//     after an L2 flush or a host-to-device copy and slower only when the
//     previous launch of the same kernel had left the ids in the L2.
//   * A persistent grid: the SM count times the blocks per SM that the
//     occupancy query gives, each block counting one contiguous share of
//     the vectors (equal to within 8 vectors, 128-byte aligned).
//       - "shared" branch (S * 4 B fit the shared memory a block may use,
//         S <= 58,112 on an H100): int32 bins for every segment in dynamic
//         shared memory, shared-memory atomics, then one 64-bit atomicAdd
//         per nonzero bin.  The flush issues at most grid x S global
//         atomics (132 x 600 = 79,200 at the graph build's shapes, against
//         up to 633,600 in the first design).  The grid is cut to at most
//         N / S blocks, so every block counts at least S ids and zeroing
//         and flushing never cost more than counting.  One copy of the bins:
//         one address for every id ran no slower than the log's ids, so
//         nothing asks for replicated bins;
//       - "global" branch (larger S): every id adds straight into the
//         int64 output with a 64-bit atomic; the output stays in the 50 MB
//         L2 up to S ~ 6 M.
//     No block is launched without a vector for each of its threads.
//   * The launcher queries the card once per device (SM count, shared
//     memory limit, the attribute that opts the shared instances in to
//     it) and keeps each instance's blocks per SM: a launch makes one
//     cudaGetDevice call.
// Result (chip_smoke.py, NVIDIA H100 80GB HBM3 at 700 W, same shapes):
// 0.0188 ms after a flush that leaves the L2 dirty (45.6% of the bound),
// 0.0168 ms after one that leaves it clean (51.1%); PyTorch's own read of
// the column, torch.amax, takes 0.0245 ms: the read itself is what is left
// between this kernel and its bound.
//
// Interface: plain C, loaded with ctypes (no PyTorch headers).  The caller
// zeroes `out`, passes device pointers (ids int32 at any 4-byte offset,
// valid one byte per id or null) and the current stream, and checks the
// returned cudaError_t; the launch does not synchronize.

#include <cstdint>
#include <mutex>
#include <vector>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;  // threads per block
constexpr int kVec = 4;         // int4 vectors a thread loads per step
constexpr int kLanes = 4;       // ids per int4
constexpr int kMaxDevices = 64;

// branch codes reported to the wrapper, named by kBranchNames[code]
constexpr int kBranchGlobal = 0;
constexpr int kBranchShared = 1;
constexpr const char* kBranchNames[] = {"global", "shared"};

struct Args {
  const int32_t* ids;
  const uint8_t* valid;  // n bytes, nonzero = valid; null: all valid
  long long n;
  int S;
  unsigned long long* out;  // (S,), zeroed by the caller
};

__device__ __forceinline__ bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// bit k set when valid byte p[k] is nonzero, k < kLanes
__device__ __forceinline__ unsigned valid_bits(const uint8_t* p,
                                               bool word_aligned) {
  unsigned w;
  if (word_aligned) {
    w = __ldcs(reinterpret_cast<const unsigned*>(p));
  } else {
    w = 0;
#pragma unroll
    for (int k = 0; k < kLanes; ++k)
      w |= static_cast<unsigned>(__ldcs(p + k)) << (8 * k);
  }
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < kLanes; ++k)
    bits |= (((w >> (8 * k)) & 0xffu) != 0u ? 1u : 0u) << k;
  return bits;
}

// Counts id s: into the block's bins, or straight into the output.
template <bool kShared>
__device__ __forceinline__ void add(int s, int S, int* bins,
                                    unsigned long long* out) {
  // one unsigned compare rejects both negative ids and ids >= S
  if (static_cast<unsigned>(s) >= static_cast<unsigned>(S)) return;
  if (kShared)
    atomicAdd(&bins[s], 1);
  else
    atomicAdd(&out[s], 1ULL);
}

// First vector of block b's share of nvec vectors: shares are equal to
// within 8 vectors and start on a 128-byte boundary.
__device__ __forceinline__ long long share_start(long long nvec, unsigned b) {
  if (b >= gridDim.x) return nvec;
  return (nvec * b / gridDim.x) & ~7LL;
}

template <bool kValid, bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
    segment_count_kernel(const Args a) {
  extern __shared__ __align__(16) int bins[];
  if (kShared) {
    for (int c = threadIdx.x; c < a.S; c += blockDim.x) bins[c] = 0;
    __syncthreads();
  }
  // ids [0, head) lie before the first 16-byte boundary; the body of nvec
  // int4 vectors follows; ids [tail, n) are what is left after it
  const long long to_boundary =
      static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(a.ids) & 15)) &
                             15) / 4;
  const long long head = to_boundary < a.n ? to_boundary : a.n;
  const long long nvec = (a.n - head) / kLanes;
  const long long tail = head + nvec * kLanes;
  const int4* body = reinterpret_cast<const int4*>(a.ids + head);
  const uint8_t* vbody = kValid ? a.valid + head : nullptr;
  const bool word_aligned = kValid && aligned(vbody, 4);

  const long long lo = share_start(nvec, blockIdx.x);
  const long long hi = share_start(nvec, blockIdx.x + 1);
  for (long long v0 = lo + threadIdx.x; v0 < hi;
       v0 += static_cast<long long>(kVec) * kThreads) {
    // every load of the step is issued before the first atomic
    int4 x[kVec];
    unsigned ok[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const long long v = v0 + static_cast<long long>(k) * kThreads;
      ok[k] = 0;
      if (v < hi) {
        x[k] = __ldcs(body + v);
        ok[k] = kValid ? valid_bits(vbody + kLanes * v, word_aligned) : 0xfu;
      }
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      if (ok[k] & 1u) add<kShared>(x[k].x, a.S, bins, a.out);
      if (ok[k] & 2u) add<kShared>(x[k].y, a.S, bins, a.out);
      if (ok[k] & 4u) add<kShared>(x[k].z, a.S, bins, a.out);
      if (ok[k] & 8u) add<kShared>(x[k].w, a.S, bins, a.out);
    }
  }
  // the head and tail ids, one each, by the first block's first threads
  if (blockIdx.x == 0) {
    const long long t = threadIdx.x;
    const long long i = t < head ? t : tail + (t - head);
    if (i < a.n && (!kValid || __ldcs(a.valid + i) != 0))
      add<kShared>(__ldcs(a.ids + i), a.S, bins, a.out);
  }
  if (kShared) {
    __syncthreads();
    for (int c = threadIdx.x; c < a.S; c += blockDim.x) {
      const int v = bins[c];
      if (v) atomicAdd(&a.out[c], static_cast<unsigned long long>(v));
    }
  }
}

using KernelFn = void (*)(Args);

// [branch: 0 global, 1 shared][valid]
const KernelFn kKernels[2][2] = {
    {&segment_count_kernel<false, false>, &segment_count_kernel<true, false>},
    {&segment_count_kernel<false, true>, &segment_count_kernel<true, true>},
};

// What the launcher asks the card once per device.
struct DeviceInfo {
  bool ready = false;
  int num_sms = 0;
  int max_smem = 0;  // dynamic shared memory a block may use
};

struct Occupancy {
  int dev, branch, valid, smem, per_sm;
};

std::mutex g_mutex;
DeviceInfo g_devices[kMaxDevices];
std::vector<Occupancy> g_occupancy;  // one entry per (device, instance, smem)

cudaError_t device_info(int dev, DeviceInfo* info) {
  DeviceInfo& d = g_devices[dev];
  if (!d.ready) {
    cudaError_t err =
        cudaDeviceGetAttribute(&d.num_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&d.max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    for (int v = 0; v < 2; ++v) {
      err = cudaFuncSetAttribute(kKernels[kBranchShared][v],
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 d.max_smem);
      if (err != cudaSuccess) return err;
    }
    d.ready = true;
  }
  *info = d;
  return cudaSuccess;
}

cudaError_t blocks_per_sm(int dev, int branch, int valid, int smem,
                          int* per_sm) {
  for (const Occupancy& o : g_occupancy)
    if (o.dev == dev && o.branch == branch && o.valid == valid &&
        o.smem == smem) {
      *per_sm = o.per_sm;
      return cudaSuccess;
    }
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kKernels[branch][valid], kThreads, smem);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  g_occupancy.push_back({dev, branch, valid, smem, *per_sm});
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launch one count.  `valid` may be null.  The launch's configuration is
// written back for reports into config[0..4]: the grid, the blocks per SM
// it was cut from, threads per block, dynamic shared-memory bytes and the
// branch (0 global, 1 shared; -1 when nothing was launched).  Returns the
// cudaError_t of the launch.
int segment_count_launch(const void* ids, const void* valid, long long n,
                         int S, void* out, void* stream, int* config) {
  for (int c = 0; c < 5; ++c) config[c] = 0;
  config[4] = -1;
  if (n <= 0 || S <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  const int v = valid != nullptr ? 1 : 0;

  long long grid = 0;
  int per_sm = 0, smem = 0, branch = kBranchGlobal;
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    DeviceInfo info;
    err = device_info(dev, &info);
    if (err != cudaSuccess) return err;
    const long long smem_bytes =
        static_cast<long long>(S) * static_cast<long long>(sizeof(int));
    if (smem_bytes <= info.max_smem) {
      branch = kBranchShared;
      smem = static_cast<int>(smem_bytes);
    }
    err = blocks_per_sm(dev, branch, v, smem, &per_sm);
    if (err != cudaSuccess) return err;
    grid = static_cast<long long>(info.num_sms) * per_sm;
  }
  // no block without a vector for each of its threads to start on
  const long long by_vectors = (n / kLanes + kThreads - 1) / kThreads;
  if (grid > by_vectors) grid = by_vectors;
  // shared branch: every block counts >= S ids
  if (branch == kBranchShared && grid > n / S) grid = n / S;
  if (grid < 1) grid = 1;

  Args args;
  args.ids = static_cast<const int32_t*>(ids);
  args.valid = static_cast<const uint8_t*>(valid);
  args.n = n;
  args.S = S;
  args.out = static_cast<unsigned long long*>(out);
  KernelFn kernel = kKernels[branch][v];
  kernel<<<static_cast<unsigned>(grid), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(args);
  config[0] = static_cast<int>(grid);
  config[1] = per_sm;
  config[2] = kThreads;
  config[3] = smem;
  config[4] = branch;
  return cudaGetLastError();
}

// The name of a branch code of segment_count_launch, or null.
const char* segment_count_branch_name(int code) {
  return code == kBranchGlobal || code == kBranchShared ? kBranchNames[code]
                                                        : nullptr;
}

const char* segment_count_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
