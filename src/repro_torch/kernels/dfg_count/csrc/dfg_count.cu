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
// the same function is an integer histogram on the key src*A + dst, kept
// in shared memory.  Nothing is padded: the kernel masks the ragged edge.
//
// Semantics (held bit for bit against dfg_count_plain and the numpy oracle):
//   * pairs whose src or dst lies outside [0, A) are dropped, as the
//     reference oracle does (src/repro/kernels/dfg_count/ref.py);
//   * the window is compared in f64 (the reference kernel casts timestamps
//     to f32, a TPU limitation), and a NaN timestamp never counts;
//   * counts are integers throughout.  Integer adds commute, so the result
//     is the same bit for bit from run to run, whatever order the atomics
//     land in.
//
// Bound.  The function reads each input byte once and writes the int64
// (A, A) output, 8*A^2 B.  On the query engine's path src = act[:-1] and
// dst = act[1:] are views of one int32 column, ts_src and ts_dst of one
// f64 column: 4 B of ids + 1 B of valid = 5 B/pair plain, + 8 B of
// timestamps = 13 B/pair diced.  About one integer add per pair, so the
// bound is bytes: at 3.35 TB/s, 7.2 M pairs take >= ~12 us plain and
// >= ~29 us diced.
//
// Design.
//   * Every pair is counted in shared memory, in one of two tables:
//       - "shared" (16 + 4*A^2 B fit the 227 KB a block may use, A <= 241
//         on an H100): a dense int32 counter per cell, 256-thread blocks,
//         the grid cut to at most E / A^2 blocks so the flush never issues
//         more global atomics than there are pairs;
//       - "hash" (larger A): an open-addressing table of kHashSlots
//         (int32 key, int32 count) slots, key -1 for an empty slot.  A
//         directly-follows graph is sparse (PAPER_EVAL: 2,347 nonzero cells
//         of 360,000, at most 4 per row), so one table holds every cell a
//         block meets (14% load at PAPER_EVAL).  A key is hashed
//         multiplicatively and probed linearly: the first slot holding the
//         key, or an empty slot claimed with atomicCAS (whose returned key
//         is re-checked), takes a shared-memory atomicAdd.  A pair that
//         finds neither within kMaxProbes slots goes straight to a 64-bit
//         global atomicAdd into the output ("overflow"), so the result
//         equals bincount whatever the data; only the speed depends on
//         sparsity.  A warp waits for its lane with the longest probe, so
//         the limit is short: keys that fill the table (uniform over A^2
//         cells) pay at most 8 probes before their global atomic.  The
//         table is large so that its clusters of occupied slots stay
//         short; chip_smoke.py checks that none of PAPER_EVAL's pairs
//         overflows.  One 1,024-thread block per SM, persistent, keeps the
//         flush to SMs x occupied slots global atomics (~280,000 at
//         PAPER_EVAL).
//     After a barrier each block adds each nonzero counter into `out` with
//     one 64-bit atomicAdd (the hash flush starts at a slot that differs
//     from block to block, so blocks that finish together do not hit the
//     same cells in the same order).
//   * Loads read each byte once, in vectors.  A thread counts a run of
//     kRun consecutive pairs.  When src/dst (and ts_src/ts_dst) are
//     successor views of one column ("shifted"), the wrapper passes that
//     column of n + 1 entries: the run loads ids as two int4, timestamps
//     as four double2, plus one element past the run, and valid as one
//     uint2.  Separate columns ("separate") load each as vectors too.  A
//     column whose base is not aligned for the vector (a view at an odd
//     offset) is loaded element by element; since every run starts at a
//     multiple of kRun, that choice is the same for every thread.  The
//     last, partial run (n mod kRun pairs) loads element by element.  All
//     of a run's loads are issued together; only the table work depends on
//     valid.
//   * The launcher queries the card once per device (SM count, shared
//     memory limit, each dense instance's blocks per SM) and keeps the
//     answers.
//
// Interface: plain C, loaded with ctypes (no PyTorch headers).  The caller
// zeroes `out`, passes device pointers and the current stream, and checks
// the returned cudaError_t; the launch does not synchronize.  `stats`, when
// not null, is a zeroed int64 pair: [0] += pairs that overflowed the hash
// table, [1] += global atomics of the flush.

#include <cstdint>
#include <mutex>
#include <vector>

#include <cuda_runtime.h>

namespace {

constexpr int kRun = 8;              // consecutive pairs per thread
constexpr int kDenseThreads = 256;   // "shared" branch block
constexpr int kHashThreads = 1024;   // "hash" branch block, one per SM
constexpr int kHashBits = 14;
constexpr int kHashSlots = 1 << kHashBits;  // 16,384 slots, 128 KB
constexpr int kMaxProbes = 8;
constexpr int kEmptyKey = -1;
// per-block [overflowed pairs, flushed slots] ahead of the table
constexpr int kStatsBytes = 16;
constexpr int kMaxDevices = 64;

// branch codes reported to the wrapper, named by kBranchNames[code]
constexpr int kBranchShared = 0;
constexpr int kBranchHash = 1;
constexpr const char* kBranchNames[] = {"shared", "hash"};

struct Args {
  const int32_t* src;     // shifted: the column of n + 1 ids
  const int32_t* dst;     // unused when shifted
  const uint8_t* valid;   // n bytes, nonzero = valid
  const double* ts_src;   // shifted: the column of n + 1 timestamps
  const double* ts_dst;   // unused when shifted
  double t0, t1;
  long long n;
  int A;
  unsigned long long* out;    // (A, A), zeroed by the caller
  unsigned long long* stats;  // nullable
};

__device__ __forceinline__ bool aligned(const void* p, unsigned bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

__device__ __forceinline__ unsigned in_window(double t, double t0, double t1) {
  // NaN compares false, so a NaN timestamp never counts (as in numpy)
  return (t >= t0 && t < t1) ? 1u : 0u;
}

// kRun ids from p
__device__ __forceinline__ void load_ids(const int32_t* p, int (&v)[kRun]) {
  if (aligned(p, 16)) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(p));
    const int4 b = __ldg(reinterpret_cast<const int4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k) v[k] = __ldg(p + k);
  }
}

// bit k set when timestamp p[k] lies in [t0, t1), k < kRun
__device__ __forceinline__ unsigned window_bits(const double* p, double t0,
                                                double t1) {
  unsigned bits = 0;
  if (aligned(p, 16)) {
#pragma unroll
    for (int k = 0; k < kRun; k += 2) {
      const double2 t = __ldg(reinterpret_cast<const double2*>(p + k));
      bits |= in_window(t.x, t0, t1) << k;
      bits |= in_window(t.y, t0, t1) << (k + 1);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k) bits |= in_window(__ldg(p + k), t0, t1) << k;
  }
  return bits;
}

// bit k set when valid byte p[k] is nonzero, k < kRun
__device__ __forceinline__ unsigned valid_bits(const uint8_t* p) {
  unsigned bits = 0;
  if (aligned(p, 8)) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      bits |= (((v.x >> (8 * k)) & 0xffu) != 0u ? 1u : 0u) << k;
      bits |= (((v.y >> (8 * k)) & 0xffu) != 0u ? 1u : 0u) << (k + 4);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRun; ++k) bits |= (__ldg(p + k) != 0 ? 1u : 0u) << k;
  }
  return bits;
}

// The m <= kRun pairs from i0 on: ids into s, d; returns the bits of the
// pairs that are valid (and inside the window).
template <bool kWindow, bool kShifted>
__device__ __forceinline__ unsigned load_run(const Args& a, long long i0,
                                             int m, int (&s)[kRun],
                                             int (&d)[kRun]) {
  unsigned ok = 0;
  if (m == kRun) {
    ok = valid_bits(a.valid + i0);
    load_ids(a.src + i0, s);
    if (kShifted) {
      const int last = __ldg(a.src + i0 + kRun);
#pragma unroll
      for (int k = 0; k + 1 < kRun; ++k) d[k] = s[k + 1];
      d[kRun - 1] = last;
    } else {
      load_ids(a.dst + i0, d);
    }
    if (kWindow) {
      if (kShifted) {
        const unsigned w =
            window_bits(a.ts_src + i0, a.t0, a.t1) |
            (in_window(__ldg(a.ts_src + i0 + kRun), a.t0, a.t1) << kRun);
        ok &= w & (w >> 1);
      } else {
        ok &= window_bits(a.ts_src + i0, a.t0, a.t1) &
              window_bits(a.ts_dst + i0, a.t0, a.t1);
      }
    }
    return ok;
  }
#pragma unroll
  for (int k = 0; k < kRun; ++k) {
    s[k] = -1;
    d[k] = -1;
    if (k < m) {
      const long long i = i0 + k;
      s[k] = __ldg(a.src + i);
      d[k] = kShifted ? __ldg(a.src + i + 1) : __ldg(a.dst + i);
      unsigned b = __ldg(a.valid + i) != 0 ? 1u : 0u;
      if (kWindow) {
        b &= in_window(__ldg(a.ts_src + i), a.t0, a.t1);
        b &= in_window(kShifted ? __ldg(a.ts_src + i + 1) : __ldg(a.ts_dst + i),
                       a.t0, a.t1);
      }
      ok |= b << k;
    }
  }
  return ok;
}

// "shared": one int32 counter per cell
struct DenseTable {
  static constexpr int kThreads = kDenseThreads;
  int* counts;
  int cells;

  __device__ DenseTable(unsigned char* smem, int A)
      : counts(reinterpret_cast<int*>(smem)), cells(A * A) {}
  static long long bytes(int A) {
    return static_cast<long long>(A) * A * static_cast<long long>(sizeof(int));
  }
  __device__ void clear() {
    for (int c = threadIdx.x; c < cells; c += blockDim.x) counts[c] = 0;
  }
  // counts the run's keys (-1: no pair); none overflows
  __device__ unsigned add_run(const int (&key)[kRun], unsigned long long*) {
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      if (key[k] >= 0) atomicAdd(&counts[key[k]], 1);
    return 0;
  }
  __device__ unsigned flush(unsigned long long* out) {
    unsigned flushed = 0;
    for (int c = threadIdx.x; c < cells; c += blockDim.x) {
      const int v = counts[c];
      if (v) {
        atomicAdd(&out[c], static_cast<unsigned long long>(v));
        ++flushed;
      }
    }
    return flushed;
  }
};

// "hash": kHashSlots open-addressing (key, count) slots
struct HashTable {
  static constexpr int kThreads = kHashThreads;
  int* keys;
  int* counts;

  __device__ HashTable(unsigned char* smem, int)
      : keys(reinterpret_cast<int*>(smem)),
        counts(reinterpret_cast<int*>(smem) + kHashSlots) {}
  static long long bytes(int) {
    return 2LL * kHashSlots * static_cast<long long>(sizeof(int));
  }
  __device__ void clear() {
    for (int c = threadIdx.x; c < kHashSlots; c += blockDim.x) {
      keys[c] = kEmptyKey;
      counts[c] = 0;
    }
  }
  // Counts the run's keys (-1: no pair); returns the pairs that
  // overflowed.
  __device__ unsigned add_run(const int (&key)[kRun],
                              unsigned long long* out) {
    unsigned overflowed = 0;
#pragma unroll
    for (int k = 0; k < kRun; ++k)
      if (key[k] >= 0 && !add(key[k], out)) ++overflowed;
    return overflowed;
  }
  // true when counted in the table, false when the pair overflowed into
  // a global atomic
  __device__ bool add(int key, unsigned long long* out) {
    const volatile int* seen = keys;
    const unsigned h =
        (static_cast<unsigned>(key) * 2654435761u) >> (32 - kHashBits);
    for (int p = 0; p < kMaxProbes; ++p) {
      const int slot = static_cast<int>((h + p) & (kHashSlots - 1));
      int k = seen[slot];
      if (k == kEmptyKey) k = atomicCAS(&keys[slot], kEmptyKey, key);
      // the CAS returns the slot's previous key: empty means we claimed it
      if (k == kEmptyKey || k == key) {
        atomicAdd(&counts[slot], 1);
        return true;
      }
    }
    atomicAdd(&out[key], 1ULL);
    return false;
  }
  __device__ unsigned flush(unsigned long long* out) {
    // each block starts at its own warp-aligned slot
    const int start =
        static_cast<int>((static_cast<long long>(blockIdx.x) * (kHashSlots / 32)) /
                         gridDim.x) * 32;
    unsigned flushed = 0;
    for (int c = threadIdx.x; c < kHashSlots; c += blockDim.x) {
      const int slot = (c + start) & (kHashSlots - 1);
      const int k = keys[slot];
      if (k != kEmptyKey) {
        atomicAdd(&out[k], static_cast<unsigned long long>(counts[slot]));
        ++flushed;
      }
    }
    return flushed;
  }
};

template <bool kWindow, bool kShifted, class Table>
__global__ void __launch_bounds__(Table::kThreads)
    dfg_count_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char dfg_smem[];
  unsigned* block_stats = reinterpret_cast<unsigned*>(dfg_smem);
  Table table(dfg_smem + kStatsBytes, a.A);
  if (threadIdx.x < 2) block_stats[threadIdx.x] = 0;
  table.clear();
  __syncthreads();

  unsigned overflowed = 0;
  const long long runs = (a.n + kRun - 1) / kRun;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < runs; r += stride) {
    const long long i0 = r * kRun;
    const int m = a.n - i0 < kRun ? static_cast<int>(a.n - i0) : kRun;
    int s[kRun], d[kRun];
    const unsigned ok = load_run<kWindow, kShifted>(a, i0, m, s, d);
    int key[kRun];
#pragma unroll
    for (int k = 0; k < kRun; ++k) {
      // one unsigned compare rejects both negative ids and ids >= A
      const bool counted =
          ((ok >> k) & 1u) &&
          static_cast<unsigned>(s[k]) < static_cast<unsigned>(a.A) &&
          static_cast<unsigned>(d[k]) < static_cast<unsigned>(a.A);
      key[k] = counted ? s[k] * a.A + d[k] : -1;
    }
    overflowed += table.add_run(key, a.out);
  }
  __syncthreads();
  const unsigned flushed = table.flush(a.out);
  if (a.stats != nullptr) {
    if (overflowed) atomicAdd(&block_stats[0], overflowed);
    if (flushed) atomicAdd(&block_stats[1], flushed);
    __syncthreads();
    if (threadIdx.x < 2 && block_stats[threadIdx.x])
      atomicAdd(&a.stats[threadIdx.x],
                static_cast<unsigned long long>(block_stats[threadIdx.x]));
  }
}

using KernelFn = void (*)(Args);

// [table: 0 shared, 1 hash][window][shifted]
const KernelFn kKernels[2][2][2] = {
    {{&dfg_count_kernel<false, false, DenseTable>,
      &dfg_count_kernel<false, true, DenseTable>},
     {&dfg_count_kernel<true, false, DenseTable>,
      &dfg_count_kernel<true, true, DenseTable>}},
    {{&dfg_count_kernel<false, false, HashTable>,
      &dfg_count_kernel<false, true, HashTable>},
     {&dfg_count_kernel<true, false, HashTable>,
      &dfg_count_kernel<true, true, HashTable>}},
};

// What the launcher asks the card once per device.
struct DeviceInfo {
  bool ready = false;
  int num_sms = 0;
  int max_smem = 0;  // dynamic shared memory a block may use
};

struct DenseOccupancy {
  int dev, window, shifted, smem, per_sm;
};

std::mutex g_mutex;
DeviceInfo g_devices[kMaxDevices];
std::vector<DenseOccupancy> g_dense;  // one entry per (device, instance, A)

cudaError_t device_info(int dev, DeviceInfo* info) {
  DeviceInfo& d = g_devices[dev];
  if (!d.ready) {
    cudaError_t err =
        cudaDeviceGetAttribute(&d.num_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&d.max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
    const int hash_smem = kStatsBytes + static_cast<int>(HashTable::bytes(0));
    for (int w = 0; w < 2; ++w)
      for (int s = 0; s < 2; ++s) {
        err = cudaFuncSetAttribute(kKernels[0][w][s],
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   d.max_smem);
        if (err != cudaSuccess) return err;
        err = cudaFuncSetAttribute(kKernels[1][w][s],
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   hash_smem);
        if (err != cudaSuccess) return err;
      }
    d.ready = true;
  }
  *info = d;
  return cudaSuccess;
}

cudaError_t dense_per_sm(int dev, int w, int s, int smem, int* per_sm) {
  for (const DenseOccupancy& o : g_dense)
    if (o.dev == dev && o.window == w && o.shifted == s && o.smem == smem) {
      *per_sm = o.per_sm;
      return cudaSuccess;
    }
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      per_sm, kKernels[0][w][s], kDenseThreads, smem);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  g_dense.push_back({dev, w, s, smem, *per_sm});
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Launch one count.  shifted != 0: `src` and `ts_src` are columns of n + 1
// entries and the pairs are (src[i], src[i+1]), (ts_src[i], ts_src[i+1]);
// `dst` and `ts_dst` are not read.  The chosen grid, block, dynamic
// shared-memory bytes and branch (0 shared, 1 hash) are written back for
// reports.  Returns the cudaError_t of the launch.
int dfg_count_launch(const void* src, const void* dst, const void* valid,
                     const void* ts_src, const void* ts_dst, double t0,
                     double t1, int has_window, int shifted, long long n,
                     int A, void* out, void* stats, void* stream,
                     int* grid_out, int* threads_out, int* smem_out,
                     int* branch_out) {
  *grid_out = 0;
  *threads_out = 0;
  *smem_out = 0;
  *branch_out = -1;
  if (n <= 0 || A <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  const int w = has_window ? 1 : 0;
  const int s = shifted ? 1 : 0;
  const long long runs = (n + kRun - 1) / kRun;

  DeviceInfo info;
  long long grid = 0;
  int threads = 0, smem = 0, branch = 0;
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    err = device_info(dev, &info);
    if (err != cudaSuccess) return err;
    const long long dense_smem = kStatsBytes + DenseTable::bytes(A);
    if (dense_smem <= info.max_smem) {
      branch = kBranchShared;
      threads = kDenseThreads;
      smem = static_cast<int>(dense_smem);
      int per_sm = 0;
      err = dense_per_sm(dev, w, s, smem, &per_sm);
      if (err != cudaSuccess) return err;
      grid = static_cast<long long>(info.num_sms) * per_sm;
      // every block counts >= A^2 pairs, so the flush issues no more
      // global atomics than there are pairs
      const long long cells = static_cast<long long>(A) * A;
      if (grid > n / cells) grid = n / cells;
    } else {
      branch = kBranchHash;
      threads = kHashThreads;
      smem = kStatsBytes + static_cast<int>(HashTable::bytes(A));
      grid = info.num_sms;
    }
  }
  // no block without pairs to count
  const long long by_runs = (runs + threads - 1) / threads;
  if (grid > by_runs) grid = by_runs;
  if (grid < 1) grid = 1;

  Args args;
  args.src = static_cast<const int32_t*>(src);
  args.dst = static_cast<const int32_t*>(dst);
  args.valid = static_cast<const uint8_t*>(valid);
  args.ts_src = static_cast<const double*>(ts_src);
  args.ts_dst = static_cast<const double*>(ts_dst);
  args.t0 = t0;
  args.t1 = t1;
  args.n = n;
  args.A = A;
  args.out = static_cast<unsigned long long*>(out);
  args.stats = static_cast<unsigned long long*>(stats);
  KernelFn kernel = kKernels[branch][w][s];
  kernel<<<static_cast<unsigned>(grid), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(args);
  *grid_out = static_cast<int>(grid);
  *threads_out = threads;
  *smem_out = smem;
  *branch_out = branch;
  return cudaGetLastError();
}

// The name of a branch code of dfg_count_launch, or null.
const char* dfg_count_branch_name(int code) {
  return code == kBranchShared || code == kBranchHash ? kBranchNames[code]
                                                      : nullptr;
}

const char* dfg_count_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
