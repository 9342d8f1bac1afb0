// Layered DFG-alignment DP on Hopper: one optimal alignment cost per trace
// variant.  For variant v with activity ids a_0 .. a_{len-1}, over S model
// states, starting from the front d = d0:
//
//   per layer i < len, a = a_i:
//     sync = min_s ( d[s] + Mt[a, s] )          // model moves, then sync on a
//     d[s] = fminf( d[s] + 1, s == a ? sync : BIG_COST )   // or a log move
//   out[v] = min_s ( d[s] + end[s] )
//
// Replaces the TPU kernel
//   src/repro/kernels/align_dp/kernel.py:align_dp_kernel  (B4)
// which every alignments() query runs once over the variant table
// (src/repro/conformance/align.py:align_variants).
//
// What the TPU design did and why it is not carried over: the Pallas kernel
// walks a block of 128 variants through all L layers at once, with the
// (BV, S) front in VMEM, and gathers M's column for each variant's activity
// with a one-hot (BV, S) x Mt (S, S) product on the MXU, padding S to a lane
// multiple and L to the block's longest layer.  On Hopper the column is a
// plain row read of Mt (A, S), contiguous over s, which stays in the 50 MB
// L2 (1.4 MB at S = 601), so no product is needed; and a variant stops at its
// own length instead of its block's longest, which matters because variant
// lengths are skewed (1 to 168 events on the paper-scale log).
//
// Design: one warp per variant, warps grid-striding over the variants.
// Lane l owns states s = l, l + 32, ...: it reads and writes only its own
// entries of the front, so the one exchange per layer is the warp-shuffle
// min that forms `sync` (every lane reads the old front before any lane
// writes a new one, because the shuffle completes before the write pass).
//
//   * shared-memory branch (8 warps x S x 4 B fits a block's opt-in shared
//     memory, S <= 7,264 on an H100): each warp keeps its front in its own
//     slice of dynamic shared memory;
//   * global branch (larger S): each warp keeps its front in its own slice of
//     a scratch buffer the caller allocates (grid x 8 x S floats).
//
// Arithmetic (held bit for bit against align_dp_plain and the reference's
// align_dp_numpy): f32 throughout, every update one IEEE add (__fadd_rn, so
// nothing contracts into an FMA) and one fminf, in the reference's order
// (d + 1, d + Mt, d + end).  Min is exact, so the order of the reduction
// does not change the result.  Costs must not be NaN (the wrapper checks).
//
// Bound.  Per active (variant, layer, state) the DP does two adds and two
// mins, 4 * S * sum(len) f32 operations: at the paper scale (sum(len) =
// 5.9 M, S = 601) 1.4e10 operations, 0.21 ms at the H100's 67 TFLOP/s f32
// peak (which counts an FMA as two; without FMAs the issue rate halves it).
// The bytes it must move are far less (seqs' active ids + Mt + out, ~26 MB,
// < 0.01 ms), so it is bound by operations.  This first kernel also reads
// the front from shared memory twice per layer and Mt's row from L2 once,
// which a later version could keep in registers.
//
// Interface: plain C, loaded with ctypes (no PyTorch headers).  The caller
// passes contiguous device pointers, lens clamped to [0, L], activity ids
// checked to lie in [0, A) at active positions, and the current stream, and
// checks the returned cudaError_t; the launch does not synchronize.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr float kBigCost = 1e9f;

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fminf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads) align_dp_kernel(
    const int32_t* __restrict__ seqs, const int32_t* __restrict__ lens,
    long long V, int L, const float* __restrict__ mt, int S,
    const float* __restrict__ d0, const float* __restrict__ endc,
    float* __restrict__ out, float* __restrict__ scratch) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long gwarp = static_cast<long long>(blockIdx.x) * kWarps + warp;
  const long long nwarps = static_cast<long long>(gridDim.x) * kWarps;
  float* d = kShared ? smem + static_cast<size_t>(warp) * S
                     : scratch + static_cast<size_t>(gwarp) * S;
  const float inf = __int_as_float(0x7f800000);

  for (long long v = gwarp; v < V; v += nwarps) {
    for (int s = lane; s < S; s += 32) d[s] = d0[s];
    const int len = lens[v];
    const int32_t* row = seqs + v * static_cast<long long>(L);
    for (int i = 0; i < len; ++i) {
      const int a = row[i];
      const float* mrow = mt + static_cast<size_t>(a) * S;
      float best = inf;
      for (int s = lane; s < S; s += 32)
        best = fminf(best, __fadd_rn(d[s], mrow[s]));
      const float sync = warp_min(best);
      for (int s = lane; s < S; s += 32)
        d[s] = fminf(__fadd_rn(d[s], 1.0f), s == a ? sync : kBigCost);
    }
    float fin = inf;
    for (int s = lane; s < S; s += 32)
      fin = fminf(fin, __fadd_rn(d[s], endc[s]));
    fin = warp_min(fin);
    if (lane == 0) out[v] = fin;
    __syncwarp();
  }
}

using KernelFn = void (*)(const int32_t*, const int32_t*, long long, int,
                          const float*, int, const float*, const float*,
                          float*, float*);

}  // namespace

extern "C" {

// Launch configuration for V variants over S states on this card: the grid,
// the dynamic shared-memory bytes, the branch (1 = shared memory, 0 =
// global) and, for the global branch, the scratch floats the caller must
// allocate (grid * 8 * S).  Returns a cudaError_t.
int align_dp_plan(long long V, int S, int num_sms, int* grid_out,
                  int* smem_out, int* branch_out, long long* scratch_out) {
  *grid_out = 0;
  *smem_out = 0;
  *branch_out = -1;
  *scratch_out = 0;
  if (V <= 0 || S <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;

  const long long smem_bytes =
      static_cast<long long>(kWarps) * S * static_cast<long long>(sizeof(float));
  const bool use_smem = smem_bytes <= max_smem;
  KernelFn kernel = use_smem ? &align_dp_kernel<true> : &align_dp_kernel<false>;
  const int smem = use_smem ? static_cast<int>(smem_bytes) : 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;

  long long grid = static_cast<long long>(num_sms) * per_sm;
  // no block without a variant for each of its warps to start on
  const long long by_variants = (V + kWarps - 1) / kWarps;
  if (grid > by_variants) grid = by_variants;
  if (!use_smem) {
    // keep the scratch fronts within 256 MB
    const long long per_block = static_cast<long long>(kWarps) * S * 4;
    const long long cap = (256LL << 20) / per_block;
    if (grid > cap) grid = cap;
  }
  if (grid < 1) grid = 1;
  *grid_out = static_cast<int>(grid);
  *smem_out = smem;
  *branch_out = use_smem ? 1 : 0;
  *scratch_out = use_smem ? 0 : grid * kWarps * S;
  return 0;
}

// Launch one DP with the configuration align_dp_plan returned.  `scratch`
// may be null on the shared-memory branch.  Returns the cudaError_t of the
// launch.
int align_dp_launch(const void* seqs, const void* lens, long long V, int L,
                    const void* mt, int S, const void* d0, const void* endc,
                    void* out, void* scratch, int grid, int smem, int branch,
                    void* stream) {
  if (V <= 0 || S <= 0) return 0;
  if (grid < 1 || (branch == 0 && scratch == nullptr))
    return cudaErrorInvalidValue;
  KernelFn kernel = branch == 1 ? &align_dp_kernel<true> : &align_dp_kernel<false>;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seqs), static_cast<const int32_t*>(lens), V,
      L, static_cast<const float*>(mt), S, static_cast<const float*>(d0),
      static_cast<const float*>(endc), static_cast<float*>(out),
      static_cast<float*>(scratch));
  return cudaGetLastError();
}

const char* align_dp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
