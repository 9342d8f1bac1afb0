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
// (src/repro/conformance/align.py:align_variants).  The Pallas kernel walks
// blocks of 128 variants through all L layers with the (BV, S) front in
// VMEM and gathers M's column by a one-hot x Mt product on the MXU.  On
// Hopper Mt (A, S) is read by rows, contiguous over s, and stays in the
// 50 MB L2 (1.4 MB at S = 601); one warp owns one variant and stops at its
// own length (1 to 168 events on the paper-scale log).
//
// Input is ragged: the variants' ids back to back (int32, sum(len)) and
// their int64 offsets (V + 1), as the variant table holds them; no padded
// (V, L) matrix exists on the card.
//
// What bounds it.  Per active (variant, layer, state) the DP needs two f32
// adds and one min (the shuffle-min's share aside), and per (variant,
// state) one add and one min for the end: 3 * S * sum(len) + 2 * S * V
// operations, 1.10e10 at the paper scale = 0.16 ms at the H100's
// 67 TFLOP/s f32 peak (chip_smoke.py's bound).  That peak counts an FMA as
// two; an add or a min is one instruction, of which an SM issues at most
// 128 a clock (33.5e12 a second at 1,980 MHz), so the issue bound is
// twice that, and more if min issues at half rate (chip_smoke.py prints
// both).  The bytes it must move from device memory (ids, offsets, Mt,
// out: ~29 MB) take < 0.01 ms, so operations bound it on paper.  The
// design below cuts instructions and latency per (layer, state); on the
// card the Mt row reads through L1 / L2 (the same 1.4 MB table reread once
// per layer) are what is left (see the prefetch note).
//
// Three tiers, one per range of S, all in this source (align_dp_plan picks):
//
//   * registers (512 < S <= 1,024): lane l holds states l + 32k, k < K,
//     in a register array; K is a template parameter, so every state loop
//     unrolls and the front is never written to memory.  Two instances,
//     each serving 32 * KLO < S <= 32 * K, so only its slots k >= KLO can
//     lie past S and need a bounds test: K = 20 (KLO = 16), the widths of
//     every model measured (S = 601 on the paper-scale log), and K = 32
//     (KLO = 20) for the rest up to 1,024.  A smaller instance for fewer
//     states would serve no measured workload; below 513 states the shared
//     tier, whose state loop has a runtime bound, does no work past S.
//     Registers and spills of each instance are in nvcc's -Xptxas -v
//     report, which chip_smoke.py prints and checks (no instance may
//     spill; PERF.md keeps the numbers).  Blocks of 4 warps, so the card
//     fits as many warps as registers allow.
//   * shared (S <= 512, or 1,024 < S <= 7,264 on an H100): each of 8 warps
//     keeps its front in its own slice of dynamic shared memory
//     (8 x S x 4 B).
//   * global (larger S): each warp's front in its own slice of a scratch
//     buffer the caller allocates (grid x 8 x S floats).
//
// No select per state.  Every front value stays at most BIG_COST: d0, M
// and end are checked to be at most BIG_COST on the host (ops.py
// _host_tables), and RN(d + 1) <= BIG_COST for every d <= BIG_COST (RN is
// monotone and RN(1e9 + 1) = 1e9, the f32 spacing there being 64), while
// fminf(x, sync) <= x.  So for s != a, fminf(RN(d + 1), BIG_COST) ==
// RN(d + 1) bit for bit, and a layer is
//     best = min_k RN(d[k] + Mt[a, k]);  sync = warp min of best;
//     d[k] = RN(d[k] + 1) for every k;
//     d[a] = fminf(d[a], sync) in the one lane that owns state a,
// three f32 operations per state instead of four, plus an O(1) fix-up.  In
// the register tier the fix-up finds d[a >> 5] by a binary search over k on
// the warp-uniform a (log2 K uniform branches), since a register array
// takes no runtime index.  State slots past S hold +inf and read 0 for Mt
// and end, so they never win a min.  Every add is __fadd_rn, so nothing
// contracts into an FMA; a min is exact in any order, so the tree and the
// shuffle give the plain version's bits.  No lane reads another lane's
// states except through the shuffle.
//
// Mt rows off the dependent chain (register tier).  The ids of layers
// 32c .. 32c+31 sit one per lane, loaded a chunk ahead; the id of layer
// i + 1 is a shuffle, so no global load stands between two layers.  Layer i
// issues the loads of its lane's K floats of layer i + 1's Mt row
// (coalesced, 128 B per warp per k) into the second of two register
// buffers before its reduction; the loop is unrolled by two so the buffers
// swap roles without moves.  Registers, not a cp.async ring in shared
// memory: each lane consumes exactly the elements it loads, so shared
// memory would add a copy and a wait per element.  ptxas keeps the bounds-
// tested loads ahead of the reduction and places the others after the
// fix-up's branches (seen in the SASS); the 28 warps an SM holds at K = 20
// cover that latency, and pinning the loads with volatile asm was tried and
// was no faster.  What is left is bandwidth: each variant-layer reads a
// whole 2.4 KB row at S = 601 through L1 / L2 (chip_smoke.py phase 5's
// locality control times the kernel with every id one activity and with
// uniform ids beside the main path's).
//
// Work order.  Each warp takes its next variant from a global counter (one
// atomic per variant, issued a variant ahead, so the round trip overlaps
// the current variant), in input order; the launch zeroes the counter on
// the stream first.  Longest first was measured too (chip_smoke.py phase 5
// times both): it shortens the kernel's tail by a few percent, but sorting
// the 294,838 lengths on the card costs more than that, so input order is
// the one scheme kept.
//
// Interface: plain C, loaded with ctypes (no PyTorch headers).  The caller
// passes contiguous device pointers, Mt of A <= S rows, ids checked to lie
// in [0, A) (so every sync lands on a state of the front), offsets
// non-decreasing from 0 to sum(len), Mt / d0 / end at most BIG_COST and not
// NaN, and the current stream, and checks the returned cudaError_t; the
// launch does not synchronize.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMemWarps = 8;  // warps per block, shared and global tiers
constexpr int kRegWarps = 4;  // warps per block, register tier
constexpr unsigned kFull = 0xffffffffu;

enum Tier { kGlobal = 0, kShared = 1, kRegisters = 2 };

using KernelFn = void (*)(const int32_t*, const long long*, long long,
                          const float*, int, const float*, const float*,
                          float*, unsigned long long*, float*);

__device__ __forceinline__ float warp_min(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fminf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

// Lane 0 claims the warp's next variant; the claim is read (claimed) only
// when the warp needs it, so the atomic's round trip overlaps a variant.
__device__ __forceinline__ unsigned long long claim(
    unsigned long long* counter, int lane) {
  return lane == 0 ? atomicAdd(counter, 1ULL) : 0ULL;
}

__device__ __forceinline__ long long claimed(unsigned long long c) {
  return static_cast<long long>(__shfl_sync(kFull, c, 0));
}

// ---------------------------------------------------------------------------
// registers tier
// ---------------------------------------------------------------------------

// x[k] = p[32k] for the lane's K state slots (p already offset by the
// lane); slots k >= KLO past S read `pad` instead.
template <int K, int KLO>
__device__ __forceinline__ void load_slots(float (&x)[K],
                                           const float* __restrict__ p,
                                           int lane, int S, float pad) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < KLO)
      x[k] = __ldg(p + 32 * k);
    else
      x[k] = lane + 32 * k < S ? __ldg(p + 32 * k) : pad;
  }
}

// min over the K slots into t[0], as a tree (exact in any order); one
// template level per stride, so every index is a compile-time constant
template <int K, int W = 1>
__device__ __forceinline__ float slot_min(float (&t)[K]) {
  if constexpr (W < K) {
#pragma unroll
    for (int k = 0; k + W < K; k += 2 * W) t[k] = fminf(t[k], t[k + W]);
    return slot_min<K, 2 * W>(t);
  } else {
    return t[0];
  }
}

// d[ka] = fminf(d[ka], sync) in the owning lane: a binary search over the
// slots on the warp-uniform ka keeps every index a compile-time constant.
template <int K, int LO, int HI>
__device__ __forceinline__ void land(float (&d)[K], int ka, bool mine,
                                     float sync) {
  if constexpr (HI - LO == 1) {
    if (mine) d[LO] = fminf(d[LO], sync);
  } else {
    constexpr int MID = (LO + HI) / 2;
    if (ka < MID)
      land<K, LO, MID>(d, ka, mine, sync);
    else
      land<K, MID, HI>(d, ka, mine, sync);
  }
}

// One layer on activity a with its Mt row slots in m; loads layer i + 1's
// id and row slots into a and mnext meanwhile.  cur / nxt hold the ids of
// the current and the next chunk of 32 layers, one per lane (0 past len,
// which reads Mt's row 0: always present, never used).
template <int K, int KLO>
__device__ __forceinline__ void layer(float (&d)[K], const float (&m)[K],
                                      float (&mnext)[K], int& a, int i,
                                      int len, int& cur, int& nxt,
                                      const int32_t* __restrict__ vid,
                                      const float* __restrict__ mtl, int S,
                                      int lane) {
  const int i1 = i + 1;
  const int a1 = __shfl_sync(kFull, (i1 & 31) ? cur : nxt, i1 & 31);
  if ((i1 & 31) == 0) {  // warp-uniform: a chunk boundary
    cur = nxt;
    const int at = i1 + 32 + lane;
    nxt = at < len ? __ldg(vid + at) : 0;
  }
  load_slots<K, KLO>(mnext, mtl + a1 * S, lane, S, 0.0f);

  float t[K];
#pragma unroll
  for (int k = 0; k < K; ++k) t[k] = __fadd_rn(d[k], m[k]);
  const float sync = warp_min(slot_min<K>(t));
#pragma unroll
  for (int k = 0; k < K; ++k) d[k] = __fadd_rn(d[k], 1.0f);
  land<K, 0, K>(d, a >> 5, lane == (a & 31), sync);
  a = a1;
}

template <int K, int KLO>
__global__ void __launch_bounds__(kRegWarps * 32) align_dp_registers(
    const int32_t* __restrict__ ids, const long long* __restrict__ offsets,
    long long V, const float* __restrict__ mt, int S,
    const float* __restrict__ d0, const float* __restrict__ endc,
    float* __restrict__ out, unsigned long long* __restrict__ counter,
    float* /*scratch*/) {
  const int lane = threadIdx.x & 31;
  const float inf = __int_as_float(0x7f800000);
  const float* mtl = mt + lane;
  unsigned long long next = claim(counter, lane);
  for (long long v = claimed(next); v < V; v = claimed(next)) {
    next = claim(counter, lane);
    const long long beg = __ldg(offsets + v);
    const int len = static_cast<int>(__ldg(offsets + v + 1) - beg);
    const int32_t* vid = ids + beg;
    int cur = lane < len ? __ldg(vid + lane) : 0;
    int nxt = 32 + lane < len ? __ldg(vid + 32 + lane) : 0;
    int a = __shfl_sync(kFull, cur, 0);

    float d[K], ma[K], mb[K];
    load_slots<K, KLO>(d, d0 + lane, lane, S, inf);
    if (len > 0)
      load_slots<K, KLO>(ma, mtl + a * S, lane, S, 0.0f);
    for (int i = 0; i < len; i += 2) {
      layer<K, KLO>(d, ma, mb, a, i, len, cur, nxt, vid, mtl, S, lane);
      if (i + 1 >= len) break;
      layer<K, KLO>(d, mb, ma, a, i + 1, len, cur, nxt, vid, mtl, S, lane);
    }

    float t[K];
    load_slots<K, KLO>(t, endc + lane, lane, S, 0.0f);
#pragma unroll
    for (int k = 0; k < K; ++k) t[k] = __fadd_rn(d[k], t[k]);
    const float fin = warp_min(slot_min<K>(t));
    if (lane == 0) out[v] = fin;
  }
}

// The register instances: K, and KLO with 32 * KLO < S <= 32 * K.
#define ALIGN_DP_REGISTER_INSTANCES(X) X(20, 16) X(32, 20)
#define ALIGN_DP_K(K, KLO) K,
#define ALIGN_DP_KLO(K, KLO) KLO,
#define ALIGN_DP_FN(K, KLO) &align_dp_registers<K, KLO>,
constexpr int kRegKs[] = {ALIGN_DP_REGISTER_INSTANCES(ALIGN_DP_K)};
constexpr int kRegKlos[] = {ALIGN_DP_REGISTER_INSTANCES(ALIGN_DP_KLO)};
const KernelFn kRegKernels[] = {ALIGN_DP_REGISTER_INSTANCES(ALIGN_DP_FN)};
constexpr int kNumReg = sizeof(kRegKs) / sizeof(kRegKs[0]);

// ---------------------------------------------------------------------------
// shared and global tiers
// ---------------------------------------------------------------------------

template <bool kInShared>
__global__ void __launch_bounds__(kMemWarps * 32) align_dp_memory(
    const int32_t* __restrict__ ids, const long long* __restrict__ offsets,
    long long V, const float* __restrict__ mt, int S,
    const float* __restrict__ d0, const float* __restrict__ endc,
    float* __restrict__ out, unsigned long long* __restrict__ counter,
    float* __restrict__ scratch) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long gwarp = static_cast<long long>(blockIdx.x) * kMemWarps + warp;
  float* d = kInShared ? smem + static_cast<size_t>(warp) * S
                       : scratch + static_cast<size_t>(gwarp) * S;
  const float inf = __int_as_float(0x7f800000);

  unsigned long long next = claim(counter, lane);
  for (long long v = claimed(next); v < V; v = claimed(next)) {
    next = claim(counter, lane);
    const long long beg = offsets[v];
    const int len = static_cast<int>(offsets[v + 1] - beg);
    for (int s = lane; s < S; s += 32) d[s] = d0[s];
    for (int i = 0; i < len; ++i) {
      const int a = ids[beg + i];
      const float* mrow = mt + static_cast<size_t>(a) * S;
      float best = inf;
      for (int s = lane; s < S; s += 32)
        best = fminf(best, __fadd_rn(d[s], mrow[s]));
      const float sync = warp_min(best);
      for (int s = lane; s < S; s += 32) d[s] = __fadd_rn(d[s], 1.0f);
      if (lane == (a & 31)) d[a] = fminf(d[a], sync);
    }
    float fin = inf;
    for (int s = lane; s < S; s += 32)
      fin = fminf(fin, __fadd_rn(d[s], endc[s]));
    fin = warp_min(fin);
    if (lane == 0) out[v] = fin;
  }
}

KernelFn pick(int tier, int k) {
  if (tier == kRegisters) {
    for (int r = 0; r < kNumReg; ++r)
      if (kRegKs[r] == k) return kRegKernels[r];
    return nullptr;
  }
  if (tier == kShared) return &align_dp_memory<true>;
  if (tier == kGlobal) return &align_dp_memory<false>;
  return nullptr;
}

}  // namespace

extern "C" {

// Launch configuration for V variants over S states on this card: the tier
// (2 = registers, 1 = shared memory, 0 = global), the register instance's
// K (0 on the other tiers), the grid and threads per block, the dynamic
// shared-memory bytes and, for the global tier, the scratch floats the
// caller must allocate (grid * 8 * S).  Returns a cudaError_t.
int align_dp_plan(long long V, int S, int num_sms, int* tier_out, int* k_out,
                  int* grid_out, int* threads_out, int* smem_out,
                  long long* scratch_out) {
  *tier_out = -1;
  *k_out = 0;
  *grid_out = 0;
  *threads_out = 0;
  *smem_out = 0;
  *scratch_out = 0;
  if (V <= 0 || S <= 0) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;

  int tier = kGlobal, k = 0, warps = kMemWarps, smem = 0;
  for (int r = 0; r < kNumReg && k == 0; ++r)
    if (32 * kRegKlos[r] < S && S <= 32 * kRegKs[r]) k = kRegKs[r];
  if (k > 0) {
    tier = kRegisters;
    warps = kRegWarps;
  } else {
    const long long smem_bytes =
        static_cast<long long>(kMemWarps) * S * static_cast<long long>(sizeof(float));
    if (smem_bytes <= max_smem) {
      tier = kShared;
      smem = static_cast<int>(smem_bytes);
    }
  }
  KernelFn kernel = pick(tier, k);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const int threads = warps * 32;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;

  long long grid = static_cast<long long>(num_sms) * per_sm;
  // no block without a variant for each of its warps to start on
  const long long by_variants = (V + warps - 1) / warps;
  if (grid > by_variants) grid = by_variants;
  if (tier == kGlobal) {
    // keep the scratch fronts within 256 MB
    const long long per_block = static_cast<long long>(warps) * S * 4;
    const long long cap = (256LL << 20) / per_block;
    if (grid > cap) grid = cap;
  }
  if (grid < 1) grid = 1;
  *tier_out = tier;
  *k_out = k;
  *grid_out = static_cast<int>(grid);
  *threads_out = threads;
  *smem_out = smem;
  *scratch_out = tier == kGlobal ? grid * warps * S : 0;
  return 0;
}

// Launch one DP with the configuration align_dp_plan returned: zero the
// work counter (one unsigned 64-bit int) on the stream, then the kernel.
// `scratch` may be null except on the global tier.  Returns the
// cudaError_t of the launch.
int align_dp_launch(const void* ids, const void* offsets, long long V,
                    const void* mt, int S, const void* d0, const void* endc,
                    void* out, void* counter, void* scratch, int tier, int k,
                    int grid, int threads, int smem, void* stream) {
  if (V <= 0 || S <= 0) return 0;
  KernelFn kernel = pick(tier, k);
  if (kernel == nullptr || grid < 1 || counter == nullptr ||
      (tier == kGlobal && scratch == nullptr))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(counter, 0, sizeof(unsigned long long), st);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(grid), threads, smem, st>>>(
      static_cast<const int32_t*>(ids), static_cast<const long long*>(offsets),
      V, static_cast<const float*>(mt), S,
      static_cast<const float*>(d0), static_cast<const float*>(endc),
      static_cast<float*>(out), static_cast<unsigned long long*>(counter),
      static_cast<float*>(scratch));
  return cudaGetLastError();
}

const char* align_dp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
