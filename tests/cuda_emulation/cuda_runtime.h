// A CPU stand-in for the parts of the CUDA runtime and device language that
// the port's plain-C kernel sources use, so that g++ can compile a kernel
// source and run it on the host (tests/test_torch_dfg_emulated.py,
// tests/test_torch_segment_count_emulated.py).
//
// A block runs as blockDim.x std::threads sharing one dynamic shared-memory
// buffer, __syncthreads() is a std::barrier, and atomics are GCC __atomic
// builtins, so the threads of a block really race as they do on the card.
// Blocks run one after another.  Device pointers are host pointers.
// Two faults of the card are caught and reported by cudaGetLastError(), as
// the card reports them: a vector load (__ldg or __ldcs of int4, uint2,
// double2, unsigned) from an address not aligned to its size, and a write
// outside the block's dynamic shared memory (guard bytes around it must be
// left as they were).
// The test rewrites the two constructs g++ cannot parse:
//   kernel<<<grid, block, smem, stream>>>(args)  ->  emu::launch(...)
//   extern __shared__ ... name[];                ->  a pointer from
//                                                    emu::dynamic_smem()
#pragma once

#include <barrier>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

// aligned to their size, as CUDA's vector types are
struct alignas(16) int4 { int x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };
struct alignas(16) double2 { double x, y; };
struct dim3 { unsigned x = 1, y = 1, z = 1; };

using cudaError_t = int;
using cudaStream_t = void*;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidConfiguration = 9;
constexpr cudaError_t cudaErrorInvalidDevice = 101;
constexpr cudaError_t cudaErrorIllegalAddress = 700;
constexpr cudaError_t cudaErrorMisalignedAddress = 716;
enum cudaDeviceAttr {
  cudaDevAttrMultiProcessorCount,
  cudaDevAttrMaxSharedMemoryPerBlockOptin,
};
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };

namespace emu {
// the emulated card: a few SMs, an H100's shared memory per block
inline int num_sms = 3;
inline int max_smem = 232448;
inline int blocks_per_sm = 2;
inline std::barrier<>* block_barrier = nullptr;
inline unsigned char* block_smem = nullptr;
inline unsigned char* dynamic_smem() { return block_smem; }
// the first fault of a launch, 0 for none (read and cleared by
// cudaGetLastError)
inline int fault = 0;
inline void raise(int err) {
  int none = 0;
  __atomic_compare_exchange_n(&fault, &none, err, false, __ATOMIC_RELAXED,
                              __ATOMIC_RELAXED);
}
}  // namespace emu

inline thread_local dim3 threadIdx;
inline thread_local dim3 blockIdx;
inline dim3 blockDim;
inline dim3 gridDim;

inline void __syncthreads() { emu::block_barrier->arrive_and_wait(); }

template <class T>
inline T __ldg(const T* p) {
  if (reinterpret_cast<uintptr_t>(p) % alignof(T) != 0)
    emu::raise(cudaErrorMisalignedAddress);
  return *p;
}
// a streaming (evict-first) load is a load like any other here
template <class T>
inline T __ldcs(const T* p) { return __ldg(p); }

inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}
inline int atomicCAS(int* p, int expected, int desired) {
  __atomic_compare_exchange_n(p, &expected, desired, false, __ATOMIC_RELAXED,
                              __ATOMIC_RELAXED);
  return expected;  // the previous value, as on the card
}

inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return cudaSuccess; }
inline cudaError_t cudaGetLastError() {
  return __atomic_exchange_n(&emu::fault, 0, __ATOMIC_RELAXED);
}
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr attr, int) {
  *v = attr == cudaDevAttrMultiProcessorCount ? emu::num_sms : emu::max_smem;
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* per_sm, F, int, size_t) {
  *per_sm = emu::blocks_per_sm;
  return cudaSuccess;
}

namespace emu {
// One launch: blocks in turn, each as `threads` racing std::threads over a
// shared-memory buffer filled with garbage (a kernel must clear its own)
// between guard bytes of the same garbage.
template <class Args>
inline void launch(void (*kernel)(Args), unsigned grid, int threads, int smem,
                   cudaStream_t, Args args) {
  constexpr int kGuard = 256;
  gridDim.x = grid;
  blockDim.x = static_cast<unsigned>(threads);
  const size_t span = static_cast<size_t>(smem) + 2 * kGuard;
  std::unique_ptr<unsigned char[]> buf(new unsigned char[span + 16]);
  unsigned char* lo = buf.get() + (16 - reinterpret_cast<uintptr_t>(buf.get()) % 16) % 16;
  unsigned char* base = lo + kGuard;
  for (unsigned b = 0; b < grid; ++b) {
    std::memset(lo, 0xA5, span);
    block_smem = base;
    std::barrier<> barrier(threads);
    block_barrier = &barrier;
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([=] {
        threadIdx.x = static_cast<unsigned>(t);
        blockIdx.x = b;
        kernel(args);
      });
    for (auto& th : pool) th.join();
    for (int g = 0; g < kGuard; ++g)
      if (lo[g] != 0xA5 || base[smem + g] != 0xA5)
        raise(cudaErrorIllegalAddress);
  }
}
}  // namespace emu

// lets a test set the emulated card before its first launch
extern "C" void emu_configure(int num_sms, int blocks_per_sm) {
  emu::num_sms = num_sms;
  emu::blocks_per_sm = blocks_per_sm;
}
