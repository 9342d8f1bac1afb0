// A CPU stand-in for the parts of the CUDA runtime and device language that
// the port's plain-C kernel sources use, so that g++ can compile a kernel
// source and run it on the host (tests/test_torch_dfg_emulated.py).
//
// A block runs as blockDim.x std::threads sharing one dynamic shared-memory
// buffer, __syncthreads() is a std::barrier, and atomics are GCC __atomic
// builtins, so the threads of a block really race as they do on the card.
// Blocks run one after another.  Device pointers are host pointers.
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

struct int4 { int x, y, z, w; };
struct uint2 { unsigned x, y; };
struct double2 { double x, y; };
struct dim3 { unsigned x = 1, y = 1, z = 1; };

using cudaError_t = int;
using cudaStream_t = void*;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidConfiguration = 9;
constexpr cudaError_t cudaErrorInvalidDevice = 101;
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
}  // namespace emu

inline thread_local dim3 threadIdx;
inline thread_local dim3 blockIdx;
inline dim3 blockDim;
inline dim3 gridDim;

inline void __syncthreads() { emu::block_barrier->arrive_and_wait(); }

template <class T>
inline T __ldg(const T* p) { return *p; }

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
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
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
// shared-memory buffer filled with garbage (a kernel must clear its own).
template <class Args>
inline void launch(void (*kernel)(Args), unsigned grid, int threads, int smem,
                   cudaStream_t, Args args) {
  gridDim.x = grid;
  blockDim.x = static_cast<unsigned>(threads);
  std::unique_ptr<unsigned char[]> buf(new unsigned char[smem + 16]);
  unsigned char* base = buf.get() + (16 - reinterpret_cast<uintptr_t>(buf.get()) % 16) % 16;
  for (unsigned b = 0; b < grid; ++b) {
    std::memset(base, 0xA5, static_cast<size_t>(smem));
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
  }
}
}  // namespace emu

// lets a test set the emulated card before its first launch
extern "C" void emu_configure(int num_sms, int blocks_per_sm) {
  emu::num_sms = num_sms;
  emu::blocks_per_sm = blocks_per_sm;
}
