// The few CUDA features of arrow_tpu_torch/csrc/take_columns.cu and
// groupby_mxu.cu, emulated on the host, so that the CPU tests can build those
// sources with g++ (as cuda_runtime.h) and run their kernels: a warp is 32
// std::threads, which meet at a barrier in each __ballot_sync.  The tests
// rewrite each launch
// `kernel<<<blocks, threads, smem, stream>>>(args)`:
//   - as `emulate_launch(blocks, threads, [&] { kernel(args); })` for a
//     kernel without shared memory: blocks and warps run one after another;
//   - as `emulate_block_launch(blocks, threads, [&] { kernel(args); })` for
//     one with __syncthreads and shared memory: the threads of a block run
//     together, meet at a barrier in each __syncthreads, and share
//     `shim_shared` (the kernel's `extern __shared__` array, which the test
//     rewrites as a pointer to it); blocks run one after another.
#pragma once
#include <stddef.h>
#include <stdint.h>

#include <barrier>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __grid_constant__

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorMisalignedAddress = 74 };

struct int4 { int x, y, z, w; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
struct ulonglong2 { unsigned long long x, y; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return {a, b, c, d}; }
inline ulonglong2 make_ulonglong2(unsigned long long a, unsigned long long b) { return {a, b}; }
template <typename T>
T __ldg(const T* p) { return *p; }

struct Index { unsigned x; };
inline thread_local Index blockIdx, threadIdx, gridDim;

struct Warp {
  std::barrier<> meet{32};
  unsigned vote[32];
};
inline thread_local Warp* this_warp;

inline unsigned __ballot_sync(unsigned, int pred) {
  Warp& w = *this_warp;
  w.vote[threadIdx.x % 32] = pred ? 1u : 0u;
  w.meet.arrive_and_wait();
  unsigned out = 0;
  for (int lane = 0; lane < 32; ++lane) out |= w.vote[lane] << lane;
  w.meet.arrive_and_wait();  // every lane has read the votes before the next ballot writes them
  return out;
}

template <typename T>
T atomicAdd(T* address, T value) {
  return __atomic_fetch_add(address, value, __ATOMIC_RELAXED);
}

inline cudaError_t cudaGetLastError() { return cudaSuccess; }

enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* device) { *device = 0; return cudaSuccess; }
// two SMs of one block each: a grid-stride loop visits more than one block
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) { *value = 2; return cudaSuccess; }
template <typename Kernel>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, Kernel, int, size_t) {
  *blocks = 1;
  return cudaSuccess;
}

alignas(16) inline unsigned shim_shared[3 * 4096];
inline thread_local std::barrier<>* this_block;
inline void __syncthreads() { this_block->arrive_and_wait(); }

template <typename Body>
void emulate_block_launch(unsigned blocks, int threads, Body body) {
  for (unsigned b = 0; b < blocks; ++b) {
    std::barrier<> block(threads);
    std::vector<Warp> warps(threads / 32);
    std::vector<std::thread> lanes;
    for (int t = 0; t < threads; ++t) {
      lanes.emplace_back([&, b, t] {
        blockIdx.x = b;
        gridDim.x = blocks;
        threadIdx.x = t;
        this_warp = &warps[t / 32];
        this_block = &block;
        body();
      });
    }
    for (auto& t : lanes) t.join();
  }
}

template <typename Body>
void emulate_launch(unsigned blocks, int threads, Body body) {
  for (unsigned b = 0; b < blocks; ++b) {
    for (int first = 0; first < threads; first += 32) {
      Warp warp;
      std::vector<std::thread> lanes;
      for (int lane = 0; lane < 32; ++lane) {
        lanes.emplace_back([&, b, first, lane] {
          blockIdx.x = b;
          threadIdx.x = first + lane;
          this_warp = &warp;
          body();
        });
      }
      for (auto& t : lanes) t.join();
    }
  }
}
