// COUNT and exact SUM grouped by dense keys in [0, 4096) (kernel B5).
//
// Replaces arrow_tpu/compute/kernels/groupby_mxu.py::groupby_dense_pallas.
// Same function: over the first `n` rows, each key in [0, 4096) counts its
// rows and sums its values, read as unsigned 32-bit and cut to their low
// 8 x nlimb bits (the TPU kernel sums nlimb 8-bit limbs of each value, so a
// value's higher bits never reach its sum); rows whose key lies outside
// [0, 4096) add nothing.  Outputs: count (4096,) u32 and sum (4096,) u64, both
// zeroed by the caller.  The sums are exact: 2^31 rows x 2^32 < 2^64.
//
// What bounds it on the H100: bytes.  Each row's key and value are read once
// (8 bytes a row) and the two tables written once; the work is two
// shared-memory atomics a row.  The design, a privatised histogram:
//   - every block holds the whole table in dynamic shared memory:
//     4096 x (u32 count + u32 low and u32 high word of the sum) = 48 KB, so
//     four 512-thread blocks fit on an SM;
//   - a grid-stride loop over the rows with 16-byte loads of 4 keys and 4
//     values (a scalar loop when the planes are not 16-byte aligned, and for
//     the last n % 4 rows) adds each row into the block's table with 32-bit
//     shared-memory atomicAdd: the count, and the value into the sum's low
//     word, whose returned old value shows a wrap, which adds 1 to the high
//     word.  (A 64-bit shared atomicAdd compiles to a compare-and-swap loop
//     on sm_90, ATOMS.CAST.SPIN.64, which retries whenever lanes collide on
//     a slot; the 32-bit adds are single instructions.)
//   - at the end each block adds its non-zero slots into the global tables
//     with atomicAdd (u32 and unsigned long long, both native).
//
// Not carried over from the TPU kernel: the one-hot bf16 MXU matmuls on 8-bit
// limbs, the lo16/hi16 split accumulators, the double-buffered DMA and the
// 8192-row padding with its sentinel key.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 4096;
constexpr int kThreads = 512;
constexpr int kMinRowsPerBlock = 16384;  // amortises a block's table set-up and flush
constexpr size_t kSmemBytes = 3 * kSlots * sizeof(unsigned);

// The block's table: count, and the sum's low and high words, per slot.
struct Table {
  unsigned* cnt;
  unsigned* lo;
  unsigned* hi;
};

__device__ __forceinline__ Table shared_table() {
  extern __shared__ unsigned smem[];
  return Table{smem, smem + kSlots, smem + 2 * kSlots};
}

__device__ __forceinline__ void add_row(const Table& t, int32_t key, int32_t val, uint32_t vmask) {
  if (static_cast<uint32_t>(key) < static_cast<uint32_t>(kSlots)) {
    atomicAdd(&t.cnt[key], 1u);
    const uint32_t v = static_cast<uint32_t>(val) & vmask;
    const uint32_t old = atomicAdd(&t.lo[key], v);
    if (old + v < old) atomicAdd(&t.hi[key], 1u);  // the low word wrapped
  }
}

template <bool kVector>
__global__ void __launch_bounds__(kThreads) dense_histogram(const int32_t* keys, const int32_t* vals,
                                                            size_t n, uint32_t vmask, unsigned* gcnt,
                                                            unsigned long long* gsum) {
  const Table t = shared_table();
  for (int s = threadIdx.x; s < kSlots; s += kThreads) t.cnt[s] = t.lo[s] = t.hi[s] = 0;
  __syncthreads();

  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  const size_t tid = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  size_t done = 0;
  if (kVector) {
    const size_t n4 = n / 4;
    const int4* k4 = reinterpret_cast<const int4*>(keys);
    const int4* v4 = reinterpret_cast<const int4*>(vals);
    for (size_t i = tid; i < n4; i += stride) {
      const int4 k = k4[i], v = v4[i];
      add_row(t, k.x, v.x, vmask);
      add_row(t, k.y, v.y, vmask);
      add_row(t, k.z, v.z, vmask);
      add_row(t, k.w, v.w, vmask);
    }
    done = n4 * 4;
  }
  for (size_t i = done + tid; i < n; i += stride) add_row(t, keys[i], vals[i], vmask);
  __syncthreads();

  for (int s = threadIdx.x; s < kSlots; s += kThreads) {
    const unsigned c = t.cnt[s];
    if (c) {
      atomicAdd(&gcnt[s], c);
      atomicAdd(&gsum[s], (static_cast<unsigned long long>(t.hi[s]) << 32) | t.lo[s]);
    }
  }
}

template <bool kVector>
cudaError_t launch_dense(const int32_t* keys, const int32_t* vals, size_t n, uint32_t vmask,
                         unsigned* cnt, unsigned long long* sum, cudaStream_t s) {
  cudaError_t err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dense_histogram<kVector>,
                                                           kThreads, kSmemBytes)) != cudaSuccess) {
    return err;
  }
  const size_t wanted = (n + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  const size_t most = static_cast<size_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(wanted < most ? wanted : most);
  dense_histogram<kVector><<<blocks, kThreads, kSmemBytes, s>>>(keys, vals, n, vmask, cnt, sum);
  return cudaGetLastError();
}

}  // namespace

// keys, vals: n int32 rows each.  nlimb (1..4): values are cut to their low
// 8 x nlimb bits.  count: 4096 u32, sum: 4096 u64, both zeroed by the caller.
// Returns cudaGetLastError() of the launch.
extern "C" int arrow_groupby_dense(const void* keys, const void* vals, long long n, int nlimb,
                                   void* count, void* sum, void* stream) {
  if (n < 0 || nlimb < 1 || nlimb > 4) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const uint32_t vmask = nlimb == 4 ? 0xffffffffu : (1u << (8 * nlimb)) - 1u;
  const int32_t* k = static_cast<const int32_t*>(keys);
  const int32_t* v = static_cast<const int32_t*>(vals);
  unsigned* c = static_cast<unsigned*>(count);
  unsigned long long* t = static_cast<unsigned long long*>(sum);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const cudaError_t err = aligned ? launch_dense<true>(k, v, static_cast<size_t>(n), vmask, c, t, s)
                                  : launch_dense<false>(k, v, static_cast<size_t>(n), vmask, c, t, s);
  return static_cast<int>(err);
}
