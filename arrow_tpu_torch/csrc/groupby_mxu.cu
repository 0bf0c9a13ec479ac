// COUNT and exact SUM grouped by dense keys in [0, 4096) (kernel B5).
//
// Replaces arrow_tpu/compute/kernels/groupby_mxu.py::groupby_dense_pallas.
// Same function: over the first `n` rows, each key in [0, 4096) counts its
// rows and sums its values, read as unsigned 32- or 64-bit integers and cut
// to their low 8 x nlimb bits (the TPU kernel sums nlimb 8-bit limbs of each
// value, so a value's higher bits never reach its sum); rows whose key lies
// outside [0, 4096) add nothing.  Outputs: count (4096,) u32 and sum (4096,)
// u64, both zeroed by the caller.  The sums are exact while they stay below
// 2^64: always for 32-bit values (2^31 rows x 2^32), and for 64-bit values
// when the caller has checked rows x the largest value (the group-by's mxu
// route declines a column at 2^63 or more).
//
// What bounds it on the H100: bytes.  Each row's key and value are read once
// (8 or 12 bytes a row) and the two tables written once; the work is two or
// three shared-memory atomics a row.  The design, a privatised histogram:
//   - every block holds the whole table in dynamic shared memory:
//     4096 x (u32 count + u32 low and u32 high word of the sum) = 48 KB, so
//     four 512-thread blocks fit on an SM;
//   - a grid-stride loop over the rows with 16-byte loads of 4 keys and 4
//     values (two for 64-bit values; a scalar loop when the planes are not
//     16-byte aligned, and for the last n % 4 rows) adds each row into the
//     block's table with 32-bit shared-memory atomicAdd: the count, and the
//     value's low word into the sum's low word, whose returned old value
//     shows a wrap; the carry and the value's high word go into the high
//     word.  (A 64-bit shared atomicAdd compiles to a compare-and-swap loop
//     on sm_90, ATOMS.CAST.SPIN.64, which retries whenever lanes collide on
//     a slot; the 32-bit adds are single instructions.)
//   - at the end each block adds its non-zero slots into the global tables
//     with atomicAdd (u32 and unsigned long long, both native).
// At a handful of keys the lanes of a warp land on a few slots, and the card
// serialises one instruction's atomics on one address.  Measured on the H100
// at TPC-H Q1's four keys with 64-bit values, this design still reads 88% of
// its byte bound, against 93% for a design that sums each key in registers:
// about 0.05 ms of a 10 ms query, which does not pay for a second design.
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

// Adds a row of value `v` into slot `key` of the block's table.
__device__ __forceinline__ void add_slot(const Table& t, int key, uint32_t v) {
  atomicAdd(&t.cnt[key], 1u);
  const uint32_t old = atomicAdd(&t.lo[key], v);
  if (old + v < old) atomicAdd(&t.hi[key], 1u);  // the low word wrapped
}

__device__ __forceinline__ void add_slot(const Table& t, int key, uint64_t v) {
  atomicAdd(&t.cnt[key], 1u);
  const uint32_t lo = static_cast<uint32_t>(v);
  const uint32_t old = atomicAdd(&t.lo[key], lo);
  const uint32_t high = static_cast<uint32_t>(v >> 32) + (old + lo < old ? 1u : 0u);
  if (high) atomicAdd(&t.hi[key], high);
}

// Four rows' values from one 16-byte load (u32) or two (u64).
__device__ __forceinline__ void load4(const uint32_t* vals, size_t i, uint32_t (&v)[4]) {
  const uint4 q = reinterpret_cast<const uint4*>(vals)[i];
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}

__device__ __forceinline__ void load4(const uint64_t* vals, size_t i, uint64_t (&v)[4]) {
  const ulonglong2* p = reinterpret_cast<const ulonglong2*>(vals) + 2 * i;
  const ulonglong2 a = p[0], b = p[1];
  v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
}

template <bool kVector, typename U>
__global__ void __launch_bounds__(kThreads) dense_histogram(const int32_t* keys, const U* vals, size_t n,
                                                            U vmask, unsigned* gcnt,
                                                            unsigned long long* gsum) {
  const Table t = shared_table();
  for (int s = threadIdx.x; s < kSlots; s += kThreads) t.cnt[s] = t.lo[s] = t.hi[s] = 0;
  __syncthreads();

  auto add_row = [&](int32_t key, U v) {
    if (static_cast<uint32_t>(key) < static_cast<uint32_t>(kSlots)) add_slot(t, key, v & vmask);
  };

  const size_t stride = static_cast<size_t>(gridDim.x) * kThreads;
  const size_t tid = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  size_t done = 0;
  if (kVector) {
    const size_t n4 = n / 4;
    const int4* k4 = reinterpret_cast<const int4*>(keys);
    for (size_t i = tid; i < n4; i += stride) {
      const int4 k = k4[i];
      U v[4];
      load4(vals, i, v);
      add_row(k.x, v[0]);
      add_row(k.y, v[1]);
      add_row(k.z, v[2]);
      add_row(k.w, v[3]);
    }
    done = n4 * 4;
  }
  for (size_t i = done + tid; i < n; i += stride) add_row(keys[i], vals[i]);
  __syncthreads();

  for (int s = threadIdx.x; s < kSlots; s += kThreads) {
    const unsigned c = t.cnt[s];
    if (c) {
      atomicAdd(&gcnt[s], c);
      atomicAdd(&gsum[s], (static_cast<unsigned long long>(t.hi[s]) << 32) | t.lo[s]);
    }
  }
}

template <bool kVector, typename U>
cudaError_t launch_dense(const int32_t* keys, const U* vals, size_t n, U vmask, unsigned* cnt,
                         unsigned long long* sum, cudaStream_t s) {
  cudaError_t err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dense_histogram<kVector, U>, kThreads,
                                                           kSmemBytes)) != cudaSuccess) {
    return err;
  }
  const size_t wanted = (n + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  const size_t most = static_cast<size_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(wanted < most ? wanted : most);
  dense_histogram<kVector, U><<<blocks, kThreads, kSmemBytes, s>>>(keys, vals, n, vmask, cnt, sum);
  return cudaGetLastError();
}

template <typename U>
cudaError_t dispatch(const int32_t* k, const void* vals, size_t n, U vmask, unsigned* c,
                     unsigned long long* t, cudaStream_t s) {
  const U* v = static_cast<const U*>(vals);
  const bool aligned = (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  return aligned ? launch_dense<true>(k, v, n, vmask, c, t, s) : launch_dense<false>(k, v, n, vmask, c, t, s);
}

}  // namespace

// keys: n int32 rows; vals: n rows of val_bytes (4 or 8) bytes.  nlimb
// (1..val_bytes): values are cut to their low 8 x nlimb bits.  count: 4096
// u32, sum: 4096 u64, both zeroed by the caller.  Returns cudaGetLastError()
// of the launch.
extern "C" int arrow_groupby_dense(const void* keys, const void* vals, long long n, int val_bytes,
                                   int nlimb, void* count, void* sum, void* stream) {
  if (n < 0 || (val_bytes != 4 && val_bytes != 8) || nlimb < 1 || nlimb > val_bytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int32_t* k = static_cast<const int32_t*>(keys);
  unsigned* c = static_cast<unsigned*>(count);
  unsigned long long* t = static_cast<unsigned long long*>(sum);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bits = 8 * nlimb;
  const size_t rows = static_cast<size_t>(n);
  const cudaError_t err =
      val_bytes == 4 ? dispatch<uint32_t>(k, vals, rows, bits == 32 ? ~0u : (1u << bits) - 1u, c, t, s)
                     : dispatch<uint64_t>(k, vals, rows, bits == 64 ? ~0ull : (1ull << bits) - 1ull, c, t, s);
  return static_cast<int>(err);
}
