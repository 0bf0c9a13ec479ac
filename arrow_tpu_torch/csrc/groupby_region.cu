// COUNT and exact SUM grouped by keys in [0, nclass x 4096) whose rows come
// grouped by class, key >> 12 (kernel B6).
//
// Replaces arrow_tpu/compute/kernels/groupby_region.py::groupby_region_pallas.
// Same function: each key in [0, nclass x 4096) counts its rows and sums its
// values, read as unsigned 32-bit and cut to their low 8 x nlimb bits; rows
// whose key lies outside the domain add nothing.  Outputs: count
// (nclass x 4096,) u32 and sum (nclass x 4096,) u64, both zeroed by the
// caller; the sums are exact.  The caller (the partition group-by) groups the
// rows by class first; that makes the kernel fast, not right: it is right for
// any row order.
//
// What bounds it on the H100: bytes.  Each row's key and value are read once
// (8 bytes a row) and the tables written once.  The design:
//   - each block takes one contiguous range of rows, a tile of 2048 rows at a
//     time (one 16-byte load of 4 keys and 4 values per thread);
//   - it keeps one 4096-slot region table, of the class it is in, in dynamic
//     shared memory: 4096 x (u32 count + u32 low and u32 high word of the
//     sum) = 48 KB;
//   - a tile's rows of that class go into the table with 32-bit shared
//     atomics (as in groupby_mxu.cu: the low word's returned old value shows
//     a wrap, which adds 1 to the high word; a 64-bit shared atomicAdd would
//     be a compare-and-swap loop that retries on every collision); when
//     the tile's last row is of another class, the block flushes the table
//     into the global tables with atomicAdd (a class may span blocks, so a
//     flush adds, it never stores) and takes that class; rows of neither class
//     (a class boundary's few rows, or rows in no order at all) go straight to
//     the global tables with atomicAdd.
// On class-grouped rows a block flushes about once per class it crosses, and
// almost every row takes the shared-memory path.
//
// Not carried over from the TPU kernel: the one-hot bf16 MXU matmuls on 8-bit
// limbs, the lo16/hi16 split accumulators, the positional extracts by
// reduction, the DMA flushes that store (and so needed each class contiguous)
// and the garbage class 0 for padded rows (the caller passes only live rows).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlots = 4096;
constexpr int kClassShift = 12;
constexpr int kThreads = 512;
constexpr int kRowsPerThread = 4;
constexpr int kTileRows = kThreads * kRowsPerThread;
constexpr int kMinRowsPerBlock = 16384;  // amortises a block's table set-up and flush
constexpr size_t kSmemBytes = 3 * kSlots * sizeof(unsigned);

// The block's region table: count, and the sum's low and high words, per slot.
struct Table {
  unsigned* cnt;
  unsigned* lo;
  unsigned* hi;
};

// Add the table of class c into the global tables, then zero it.  Called by
// the whole block between barriers.
__device__ __forceinline__ void flush(const Table& t, int c, unsigned* gcnt, unsigned long long* gsum) {
  const size_t base = static_cast<size_t>(c) << kClassShift;
  for (int s = threadIdx.x; s < kSlots; s += kThreads) {
    const unsigned n = t.cnt[s];
    if (n) {
      atomicAdd(&gcnt[base + s], n);
      atomicAdd(&gsum[base + s], (static_cast<unsigned long long>(t.hi[s]) << 32) | t.lo[s]);
      t.cnt[s] = t.lo[s] = t.hi[s] = 0;
    }
  }
}

// Rows still pending whose class is c go into the shared table.
__device__ __forceinline__ void add_class(const Table& t, const int32_t* k, const uint32_t* v,
                                          bool* pending, int c) {
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    if (pending[j] && (k[j] >> kClassShift) == c) {
      const int slot = k[j] & (kSlots - 1);
      atomicAdd(&t.cnt[slot], 1u);
      const uint32_t old = atomicAdd(&t.lo[slot], v[j]);
      if (old + v[j] < old) atomicAdd(&t.hi[slot], 1u);  // the low word wrapped
      pending[j] = false;
    }
  }
}

template <bool kVector>
__global__ void __launch_bounds__(kThreads) region_histogram(const int32_t* keys, const int32_t* vals,
                                                             size_t n, uint32_t domain, uint32_t vmask,
                                                             size_t rows_per_block, unsigned* gcnt,
                                                             unsigned long long* gsum) {
  extern __shared__ unsigned smem[];
  const Table t{smem, smem + kSlots, smem + 2 * kSlots};
  for (int s = threadIdx.x; s < kSlots; s += kThreads) t.cnt[s] = t.lo[s] = t.hi[s] = 0;
  __syncthreads();

  const size_t begin = static_cast<size_t>(blockIdx.x) * rows_per_block;
  const size_t end = begin + rows_per_block < n ? begin + rows_per_block : n;
  int cur = -1;  // the class the shared table holds (the same in every thread)
  for (size_t t0 = begin; t0 < end; t0 += kTileRows) {
    int32_t k[kRowsPerThread];
    uint32_t v[kRowsPerThread];
    bool pending[kRowsPerThread];
    const size_t r = t0 + static_cast<size_t>(threadIdx.x) * kRowsPerThread;
    if (kVector && r + kRowsPerThread <= end) {
      const int4 k4 = *reinterpret_cast<const int4*>(keys + r);
      const int4 v4 = *reinterpret_cast<const int4*>(vals + r);
      k[0] = k4.x, k[1] = k4.y, k[2] = k4.z, k[3] = k4.w;
      v[0] = v4.x, v[1] = v4.y, v[2] = v4.z, v[3] = v4.w;
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) pending[j] = static_cast<uint32_t>(k[j]) < domain;
    } else {
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const bool live = r + j < end;
        k[j] = live ? keys[r + j] : -1;
        v[j] = live ? static_cast<uint32_t>(vals[r + j]) : 0u;
        pending[j] = live && static_cast<uint32_t>(k[j]) < domain;
      }
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) v[j] &= vmask;

    add_class(t, k, v, pending, cur);
    // the class of the tile's last row is the one likely to run on
    const size_t last = (t0 + kTileRows < end ? t0 + kTileRows : end) - 1;
    const int32_t klast = keys[last];
    const int next = static_cast<uint32_t>(klast) < domain ? klast >> kClassShift : -1;
    if (next >= 0 && next != cur) {  // the same branch in every thread
      __syncthreads();
      if (cur >= 0) flush(t, cur, gcnt, gsum);
      __syncthreads();
      cur = next;
      add_class(t, k, v, pending, cur);
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      if (pending[j]) {
        atomicAdd(&gcnt[k[j]], 1u);
        atomicAdd(&gsum[k[j]], static_cast<unsigned long long>(v[j]));
      }
    }
  }
  __syncthreads();
  if (cur >= 0) flush(t, cur, gcnt, gsum);
}

template <bool kVector>
cudaError_t launch_region(const int32_t* keys, const int32_t* vals, size_t n, uint32_t domain,
                          uint32_t vmask, unsigned* cnt, unsigned long long* sum, cudaStream_t s) {
  cudaError_t err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) {
    return err;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, region_histogram<kVector>,
                                                           kThreads, kSmemBytes)) != cudaSuccess) {
    return err;
  }
  const size_t wanted = (n + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  const size_t most = static_cast<size_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const size_t blocks = wanted < most ? wanted : most;
  // whole tiles per block, so every 16-byte load stays aligned
  const size_t tiles = (n + kTileRows - 1) / kTileRows;
  const size_t rows_per_block = ((tiles + blocks - 1) / blocks) * kTileRows;
  const int grid = static_cast<int>((n + rows_per_block - 1) / rows_per_block);
  region_histogram<kVector><<<grid, kThreads, kSmemBytes, s>>>(keys, vals, n, domain, vmask,
                                                               rows_per_block, cnt, sum);
  return cudaGetLastError();
}

}  // namespace

// keys, vals: n int32 rows each.  nclass (1..1024): the key domain is
// [0, nclass x 4096).  nlimb (1..4): values are cut to their low 8 x nlimb
// bits.  count: nclass x 4096 u32, sum: nclass x 4096 u64, both zeroed by the
// caller.  Returns cudaGetLastError() of the launch.
extern "C" int arrow_groupby_region(const void* keys, const void* vals, long long n, int nlimb,
                                    int nclass, void* count, void* sum, void* stream) {
  if (n < 0 || nlimb < 1 || nlimb > 4 || nclass < 1 || nclass > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const uint32_t vmask = nlimb == 4 ? 0xffffffffu : (1u << (8 * nlimb)) - 1u;
  const uint32_t domain = static_cast<uint32_t>(nclass) << kClassShift;
  const int32_t* k = static_cast<const int32_t*>(keys);
  const int32_t* v = static_cast<const int32_t*>(vals);
  unsigned* c = static_cast<unsigned*>(count);
  unsigned long long* t = static_cast<unsigned long long*>(sum);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t rows = static_cast<size_t>(n);
  const bool aligned = (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const cudaError_t err = aligned ? launch_region<true>(k, v, rows, domain, vmask, c, t, s)
                                  : launch_region<false>(k, v, rows, domain, vmask, c, t, s);
  return static_cast<int>(err);
}
