// Stable LSD radix sort of up to 8 planes by plane 0 (kernels B3 and B4).
//
// Replaces arrow_tpu/compute/kernels/radix.py::_radix_pass_call (B3, the
// 1-bit two-stream split pass, via radix_sort_chain[_parts]) and
// ::_radix4_pass_call / _radix4_multipass_call (B4, the 2-bit four-stream
// pass).  Same contract as the chain: every plane is reordered by a stable
// sort on the digits of plane 0, least significant digit first, so the chain
// over the significant digits is a stable sort by the key.  The digit width
// is a template parameter: 1 is B3's pass, 2 is B4's, 8 is the default chain.
// Plane 0 is an unsigned-order key code of 4 or 8 bytes; the other planes are
// payloads of 4 or 8 bytes, moved as raw bits.  Only the first n rows are
// sorted.
//
// What bounds it on the H100: bytes.  A pass reads the key twice more than
// the other planes (the histogram and the ranking) and reads and writes every
// plane once: about (2 x planes x width + 2 x key width) x n bytes per pass,
// with a small digit table.  The design keeps the reads coalesced and spends no pass on
// anything but the digits that hold a significant bit (the caller picks
// them; arrow_radix_or_and gives the OR ^ AND mask of the keys):
//   1. radix_histogram: one block per 4096-row tile counts the tile's digits
//      in shared memory (one shared atomic per run of equal digits in a warp)
//      and writes them digit-major, table[digit * ntiles + tile];
//   2. radix_scan_rows: one block per digit turns its row of the table into
//      exclusive tile offsets and writes the digit's total;
//   3. radix_scatter: each tile scans the digit totals into digit bases and
//      its own digit counts into its digits' first sorted positions, then
//      ranks its rows in 16 rounds of 256, warp by warp in order.  A lane's
//      rank among its warp's equal digits comes from __match_any_sync (8-bit
//      digits) or __ballot_sync per digit bit (1- and 2-bit digits) and
//      __popc; per-warp digit counts in shared memory give each warp's
//      offset, so equal digits keep their input order.  The ranks build the
//      tile's sorted order in shared memory; the tile is then written in that
//      order, consecutive threads to consecutive output rows of a digit, so
//      the writes coalesce into runs (8-bit digits wrote one row at a time
//      when each row went straight to its place).
// Passes ping-pong between two buffer sets that the wrapper allocates once
// per sort.  Index arithmetic is 64-bit; counts are int32 (n < 2^31).
//
// Not carried over from the TPU kernel: the stitched S/U stream read, the
// stream parts and their combine, the hole-filling row network, the
// searchsorted lane gather, the dispatch chunking and the 8192-row padding.
// A onesweep decoupled look-back pass and shared-memory staging of the
// scattered writes are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;  // rows per tile
constexpr int kScanThreads = 1024;
constexpr int kMaxPlanes = 8;
constexpr unsigned kFull = 0xffffffffu;

struct Planes {
  const void* in[kMaxPlanes];
  void* out[kMaxPlanes];
  int wide[kMaxPlanes];  // 1: 8-byte elements, 0: 4-byte
  int count;
};

__device__ __forceinline__ uint64_t load_key(const void* p, size_t i, int wide) {
  return wide ? static_cast<const uint64_t*>(p)[i]
              : static_cast<uint64_t>(static_cast<const uint32_t*>(p)[i]);
}

__device__ __forceinline__ int warp_inclusive_sum(int x, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Lanes of the warp whose digit equals this lane's.  Every lane calls it;
// lanes without a row pass a digit of (1 << BITS) and are masked out by the
// caller with the ballot of valid lanes.
template <int BITS>
__device__ __forceinline__ unsigned peers_of(unsigned d) {
  if (BITS == 8) return __match_any_sync(kFull, d);
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b < BITS; ++b) {
    const unsigned bit = (d >> b) & 1u;
    const unsigned ones = __ballot_sync(kFull, bit);
    peers &= bit ? ones : ~ones;
  }
  return peers;
}

template <int BITS>
__global__ void radix_histogram(const void* key, int key_wide, uint64_t key_mask, size_t n,
                                int shift, int ntiles, int* table) {
  constexpr int R = 1 << BITS;
  __shared__ int counts[R];
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < R; i += kThreads) counts[i] = 0;
  __syncthreads();
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile;
  for (int r = 0; r < kItems; ++r) {
    const size_t i = base + static_cast<size_t>(r) * kThreads + threadIdx.x;
    const bool valid = i < n;
    const unsigned d =
        valid ? static_cast<unsigned>(((load_key(key, i, key_wide) & key_mask) >> shift) & (R - 1))
              : R;
    const unsigned peers = peers_of<BITS>(d) & __ballot_sync(kFull, valid);
    if (valid && __ffs(peers) - 1 == lane) atomicAdd(&counts[d], __popc(peers));
  }
  __syncthreads();
  for (int d = threadIdx.x; d < R; d += kThreads) {
    table[static_cast<size_t>(d) * ntiles + blockIdx.x] = counts[d];
  }
}

// One block per digit: that digit's tile counts -> exclusive tile offsets;
// totals[digit] = the digit's count over all tiles.
__global__ void radix_scan_rows(const int* counts, int* offsets, int ntiles, int* totals) {
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int* row = counts + static_cast<size_t>(blockIdx.x) * ntiles;
  int* out = offsets + static_cast<size_t>(blockIdx.x) * ntiles;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < ntiles; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < ntiles ? row[i] : 0;
    const int x = warp_inclusive_sum(v, lane);
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) warp_sums[lane] = warp_inclusive_sum(warp_sums[lane], lane);
    __syncthreads();
    const int incl = carry + (warp ? warp_sums[warp - 1] : 0) + x;
    if (i < ntiles) out[i] = incl - v;
    __syncthreads();  // every thread has read carry and warp_sums
    if (threadIdx.x == kScanThreads - 1) carry = incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// Exclusive sum of one value per thread over the block (kThreads threads).
__device__ __forceinline__ int block_exclusive_sum(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = warp_inclusive_sum(v, lane);
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  __syncthreads();  // warp_sums is free for the next call
  return before + x - v;
}

__device__ __forceinline__ void move_row(const Planes& planes, size_t src, size_t dst) {
  for (int p = 0; p < planes.count; ++p) {
    if (planes.wide[p]) {
      static_cast<uint64_t*>(planes.out[p])[dst] = static_cast<const uint64_t*>(planes.in[p])[src];
    } else {
      static_cast<uint32_t*>(planes.out[p])[dst] = static_cast<const uint32_t*>(planes.in[p])[src];
    }
  }
}

template <int BITS>
__global__ void radix_scatter(Planes planes, uint64_t key_mask, size_t n, int shift, int ntiles,
                              const int* counts, const int* offsets, const int* totals) {
  constexpr int R = 1 << BITS;
  static_assert(R <= kThreads, "one thread per digit");
  __shared__ int tile_start[R];         // the tile's first sorted position of each digit
  __shared__ int out_base[R];           // the output row of that position
  __shared__ int running[R];            // next sorted position of each digit in the tile
  __shared__ int warp_base[kWarps][R];  // per round: each warp's first position per digit
  __shared__ int warp_sums[kWarps];
  __shared__ unsigned short order[kTile];  // sorted position -> row of the tile
  __shared__ unsigned char digit_at[kTile];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // per digit (one a thread): global base = digits below it over all rows +
  // this digit in earlier tiles; tile start = digits below it in this tile
  const bool own = threadIdx.x < R;
  const size_t cell = static_cast<size_t>(threadIdx.x) * ntiles + blockIdx.x;
  const int digit_base = block_exclusive_sum(own ? totals[threadIdx.x] : 0, warp_sums);
  const int start = block_exclusive_sum(own ? counts[cell] : 0, warp_sums);
  if (own) {
    tile_start[threadIdx.x] = start;
    running[threadIdx.x] = start;
    out_base[threadIdx.x] = digit_base + offsets[cell];
  }

  // rank the tile's rows: stable by digit, warp by warp in order
  const int wide0 = planes.wide[0];
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile;
  const unsigned below = (1u << lane) - 1u;
  for (int r = 0; r < kItems; ++r) {
    for (int i = threadIdx.x; i < kWarps * R; i += kThreads) (&warp_base[0][0])[i] = 0;
    __syncthreads();
    const int row = r * kThreads + threadIdx.x;
    const size_t i = base + row;
    const bool valid = i < n;
    const unsigned d =
        valid ? static_cast<unsigned>(((load_key(planes.in[0], i, wide0) & key_mask) >> shift) &
                                      (R - 1))
              : R;
    const unsigned peers = peers_of<BITS>(d) & __ballot_sync(kFull, valid);
    if (valid && __ffs(peers) - 1 == lane) warp_base[warp][d] = __popc(peers);
    __syncthreads();
    if (own) {  // warp counts -> warp bases, in warp order
      int run = running[threadIdx.x];
      for (int w = 0; w < kWarps; ++w) {
        const int c = warp_base[w][threadIdx.x];
        warp_base[w][threadIdx.x] = run;
        run += c;
      }
      running[threadIdx.x] = run;
    }
    __syncthreads();
    if (valid) {
      const int pos = warp_base[warp][d] + __popc(peers & below);
      order[pos] = static_cast<unsigned short>(row);
      digit_at[pos] = static_cast<unsigned char>(d);
    }
    __syncthreads();  // warp_base is cleared at the top of the next round
  }

  // write in sorted order: consecutive threads, consecutive output rows
  const int rows = n - base < static_cast<size_t>(kTile) ? static_cast<int>(n - base) : kTile;
  for (int q = threadIdx.x; q < rows; q += kThreads) {
    const int d = digit_at[q];
    move_row(planes, base + order[q], static_cast<size_t>(out_base[d]) + (q - tile_start[d]));
  }
}

__global__ void radix_or_and(const void* key, int wide, size_t n, unsigned long long* out) {
  unsigned long long o = 0ull, a = ~0ull;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n; i += stride) {
    const unsigned long long k = load_key(key, i, wide);
    o |= k;
    a &= k;
  }
  for (int d = 16; d > 0; d >>= 1) {
    o |= __shfl_down_sync(kFull, o, d);
    a &= __shfl_down_sync(kFull, a, d);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicOr(&out[0], o);
    atomicAnd(&out[1], a);
  }
}

int ntiles_for(long long n) { return static_cast<int>((n + kTile - 1) / kTile); }

template <int BITS>
cudaError_t run_passes(const Planes& first, void* const* buf_a, void* const* buf_b,
                       uint64_t key_mask, size_t n, const int* shifts, int npasses, int* counts,
                       int* offsets, int* totals, cudaStream_t s) {
  const int ntiles = ntiles_for(static_cast<long long>(n));
  Planes planes = first;
  for (int p = 0; p < npasses; ++p) {
    for (int q = 0; q < planes.count; ++q) {
      if (p > 0) planes.in[q] = (p % 2 == 1) ? buf_a[q] : buf_b[q];
      planes.out[q] = (p % 2 == 0) ? buf_a[q] : buf_b[q];
    }
    radix_histogram<BITS><<<ntiles, kThreads, 0, s>>>(planes.in[0], planes.wide[0], key_mask, n,
                                                      shifts[p], ntiles, counts);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    radix_scan_rows<<<1 << BITS, kScanThreads, 0, s>>>(counts, offsets, ntiles, totals);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    radix_scatter<BITS><<<ntiles, kThreads, 0, s>>>(planes, key_mask, n, shifts[p], ntiles,
                                                    counts, offsets, totals);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Bytes of digit-table scratch a sort of n rows at `digit_bits` needs.
extern "C" long long arrow_radix_scratch_bytes(long long n, int digit_bits) {
  const long long ntiles = n > 0 ? ntiles_for(n) : 1;
  const long long r = 1LL << digit_bits;
  return (2 * r * ntiles + r) * static_cast<long long>(sizeof(int));
}

// out: two device u64, set to the OR and the AND of the first n keys
// (4- or 8-byte, zero-extended).  Returns cudaGetLastError() of the launch.
extern "C" int arrow_radix_or_and(const void* key, int wide, long long n, void* out, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  cudaError_t err = cudaMemsetAsync(o, 0, sizeof(unsigned long long), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(o + 1, 0xff, sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return static_cast<int>(cudaSuccess);
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 1024) blocks = 1024;
  radix_or_and<<<static_cast<int>(blocks), kThreads, 0, s>>>(key, wide, static_cast<size_t>(n), o);
  return static_cast<int>(cudaGetLastError());
}

// in: `nplanes` host pointers to the input planes (not written); buf_a,
// buf_b: two buffer sets of the same shapes; wide: 1 for 8-byte planes, 0 for
// 4-byte.  Pass p sorts by the digit at bit shifts[p] of plane 0 AND key_mask
// (the bits the sort is by; the others read as 0): pass 0 reads
// `in` and writes buf_a, then passes alternate buf_a -> buf_b -> buf_a, so the
// sorted planes are in buf_a when npasses is odd and in buf_b when it is even.
// scratch: arrow_radix_scratch_bytes(n, digit_bits) bytes.  Returns
// cudaGetLastError() of the launches.
extern "C" int arrow_radix_sort(const void* const* in, void* const* buf_a, void* const* buf_b,
                                const int* wide, int nplanes, long long n,
                                unsigned long long key_mask, const int* shifts, int npasses,
                                int digit_bits, void* scratch, void* stream) {
  if (nplanes < 1 || nplanes > kMaxPlanes || n < 0 || n >= (1LL << 31) || npasses < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int key_bits = wide[0] ? 64 : 32;
  for (int p = 0; p < npasses; ++p) {
    if (shifts[p] < 0 || shifts[p] + digit_bits > key_bits) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (n == 0 || npasses == 0) return static_cast<int>(cudaSuccess);
  Planes planes;
  planes.count = nplanes;
  for (int p = 0; p < nplanes; ++p) {
    planes.in[p] = in[p];
    planes.out[p] = nullptr;
    planes.wide[p] = wide[p] ? 1 : 0;
  }
  const int ntiles = ntiles_for(n);
  int* counts = static_cast<int*>(scratch);
  int* offsets = counts + (static_cast<size_t>(1) << digit_bits) * ntiles;
  int* totals = offsets + (static_cast<size_t>(1) << digit_bits) * ntiles;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t rows = static_cast<size_t>(n);
  cudaError_t err;
  switch (digit_bits) {
    case 1:
      err = run_passes<1>(planes, buf_a, buf_b, key_mask, rows, shifts, npasses, counts, offsets,
                           totals, s);
      break;
    case 2:
      err = run_passes<2>(planes, buf_a, buf_b, key_mask, rows, shifts, npasses, counts, offsets,
                           totals, s);
      break;
    case 8:
      err = run_passes<8>(planes, buf_a, buf_b, key_mask, rows, shifts, npasses, counts, offsets,
                           totals, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
