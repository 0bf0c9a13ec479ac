// Stable multi-plane compaction by one packed selection mask (kernel B1).
//
// Replaces arrow_tpu/compute/kernels/compaction3.py::compact_multi_pallas
// (the Pallas kernel built by `_make_kernel`).  Same function: every selected
// row of every plane moves, in order, to the front of that plane's output;
// output rows at and past the count are zero; the count is returned.
// Planes are 4- or 8-byte value planes (moved as raw bits, any dtype) or
// packed LSB-first bitmap planes, which come out unpacked as 0/1 int32, as in
// the JAX kernel.  Any n >= 0 is taken: there is no padding requirement.
//
// What bounds it on the H100: bytes.  Each plane is read once and its output
// written once, about 2 x planes x width x n bytes, plus n/8 bytes of mask;
// the arithmetic is one popcount per 32 rows.  The design keeps every global
// access coalesced and adds no pass over the data:
//   1. tile_counts: one block per 8192-row tile; each thread popcounts one
//      mask word; a block reduction gives the tile's count;
//   2. scan_tile_counts: one block turns the tile counts into exclusive tile
//      offsets and writes the total count;
//   3. scatter_tiles: each tile recomputes its word offsets (one mask word per
//      thread, a warp shuffle scan and a shared-memory scan of the warp sums),
//      then warp w moves word k's 32 rows: lane = bit, so the reads are 32
//      consecutive rows and the writes land at consecutive ranks
//      (popc of the word below the lane).  The same launch zeroes the tile's
//      output rows that lie at or past the count; those never overlap a
//      compacted row, which always lies below the count.
// Index arithmetic is 64-bit; counts are int32 (n < 2^31).
//
// Not carried over from the TPU kernel: the 3-slot VMEM windows, the MXU rank
// matmuls, the hole-filling row network, the (8,128) tiling, the sequential
// grid carry and the 8192-row padding.  A decoupled look-back single pass is
// later work.
//
// The same file holds the dual-output split (kernel B8), which replaces
// arrow_tpu/compute/kernels/compaction3.py::split_multi_pallas
// (`_make_split_kernel`): up to 8 planes of 4-byte rows, each read once, go
// stably to two outputs, the selected rows to the front of one and the others
// to the front of the other; the rows past each output's count are zero.  The
// selection is a packed mask or, computed in the kernel as on the TPU, the
// rows whose plane-0 bit `bit` is zero.  It is B1's three launches with two
// changes: a tile's selection words come from the mask or from warp ballots
// over plane 0 (one coalesced 128-byte read per word), and the scatter sends
// an unselected row i, whose selected rank is r, to row i - r of the second
// output.  Bound by bytes: 4n read and 8n written per plane, plus n/8 of mask.
// B9 (arrow_tpu/compute/kernels/compaction.py::compact_pallas, one 32-bit
// plane) is a one-plane call of arrow_compact_multi.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWordsPerTile = kThreads;  // one mask word per thread
constexpr int kRowsPerTile = kWordsPerTile * 32;
constexpr int kScanThreads = 1024;
constexpr int kMaxPlanes = 16;
constexpr unsigned kFull = 0xffffffffu;

enum PlaneKind : int { kValue4 = 0, kValue8 = 1, kPackedWords = 2 };

struct Planes {
  const void* in[kMaxPlanes];
  void* out[kMaxPlanes];
  int kind[kMaxPlanes];
  int count;
};

// Mask word w with the bits at rows >= n cleared.
__device__ __forceinline__ uint32_t mask_word(const uint32_t* mask, size_t w, size_t n) {
  const size_t first = w * 32;
  if (first >= n) return 0u;
  uint32_t word = mask[w];
  if (n - first < 32) word &= (1u << (n - first)) - 1u;
  return word;
}

__device__ __forceinline__ int warp_inclusive_sum(int x, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

__global__ void tile_counts(const uint32_t* mask, size_t n, int* tile_count) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t w = static_cast<size_t>(blockIdx.x) * kWordsPerTile + threadIdx.x;
  int c = __popc(mask_word(mask, w, n));
  for (int d = 16; d > 0; d >>= 1) c += __shfl_down_sync(kFull, c, d);
  if (lane == 0) warp_sums[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int i = 0; i < kWarps; ++i) total += warp_sums[i];
    tile_count[blockIdx.x] = total;
  }
}

// In place: tile counts -> exclusive tile offsets; *count_out = total.
__global__ void scan_tile_counts(int* tile_offset, int ntiles, int* count_out) {
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int carry;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < ntiles; base += kScanThreads) {
    const int i = base + threadIdx.x;
    const int v = i < ntiles ? tile_offset[i] : 0;
    const int x = warp_inclusive_sum(v, lane);
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) warp_sums[lane] = warp_inclusive_sum(warp_sums[lane], lane);
    __syncthreads();
    const int incl = carry + (warp ? warp_sums[warp - 1] : 0) + x;
    if (i < ntiles) tile_offset[i] = incl - v;
    __syncthreads();  // every thread has read carry and warp_sums
    if (threadIdx.x == kScanThreads - 1) carry = incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) *count_out = carry;
}

__device__ __forceinline__ void move_row(const Planes& planes, size_t src, size_t dst) {
  for (int p = 0; p < planes.count; ++p) {
    switch (planes.kind[p]) {
      case kValue4:
        static_cast<uint32_t*>(planes.out[p])[dst] =
            static_cast<const uint32_t*>(planes.in[p])[src];
        break;
      case kValue8:
        static_cast<uint64_t*>(planes.out[p])[dst] =
            static_cast<const uint64_t*>(planes.in[p])[src];
        break;
      default: {
        const uint32_t word = static_cast<const uint32_t*>(planes.in[p])[src >> 5];
        static_cast<int32_t*>(planes.out[p])[dst] = static_cast<int32_t>((word >> (src & 31)) & 1u);
      }
    }
  }
}

__global__ void scatter_tiles(Planes planes, const uint32_t* mask, size_t n,
                              const int* tile_offset, const int* count) {
  __shared__ uint32_t words[kWordsPerTile];
  __shared__ int word_offset[kWordsPerTile];
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t tile = blockIdx.x;
  const size_t w0 = tile * kWordsPerTile;

  // exclusive output offset of each mask word of the tile
  const uint32_t word = mask_word(mask, w0 + threadIdx.x, n);
  const int c = __popc(word);
  const int x = warp_inclusive_sum(c, lane);
  if (lane == 31) warp_sums[warp] = x;
  words[threadIdx.x] = word;
  __syncthreads();
  int before = tile_offset[tile];
  for (int i = 0; i < warp; ++i) before += warp_sums[i];
  word_offset[threadIdx.x] = before + x - c;
  __syncthreads();

  // warp w moves words w, w + kWarps, ...: 32 consecutive rows per step
  const uint32_t below = (1u << lane) - 1u;
  for (int k = warp; k < kWordsPerTile; k += kWarps) {
    const uint32_t wd = words[k];
    if (!((wd >> lane) & 1u)) continue;
    const size_t src = (w0 + k) * 32 + lane;
    const size_t dst = static_cast<size_t>(word_offset[k]) + __popc(wd & below);
    move_row(planes, src, dst);
  }

  // zero this tile's output rows in [count, n)
  const size_t total = static_cast<size_t>(*count);
  const size_t r0 = tile * kRowsPerTile;
  const size_t r1 = r0 + kRowsPerTile < n ? r0 + kRowsPerTile : n;
  const size_t z0 = r0 > total ? r0 : total;
  for (int p = 0; p < planes.count; ++p) {
    for (size_t r = z0 + threadIdx.x; r < r1; r += kThreads) {
      if (planes.kind[p] == kValue8) {
        static_cast<uint64_t*>(planes.out[p])[r] = 0;
      } else {
        static_cast<uint32_t*>(planes.out[p])[r] = 0;
      }
    }
  }
}

// ---- the dual-output split (B8) ---------------------------------------------

constexpr int kMaxSplitPlanes = 8;

struct SplitPlanes {
  const uint32_t* in[kMaxSplitPlanes];
  uint32_t* sel[kMaxSplitPlanes];
  uint32_t* unsel[kMaxSplitPlanes];
  int count;
};

// The tile's selection words into shared memory (then a barrier): mask words,
// or the rows of plane 0 whose bit `bit` is zero, one warp ballot per word.
template <bool kFromBit>
__device__ __forceinline__ void tile_words(const uint32_t* mask, const uint32_t* plane0, int bit,
                                           size_t w0, size_t n, uint32_t* words) {
  if (!kFromBit) {
    words[threadIdx.x] = mask_word(mask, w0 + threadIdx.x, n);
  } else {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int k = warp; k < kWordsPerTile; k += kWarps) {
      const size_t row = (w0 + k) * 32 + lane;
      const bool selected = row < n && !((plane0[row] >> bit) & 1u);
      const uint32_t word = __ballot_sync(kFull, selected);
      if (lane == 0) words[k] = word;
    }
  }
  __syncthreads();
}

template <bool kFromBit>
__global__ void split_counts(const uint32_t* mask, const uint32_t* plane0, int bit, size_t n,
                             int* tile_count) {
  __shared__ uint32_t words[kWordsPerTile];
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  tile_words<kFromBit>(mask, plane0, bit, static_cast<size_t>(blockIdx.x) * kWordsPerTile, n, words);
  int c = __popc(words[threadIdx.x]);
  for (int d = 16; d > 0; d >>= 1) c += __shfl_down_sync(kFull, c, d);
  if (lane == 0) warp_sums[warp] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int i = 0; i < kWarps; ++i) total += warp_sums[i];
    tile_count[blockIdx.x] = total;
  }
}

template <bool kFromBit>
__global__ void split_tiles(SplitPlanes planes, const uint32_t* mask, int bit, size_t n,
                            const int* tile_offset, const int* count) {
  __shared__ uint32_t words[kWordsPerTile];
  __shared__ int word_offset[kWordsPerTile];
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t tile = blockIdx.x;
  const size_t w0 = tile * kWordsPerTile;
  tile_words<kFromBit>(mask, planes.in[0], bit, w0, n, words);

  // selected rows before each mask word of the tile
  const uint32_t word = words[threadIdx.x];
  const int c = __popc(word);
  const int x = warp_inclusive_sum(c, lane);
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = tile_offset[tile];
  for (int i = 0; i < warp; ++i) before += warp_sums[i];
  word_offset[threadIdx.x] = before + x - c;
  __syncthreads();

  // warp w moves words w, w + kWarps, ...: row i goes to its selected rank r
  // in the first output, or to i - r in the second
  const uint32_t below = (1u << lane) - 1u;
  for (int k = warp; k < kWordsPerTile; k += kWarps) {
    const size_t src = (w0 + k) * 32 + lane;
    if (src >= n) continue;
    const uint32_t wd = words[k];
    const size_t r = static_cast<size_t>(word_offset[k]) + __popc(wd & below);
    if ((wd >> lane) & 1u) {
      for (int p = 0; p < planes.count; ++p) planes.sel[p][r] = planes.in[p][src];
    } else {
      for (int p = 0; p < planes.count; ++p) planes.unsel[p][src - r] = planes.in[p][src];
    }
  }

  // zero this tile's rows in [count, n) of the first output, [n - count, n) of the second
  const size_t total = static_cast<size_t>(*count);
  const size_t r0 = tile * kRowsPerTile;
  const size_t r1 = r0 + kRowsPerTile < n ? r0 + kRowsPerTile : n;
  const size_t zs = r0 > total ? r0 : total;
  const size_t zu = r0 > n - total ? r0 : n - total;
  for (int p = 0; p < planes.count; ++p) {
    for (size_t r = zs + threadIdx.x; r < r1; r += kThreads) planes.sel[p][r] = 0;
    for (size_t r = zu + threadIdx.x; r < r1; r += kThreads) planes.unsel[p][r] = 0;
  }
}

template <bool kFromBit>
cudaError_t launch_split(const SplitPlanes& planes, const uint32_t* mask, int bit, size_t rows,
                         int* offsets, int* count, cudaStream_t s) {
  const int ntiles = static_cast<int>((rows + kRowsPerTile - 1) / kRowsPerTile);
  cudaError_t err;
  if (ntiles > 0) {
    split_counts<kFromBit><<<ntiles, kThreads, 0, s>>>(mask, planes.in[0], bit, rows, offsets);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  scan_tile_counts<<<1, kScanThreads, 0, s>>>(offsets, ntiles, count);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (ntiles > 0) {
    split_tiles<kFromBit><<<ntiles, kThreads, 0, s>>>(planes, mask, bit, rows, offsets, count);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Bytes of tile scratch the compaction needs for n rows (never 0).
extern "C" long long arrow_compact_scratch_bytes(long long n) {
  const long long ntiles = (n + kRowsPerTile - 1) / kRowsPerTile;
  return (ntiles > 0 ? ntiles : 1) * static_cast<long long>(sizeof(int));
}

// in/out/kinds: host arrays of `nplanes` entries; kinds: 0 = 4-byte value
// plane, 1 = 8-byte value plane, 2 = packed bitmap plane (out: 0/1 int32).
// mask: ceil(n/32) packed words.  tile_scratch: arrow_compact_scratch_bytes(n)
// bytes.
// count_out: one device int.  Returns cudaGetLastError() of the launches.
extern "C" int arrow_compact_multi(const void* const* in, void* const* out, const int* kinds,
                                   int nplanes, const void* mask, long long n,
                                   void* tile_scratch, void* count_out, void* stream) {
  if (nplanes < 0 || nplanes > kMaxPlanes || n < 0 || n >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Planes planes;
  planes.count = nplanes;
  for (int p = 0; p < nplanes; ++p) {
    if (kinds[p] < kValue4 || kinds[p] > kPackedWords) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    planes.in[p] = in[p];
    planes.out[p] = out[p];
    planes.kind[p] = kinds[p];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t rows = static_cast<size_t>(n);
  const int ntiles = static_cast<int>((rows + kRowsPerTile - 1) / kRowsPerTile);
  const uint32_t* m = static_cast<const uint32_t*>(mask);
  int* offsets = static_cast<int*>(tile_scratch);
  int* count = static_cast<int*>(count_out);
  cudaError_t err;
  if (ntiles > 0) {
    tile_counts<<<ntiles, kThreads, 0, s>>>(m, rows, offsets);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  scan_tile_counts<<<1, kScanThreads, 0, s>>>(offsets, ntiles, count);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  if (ntiles > 0) {
    scatter_tiles<<<ntiles, kThreads, 0, s>>>(planes, m, rows, offsets, count);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// in/sel/unsel: host arrays of `nplanes` (1..8) device pointers to 4-byte
// rows.  mask: ceil(n/32) packed words, or null to select the rows whose
// plane-0 bit `bit` (0..31) is zero.  tile_scratch: arrow_compact_scratch_bytes(n)
// bytes; count_out: one device int (the selected rows).  Returns
// cudaGetLastError() of the launches.
extern "C" int arrow_split_multi(const void* const* in, void* const* sel, void* const* unsel,
                                 int nplanes, const void* mask, int bit, long long n,
                                 void* tile_scratch, void* count_out, void* stream) {
  if (nplanes < 1 || nplanes > kMaxSplitPlanes || n < 0 || n >= (1LL << 31) ||
      (mask == nullptr && (bit < 0 || bit > 31))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SplitPlanes planes;
  planes.count = nplanes;
  for (int p = 0; p < nplanes; ++p) {
    planes.in[p] = static_cast<const uint32_t*>(in[p]);
    planes.sel[p] = static_cast<uint32_t*>(sel[p]);
    planes.unsel[p] = static_cast<uint32_t*>(unsel[p]);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* m = static_cast<const uint32_t*>(mask);
  int* offsets = static_cast<int*>(tile_scratch);
  int* count = static_cast<int*>(count_out);
  const size_t rows = static_cast<size_t>(n);
  const cudaError_t err = m == nullptr
      ? launch_split<true>(planes, m, bit, rows, offsets, count, s)
      : launch_split<false>(planes, m, bit, rows, offsets, count, s);
  return static_cast<int>(err);
}
