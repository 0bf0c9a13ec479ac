// Stable LSD radix sort of up to 8 planes by plane 0 (kernels B3 and B4).
//
// Replaces arrow_tpu/compute/kernels/radix.py::_radix_pass_call (B3, the
// 1-bit two-stream split pass, via radix_sort_chain[_parts]) and
// ::_radix4_pass_call / _radix4_multipass_call (B4, the 2-bit four-stream
// pass).  Same contract as the chain: every plane is reordered by a stable
// sort on digits of plane 0, least significant first, so the chain over the
// bits sorted by is a stable sort by those bits.  The digit width is a
// template parameter: 1 is B3's pass, 2 is B4's, 8 is the default chain.
// Plane 0 is an unsigned-order key code of 4 or 8 bytes; the other planes are
// payloads of 4 or 8 bytes, moved as raw bits.  Only the first n rows are
// sorted.  A digit may start at any bit (the caller aligns each to the
// lowest bit not yet sorted), so bits 12-19 are one 8-bit pass.
//
// What bounds it on the H100: bytes.  The least a chain of P passes can move
// is every plane read and written once a pass.  The TPU kernel walks its
// blocks in order and carries its stream offsets from one grid step to the
// next; GPU blocks run in parallel in no order, so a pass here is a onesweep
// pass (Adinets and Merrill, "Onesweep: A Faster Least Significant Digit
// Radix Sort for GPUs", 2022): one launch that reads every plane once and
// writes it once, plus one read of the key for the whole sort.
//   1. radix_histogram reads the key once, with 16-byte loads, and counts
//      the digit of every pass into a passes x 2^bits table (shared-memory
//      tables per block, one global atomic a bin a block);
//      radix_scan_histogram turns each pass's row into digit bases.
//   2. radix_onesweep, one launch a pass.  A block takes its tile from an
//      atomic ticket, not from blockIdx.x: blocks are not scheduled in index
//      order, and a block that waited on a tile that no resident block holds
//      would hang the card.  It loads its keys once, coalesced, a warp a run
//      of 32 x kItems rows, lane l the rows l, l + 32, ...: the rows of one
//      load are then in lane order, which the ranking needs (16-byte loads
//      would put a lane's four rows between its neighbours').  It ranks them
//      stably with no block barrier: per warp a digit table in shared
//      memory, per load a ballot per digit bit for the lanes with the same
//      digit, __popc for the lane's place among them, the lowest of them
//      advancing the warp's count.  Then one thread a digit stacks the
//      warps in order, the digits are scanned into tile offsets, and the same
//      thread publishes the tile's count of its digit and looks back over
//      the earlier tiles for the digit's rows before this tile (decoupled
//      look-back, as csrc/segscan.cuh), several tiles' words a step.  A
//      descriptor is one 32-bit word: 0 not yet, count + 1 an aggregate,
//      bit 31 | count an inclusive prefix (counts below 2^31); the words are
//      zeroed on the stream before every pass.  A digit that
//      no key has publishes and reads nothing.  Tile order gives stability
//      across tiles, warp and lane order inside the tile.
//   3. Rows move through shared memory, plane by plane: each plane is read
//      once, coalesced, written to its ranked place in one staging tile and
//      written out in digit order, consecutive threads to consecutive output
//      rows of a digit.  A thread keeps its rows' ranks and the digits of
//      the ranks it writes out, packed, in registers between planes; the
//      staging tile is sized for the widest plane.
// Passes ping-pong between two buffer sets that the wrapper allocates once
// per sort.  Index arithmetic is 64-bit; counts are below 2^31 (n < 2^31).
//
// Not carried over from the TPU kernel: the stitched S/U stream read, the
// stream parts and their combine, the hole-filling row network, the
// searchsorted lane gather, the dispatch chunking and the 8192-row padding.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Tile shape: threads a block and rows a thread.  Of the shapes that
// tools/radix_tile_shapes.py times, all within 5% of each other on two
// 4-byte planes, 1024 x 8 (an 8192-row tile, one block an SM, 64 registers a
// thread) is best or within 2% of best on every call, and 20% ahead of the
// 4096-row tiles on four planes.  kThreads is at least 256: one thread a
// digit.  kItems is a multiple of 4 (see Places).
constexpr int kThreads = 1024;
constexpr int kItems = 8;
constexpr int kMinBlocks = 1;  // blocks an SM, which caps the registers a thread
// Alternatives that tools/radix_tile_shapes.py times against each other:
constexpr bool kMatchAny = false;  // 8-bit peers by __match_any_sync, not by 8 ballots
constexpr bool kOrdered = false;   // descriptors stored with release and read with acquire order
constexpr int kLookBack = 4;       // descriptors a digit's walk back reads at once
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * kItems;  // rows per tile
static_assert(kItems % 4 == 0 && kTile <= 65536, "ranks are kept in 16 bits, digits four a word");
constexpr int kWarpRows = 32 * kItems;    // a warp's run of rows
constexpr int kHistThreads = 256;
constexpr int kHistLoads = 4;  // 16-byte loads a thread has in flight
constexpr int kMaxPlanes = 8;
constexpr int kMaxPasses = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kPrefixBit = 0x80000000u;
constexpr int kStaticSharedLimit = 48 * 1024;

struct Planes {
  const void* in[kMaxPlanes];
  void* out[kMaxPlanes];
  int wide[kMaxPlanes];  // 1: 8-byte elements, 0: 4-byte
  int count;
};

struct Shifts {
  int shift[kMaxPasses];
  int count;
};

template <typename K>
__device__ __forceinline__ unsigned digit_of(K key, K key_mask, int shift, unsigned digit_mask) {
  return static_cast<unsigned>((key & key_mask) >> shift) & digit_mask;
}

__device__ __forceinline__ int warp_inclusive_sum(int x, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Exclusive sum of one value per thread over the block (at most 32 warps).
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

// Lanes of the warp whose digit equals this lane's.  Every lane calls it;
// lanes without a row pass a digit of (1 << BITS) and are masked out by the
// caller with the ballot of valid lanes.
template <int BITS>
__device__ __forceinline__ unsigned peers_of(unsigned d) {
  if (BITS == 8 && kMatchAny) return __match_any_sync(kFull, d);
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b < BITS; ++b) {
    const unsigned bit = (d >> b) & 1u;
    const unsigned ones = __ballot_sync(kFull, bit);
    peers &= bit ? ones : ~ones;
  }
  return peers;
}

// ---- the histogram of every pass -------------------------------------------

template <typename K>
__device__ __forceinline__ void count_key(K key, K key_mask, const Shifts& sh, int bits,
                                          unsigned* counts) {
  const unsigned digit_mask = (1u << bits) - 1u;
  for (int p = 0; p < sh.count; ++p) {
    atomicAdd(&counts[(p << bits) + digit_of<K>(key, key_mask, sh.shift[p], digit_mask)], 1u);
  }
}

// f(key) for every key, each once, over the whole grid: 16-byte loads,
// kHistLoads of them in flight a thread, where the plane is 16-byte aligned;
// the rows past the last full 16 bytes, or a misaligned plane, key by key.
template <typename K, typename F>
__device__ __forceinline__ void for_each_key(const K* key, size_t n, int aligned, F&& f) {
  constexpr int kPer = 16 / sizeof(K);  // keys a 16-byte load
  const size_t stride = static_cast<size_t>(gridDim.x) * kHistThreads;
  const size_t me = static_cast<size_t>(blockIdx.x) * kHistThreads + threadIdx.x;
  const size_t nvec = aligned ? n / kPer : 0;
  const uint4* vec = reinterpret_cast<const uint4*>(key);
  for (size_t v = me; v < nvec; v += kHistLoads * stride) {
    union {
      uint4 raw;
      K k[kPer];
    } x[kHistLoads];
#pragma unroll
    for (int u = 0; u < kHistLoads; ++u) {
      if (v + u * stride < nvec) x[u].raw = __ldg(vec + v + u * stride);
    }
#pragma unroll
    for (int u = 0; u < kHistLoads; ++u) {
      if (v + u * stride < nvec) {
#pragma unroll
        for (int e = 0; e < kPer; ++e) f(x[u].k[e]);
      }
    }
  }
  for (size_t i = nvec * kPer + me; i < n; i += stride) f(key[i]);
}

// hist[p << bits | d] += the keys whose digit of pass p is d.
template <typename K>
__global__ void __launch_bounds__(kHistThreads)
radix_histogram(const K* key, size_t n, int aligned, K key_mask, Shifts sh, int bits,
                unsigned* hist) {
  extern __shared__ unsigned counts[];
  const int cells = sh.count << bits;
  for (int i = threadIdx.x; i < cells; i += kHistThreads) counts[i] = 0;
  __syncthreads();
  for_each_key<K>(key, n, aligned, [&](K k) { count_key<K>(k, key_mask, sh, bits, counts); });
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += kHistThreads) {
    if (counts[i]) atomicAdd(&hist[i], counts[i]);
  }
}

// out[0] |= every key, out[1] &= every key (zero-extended to 64 bits).
template <typename K>
__global__ void __launch_bounds__(kHistThreads)
radix_or_and(const K* key, size_t n, int aligned, unsigned long long* out) {
  unsigned long long o = 0ull, a = ~0ull;
  for_each_key<K>(key, n, aligned, [&](K k) {
    o |= k;
    a &= k;
  });
  for (int d = 16; d > 0; d >>= 1) {
    o |= __shfl_down_sync(kFull, o, d);
    a &= __shfl_down_sync(kFull, a, d);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicOr(&out[0], o);
    atomicAnd(&out[1], a);
  }
}

// One block per pass: bases[p << bits | d] = the keys whose digit of pass p
// is below d.
__global__ void radix_scan_histogram(const unsigned* hist, unsigned* bases, int bits) {
  __shared__ int warp_sums[32];
  const int r = 1 << bits;
  const int cell = (blockIdx.x << bits) + threadIdx.x;
  const int v = static_cast<int>(threadIdx.x) < r ? static_cast<int>(hist[cell]) : 0;
  const int before = block_exclusive_sum(v, warp_sums);
  if (static_cast<int>(threadIdx.x) < r) bases[cell] = static_cast<unsigned>(before);
}

// ---- one pass --------------------------------------------------------------

// A descriptor is the whole message (status and count in one word), so its
// stores and loads need no order against other memory: they are relaxed
// (strong at gpu scope, so they meet in L2).  Release stores and acquire
// loads, a fence each in every one of a tile's 2^bits digit threads, took
// 0.4-0.6 ms more a pass at 2^27 rows (tools/radix_tile_shapes.py, "ordered").
__device__ __forceinline__ unsigned load_word(const unsigned* p) {
  unsigned v;
  if (kOrdered) {
    asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  } else {
    asm volatile("ld.relaxed.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  }
  return v;
}

__device__ __forceinline__ void store_word(unsigned* p, unsigned v) {
  if (kOrdered) {
    asm volatile("st.release.gpu.u32 [%0], %1;" : : "l"(p), "r"(v) : "memory");
  } else {
    asm volatile("st.relaxed.gpu.u32 [%0], %1;" : : "l"(p), "r"(v) : "memory");
  }
}

// The rows of digit `d` in the tiles before `tile`, for the thread that owns
// the digit; publishes this tile's count of it on the way.  status holds one
// word per (tile, digit).  The walk back reads kLookBack tiles' words at once:
// one dependent load a tile would make a tile's wait grow with the number of
// tiles in flight.
template <int R>
__device__ __forceinline__ int look_back(unsigned* status, unsigned tile, int d, int count) {
  unsigned* mine = status + static_cast<size_t>(tile) * R + d;
  if (tile == 0) {
    store_word(mine, kPrefixBit | static_cast<unsigned>(count));
    return 0;
  }
  store_word(mine, static_cast<unsigned>(count) + 1u);
  int before = 0;
  // tile 0 holds a prefix, so the walk ends there at the latest
  for (long long newest = static_cast<long long>(tile) - 1;; newest -= kLookBack) {
    unsigned word[kLookBack];
#pragma unroll
    for (int u = 0; u < kLookBack; ++u) {
      if (newest - u >= 0) word[u] = load_word(status + static_cast<size_t>(newest - u) * R + d);
    }
#pragma unroll
    for (int u = 0; u < kLookBack; ++u) {
      // newest - u >= 0 here: the walk returns at tile 0
      while (word[u] == 0) word[u] = load_word(status + static_cast<size_t>(newest - u) * R + d);
      if (word[u] & kPrefixBit) {
        before += static_cast<int>(word[u] & ~kPrefixBit);
        store_word(mine, kPrefixBit | static_cast<unsigned>(before + count));
        return before;
      }
      before += static_cast<int>(word[u] - 1u);
    }
  }
}

// This thread's rows of one plane (those of its keys).
template <typename T>
__device__ __forceinline__ void load_rows(const void* in, size_t base, int first, int rows,
                                          T (&v)[kItems]) {
  const T* src = static_cast<const T*>(in) + base;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (first + i * 32 < rows) v[i] = src[first + i * 32];
  }
}

// What a thread keeps between planes, packed to spare registers (the pass
// is short of them): the ranks of its rows, two a word, and the digits of the
// ranks it writes out (rank q = threadIdx.x + j * kThreads), four a word.
struct Places {
  unsigned rank[kItems / 2];
  unsigned digit[kItems / 4];

  __device__ __forceinline__ int rank_of(int i) const { return (rank[i / 2] >> (16 * (i % 2))) & 0xffffu; }
  __device__ __forceinline__ int digit_at(int j) const { return (digit[j / 4] >> (8 * (j % 4))) & 0xffu; }
};

// One payload plane through the staging tile: each thread's rows to their
// ranks, then the tile out in digit order.
template <typename T>
__device__ __forceinline__ void place_rows(const T (&v)[kItems], void* out, int first, int rows,
                                           const Places& at, const int* delta, unsigned char* stage) {
  T* tile = reinterpret_cast<T*>(stage);
  __syncthreads();  // the plane before this one has left the stage
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (first + i * 32 < rows) tile[at.rank_of(i)] = v[i];
  }
  __syncthreads();
  T* dest = static_cast<T*>(out);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int q = threadIdx.x + j * kThreads;
    if (q < rows) dest[delta[at.digit_at(j)] + q] = tile[q];
  }
}

template <int BITS, typename K>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
radix_onesweep(Planes planes, K key_mask, size_t n, int shift, const unsigned* totals,
               const unsigned* bases, unsigned* counter, unsigned* status) {
  constexpr int R = 1 << BITS;
  static_assert(R <= kThreads, "one thread per digit");
  extern __shared__ __align__(16) unsigned char stage[];  // kTile rows of the widest plane
  __shared__ int warp_digits[kWarps][R];  // per warp: its count of each digit, then its first rank
  __shared__ int delta[R];                // output row of a digit's rank q: delta[digit] + q
  __shared__ int warp_sums[kWarps];
  __shared__ unsigned ticket;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) ticket = atomicAdd(counter, 1u);
  for (int i = threadIdx.x; i < kWarps * R; i += kThreads) (&warp_digits[0][0])[i] = 0;
  __syncthreads();
  const unsigned tile = ticket;
  const size_t base = static_cast<size_t>(tile) * kTile;
  const int rows = n - base < static_cast<size_t>(kTile) ? static_cast<int>(n - base) : kTile;
  const int first = warp * kWarpRows + lane;  // this thread's rows: first + 32 i

  const K* key = static_cast<const K*>(planes.in[0]) + base;
  K k[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (first + i * 32 < rows) k[i] = key[first + i * 32];
  }

  // rank within the warp: stable by digit, load by load, lane by lane
  Places at;
#pragma unroll
  for (int i = 0; i < kItems / 2; ++i) at.rank[i] = 0;
#pragma unroll
  for (int j = 0; j < kItems / 4; ++j) at.digit[j] = 0;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool valid = first + i * 32 < rows;
    const unsigned d = valid ? digit_of<K>(k[i], key_mask, shift, R - 1) : R;
    const unsigned peers = peers_of<BITS>(d) & __ballot_sync(kFull, valid);
    const int leader = valid ? __ffs(peers) - 1 : lane;
    int seen = 0;  // the warp's rows of this digit in earlier loads
    if (valid && lane == leader) {
      seen = warp_digits[warp][d];
      warp_digits[warp][d] = seen + __popc(peers);
    }
    __syncwarp();
    seen = __shfl_sync(kFull, seen, leader);
    at.rank[i / 2] |= static_cast<unsigned>(seen + __popc(peers & below)) << (16 * (i % 2));
  }
  __syncthreads();

  // per digit (one a thread): the warps stacked in order, the digits scanned
  // into the tile's first rank of each, and the look-back
  const bool own = threadIdx.x < R;
  int count = 0;
  if (own) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_digits[w][threadIdx.x];
      warp_digits[w][threadIdx.x] = count;
      count += c;
    }
  }
  const int start = block_exclusive_sum(count, warp_sums);
  if (own) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) warp_digits[w][threadIdx.x] += start;
    int before = 0;
    if (totals[threadIdx.x]) before = look_back<R>(status, tile, threadIdx.x, count);
    delta[threadIdx.x] = static_cast<int>(bases[threadIdx.x]) + before - start;
  }
  __syncthreads();

  // the key plane: to its ranks in the stage, then out in digit order
  K* tile_keys = reinterpret_cast<K*>(stage);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    if (first + i * 32 < rows) {
      // the sum stays below kTile, so it does not carry into the other half
      at.rank[i / 2] += static_cast<unsigned>(warp_digits[warp][digit_of<K>(k[i], key_mask, shift, R - 1)])
                        << (16 * (i % 2));
      tile_keys[at.rank_of(i)] = k[i];
    }
  }
  __syncthreads();
  K* out_keys = static_cast<K*>(planes.out[0]);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const int q = threadIdx.x + j * kThreads;
    if (q < rows) {
      const K x = tile_keys[q];
      const unsigned d = digit_of<K>(x, key_mask, shift, R - 1);
      at.digit[j / 4] |= d << (8 * (j % 4));
      out_keys[delta[d] + q] = x;
    }
  }
  for (int p = 1; p < planes.count; ++p) {
    if (planes.wide[p]) {
      uint64_t v[kItems];
      load_rows<uint64_t>(planes.in[p], base, first, rows, v);
      place_rows<uint64_t>(v, planes.out[p], first, rows, at, delta, stage);
    } else {
      uint32_t v[kItems];
      load_rows<uint32_t>(planes.in[p], base, first, rows, v);
      place_rows<uint32_t>(v, planes.out[p], first, rows, at, delta, stage);
    }
  }
}

// ---- host side -------------------------------------------------------------

long long tiles_for(long long n) { return (n + kTile - 1) / kTile; }

// Scratch: the histogram (kMaxPasses-independent: passes << bits words), the
// digit bases (the same), one tile counter a pass, then the descriptors.
struct Scratch {
  unsigned* hist;
  unsigned* bases;
  unsigned* counters;
  unsigned* status;
  size_t head_bytes;    // hist, bases and counters, zeroed once a sort
  size_t status_bytes;  // zeroed before every pass
};

Scratch carve(void* scratch, long long n, int digit_bits, int npasses) {
  const size_t cells = static_cast<size_t>(npasses) << digit_bits;
  Scratch s;
  s.hist = static_cast<unsigned*>(scratch);
  s.bases = s.hist + cells;
  s.counters = s.bases + cells;
  s.head_bytes = ((2 * cells + npasses) * sizeof(unsigned) + 127) / 128 * 128;
  s.status = reinterpret_cast<unsigned*>(static_cast<unsigned char*>(scratch) + s.head_bytes);
  s.status_bytes = (static_cast<size_t>(tiles_for(n)) << digit_bits) * sizeof(unsigned);
  return s;
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
      count = 132;
    }
  }
  return count;
}

// Blocks of kHistThreads for a pass of for_each_key over n keys of `width` bytes.
unsigned key_read_blocks(size_t n, int width) {
  const size_t per_block = static_cast<size_t>(kHistThreads) * kHistLoads * (16 / width);
  const size_t blocks = (n + per_block - 1) / per_block;
  const size_t most = static_cast<size_t>(sm_count()) * 8;
  return static_cast<unsigned>(blocks < most ? blocks : most);
}

int is_aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename K>
cudaError_t count_digits(const void* key, size_t n, unsigned long long key_mask, const Shifts& sh,
                         int digit_bits, const Scratch& sc, cudaStream_t s) {
  const unsigned blocks = key_read_blocks(n, sizeof(K));
  const int aligned = is_aligned(key);
  const size_t shared = (static_cast<size_t>(sh.count) << digit_bits) * sizeof(unsigned);
  radix_histogram<K><<<blocks, kHistThreads, shared, s>>>(
      static_cast<const K*>(key), n, aligned, static_cast<K>(key_mask), sh, digit_bits, sc.hist);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  radix_scan_histogram<<<sh.count, 256, 0, s>>>(sc.hist, sc.bases, digit_bits);
  return cudaGetLastError();
}

template <int BITS, typename K>
cudaError_t run_passes(const Planes& first, void* const* buf_a, void* const* buf_b,
                       unsigned long long key_mask, size_t n, const Shifts& sh, const Scratch& sc,
                       cudaStream_t s) {
  int any_wide = 0;
  for (int q = 0; q < first.count; ++q) any_wide |= first.wide[q];
  const size_t stage_bytes = static_cast<size_t>(kTile) * (any_wide ? 8 : 4);
  constexpr size_t kStatic = sizeof(int) * (kWarps * (1 << BITS) + (1 << BITS) + kWarps + 1);
  cudaError_t err;
  if (stage_bytes + kStatic > kStaticSharedLimit) {
    err = cudaFuncSetAttribute(radix_onesweep<BITS, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(stage_bytes));
    if (err != cudaSuccess) return err;
  }
  const unsigned ntiles = static_cast<unsigned>(tiles_for(static_cast<long long>(n)));
  Planes planes = first;
  for (int p = 0; p < sh.count; ++p) {
    for (int q = 0; q < planes.count; ++q) {
      if (p > 0) planes.in[q] = (p % 2 == 1) ? buf_a[q] : buf_b[q];
      planes.out[q] = (p % 2 == 0) ? buf_a[q] : buf_b[q];
    }
    if ((err = cudaMemsetAsync(sc.status, 0, sc.status_bytes, s)) != cudaSuccess) return err;
    radix_onesweep<BITS, K><<<ntiles, kThreads, stage_bytes, s>>>(
        planes, static_cast<K>(key_mask), n, sh.shift[p], sc.hist + (static_cast<size_t>(p) << BITS),
        sc.bases + (static_cast<size_t>(p) << BITS), sc.counters + p, sc.status);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename K>
cudaError_t sort_keys(int digit_bits, const Planes& planes, void* const* buf_a, void* const* buf_b,
                      unsigned long long key_mask, size_t n, const Shifts& sh, const Scratch& sc,
                      cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(sc.hist, 0, sc.head_bytes, s);
  if (err != cudaSuccess) return err;
  err = count_digits<K>(planes.in[0], n, key_mask, sh, digit_bits, sc, s);
  if (err != cudaSuccess) return err;
  switch (digit_bits) {
    case 1: return run_passes<1, K>(planes, buf_a, buf_b, key_mask, n, sh, sc, s);
    case 2: return run_passes<2, K>(planes, buf_a, buf_b, key_mask, n, sh, sc, s);
    case 8: return run_passes<8, K>(planes, buf_a, buf_b, key_mask, n, sh, sc, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Bytes of scratch a sort of n rows in `npasses` passes of `digit_bits` needs.
extern "C" long long arrow_radix_scratch_bytes(long long n, int digit_bits, int npasses) {
  if (n < 0 || npasses < 0 || npasses > kMaxPasses || digit_bits < 1 || digit_bits > 8) return -1;
  const Scratch s = carve(nullptr, n, digit_bits, npasses);
  return static_cast<long long>(s.head_bytes + s.status_bytes);
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
  const size_t rows = static_cast<size_t>(n);
  if (wide) {
    radix_or_and<uint64_t><<<key_read_blocks(rows, 8), kHistThreads, 0, s>>>(
        static_cast<const uint64_t*>(key), rows, is_aligned(key), o);
  } else {
    radix_or_and<uint32_t><<<key_read_blocks(rows, 4), kHistThreads, 0, s>>>(
        static_cast<const uint32_t*>(key), rows, is_aligned(key), o);
  }
  return static_cast<int>(cudaGetLastError());
}

// in: `nplanes` host pointers to the input planes (not written); buf_a,
// buf_b: two buffer sets of the same shapes; wide: 1 for 8-byte planes, 0 for
// 4-byte.  Pass p sorts by the `digit_bits` bits from bit shifts[p] of plane 0
// AND key_mask (the bits the sort is by; the others read as 0): pass 0 reads
// `in` and writes buf_a, then passes alternate buf_a -> buf_b -> buf_a, so the
// sorted planes are in buf_a when npasses is odd and in buf_b when it is even.
// scratch: arrow_radix_scratch_bytes(n, digit_bits, npasses) bytes.  Returns
// cudaGetLastError() of the launches.
extern "C" int arrow_radix_sort(const void* const* in, void* const* buf_a, void* const* buf_b,
                                const int* wide, int nplanes, long long n,
                                unsigned long long key_mask, const int* shifts, int npasses,
                                int digit_bits, void* scratch, void* stream) {
  if (nplanes < 1 || nplanes > kMaxPlanes || n < 0 || n >= (1LL << 31) || npasses < 0 ||
      npasses > kMaxPasses) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int key_bits = wide[0] ? 64 : 32;
  Shifts sh;
  sh.count = npasses;
  for (int p = 0; p < npasses; ++p) {
    if (shifts[p] < 0 || shifts[p] + digit_bits > key_bits) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    sh.shift[p] = shifts[p];
  }
  if (n == 0 || npasses == 0) return static_cast<int>(cudaSuccess);
  Planes planes;
  planes.count = nplanes;
  for (int p = 0; p < nplanes; ++p) {
    planes.in[p] = in[p];
    planes.out[p] = nullptr;
    planes.wide[p] = wide[p] ? 1 : 0;
  }
  const Scratch sc = carve(scratch, n, digit_bits, npasses);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t rows = static_cast<size_t>(n);
  const cudaError_t err =
      wide[0] ? sort_keys<uint64_t>(digit_bits, planes, buf_a, buf_b, key_mask, rows, sh, sc, s)
              : sort_keys<uint32_t>(digit_bits, planes, buf_a, buf_b, key_mask, rows, sh, sc, s);
  return static_cast<int>(err);
}
