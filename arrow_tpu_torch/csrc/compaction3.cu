// Stable multi-plane compaction by one packed selection mask (kernel B1), and
// the stable dual-output split (kernel B8), as one single-pass kernel.
//
// B1 replaces arrow_tpu/compute/kernels/compaction3.py::compact_multi_pallas
// (the Pallas kernel built by `_make_kernel`).  Same function: every selected
// row of every plane moves, in order, to the front of that plane's output;
// output rows at and past the count are zero; the count is returned.  Planes
// are 4- or 8-byte value planes (moved as raw bits, any dtype) or packed
// LSB-first bitmap planes, which come out unpacked as 0/1 int32, as in the
// JAX kernel.  Any n in [0, 2^31) is taken: there is no padding requirement.
// B9 (arrow_tpu/compute/kernels/compaction.py::compact_pallas, one 32-bit
// plane) is a one-plane call of arrow_compact_multi.
//
// B8 replaces compaction3.py::split_multi_pallas (`_make_split_kernel`): up
// to 8 planes of 4-byte rows, each read once, go stably to two outputs, the
// selected rows to the front of one and the others to the front of the
// other; the rows past each output's count are zero.  The selection is a
// packed mask or, computed in the kernel as on the TPU, the rows whose
// plane-0 bit `bit` is zero (warp ballots over plane 0's tile).
//
// What bounds it on the H100: bytes.  Each plane's needed rows are read once
// and its outputs written once, plus n/8 bytes of mask; the arithmetic is a
// popcount and a few shifts a row.  A selected row costs its whole 32-byte
// sector, so a 50% random mask makes the card fetch every sector.  A
// single pass cannot write a row before it knows how many selected rows
// precede its tile, so the design hides that wait behind bytes in flight:
//   1. One launch over tiles of kParts parts, a part kPartBytes of the
//      launch's widest plane (8192 rows of 4 bytes, 4096 of 8), so that one
//      ticket, one read of the mask and one look-back serve 32 768 rows.  A
//      block takes its tile from an atomic ticket, not from blockIdx.x:
//      blocks are not scheduled in index order, and a block that waited on a
//      tile no resident block holds would hang the card.
//   2. A block scan of the tile's mask-word popcounts gives each word's rank
//      and the tile's count, which is published at once.  Then the block
//      starts cp.async copies of its first kBuffers items (an item is one
//      plane of one part) into a ring of shared buffers, 16 bytes a copy
//      (element by element only at a part's unaligned ends), skipping every
//      16-byte chunk that holds no selected row: a sparse mask reads little
//      more than its mask.  A split reads every row.
//   3. Warp 0 looks back over the earlier tiles for the rows before the tile
//      (decoupled look-back, as csrc/radix.cu): a descriptor is one 32-bit
//      word, the whole message, stored and loaded relaxed: 0 not yet,
//      count + 1 an aggregate, bit 31 | count an inclusive prefix; a step
//      reads 128 of them, four a lane.  The ticket and the descriptors are
//      zeroed by cudaMemsetAsync in the C entry before every launch.
//   4. Item by item through the ring: the part's selected rows are compacted
//      inside shared memory (a warp visits the mask words that hold a
//      selected row, lane = bit, rank = the word's rank + popc of the bits
//      below), placed so that the run lines up with its 16-byte output
//      chunks, and written out with 16-byte stores (scalar at the run's
//      ends).  Freeing a ring buffer starts the copy of the item kBuffers
//      ahead.  A plane's kind selects a specialised routine once an item,
//      not a branch a row; a compaction's part with no selected row only
//      writes zeros.
//   5. The zero tail needs no second launch and has no race.  With E_t the
//      selected rows of tiles <= t and U_t the others, tile t zeroes output
//      rows [n - U_t, n - U_{t-1}) (each part its share): these ranges
//      partition [count, n), all lie at or past the count, and each zero is
//      written once.  A split's second output takes tile t's unselected rows
//      at [U_{t-1}, U_t) and zeroes [n - E_t, n - E_{t-1}).
// tools/compaction_tile_shapes.py times the shape: 512 threads, 32 KB parts,
// four parts a tile and two ring buffers (two blocks an SM) is best or
// within 2% of best on the main paths' calls (PERF.md).
// Index arithmetic is 64-bit; counts are int32 (n < 2^31).
//
// Not carried over from the TPU kernel: the 3-slot VMEM windows, the MXU rank
// matmuls, the hole-filling row network, the (8,128) tiling, the sequential
// grid carry and the 8192-row padding.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Tile shape and alternatives that tools/compaction_tile_shapes.py times.
constexpr int kThreads = 512;
constexpr int kMinBlocks = 2;        // blocks an SM, which caps the registers a thread
constexpr int kPartBytes = 32768;    // a plane's part of a tile, at the launch's widest plane width
constexpr int kParts = 4;            // parts a tile: one ticket, mask read and look-back for them all
constexpr int kBuffers = 2;          // shared buffers in the ring: parts of planes loaded ahead
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPlanes = 16;
constexpr int kMaxSplitPlanes = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kPrefixBit = 0x80000000u;
constexpr int kMinTileRows = kPartBytes / 8 * kParts;  // rows of a tile when a plane is 8 bytes wide
constexpr int kRawBytes = kPartBytes + 16;    // a ring buffer: a part and its head's misalignment
constexpr int kStageBytes = kPartBytes + 64;  // the compacted runs, aligned to their output chunks
constexpr int kDynamicShared = kBuffers * kRawBytes + kStageBytes;
constexpr size_t kStatusOffset = 128;         // scratch bytes before the descriptors (16-byte aligned): the ticket
static_assert(kPartBytes % 256 == 0 && kPartBytes / 4 * kParts < (1 << 30), "part rows and ranks");

enum PlaneKind : int { kValue4 = 0, kValue8 = 1, kPackedWords = 2 };
enum Mode : int { kCompact = 0, kSplitMask = 1, kSplitBit = 2 };

struct Planes {
  const void* in[kMaxPlanes];
  void* out[kMaxPlanes];
  void* unsel[kMaxSplitPlanes];  // a split's second outputs
  int kind[kMaxPlanes];
  int count;
};

// Mask word w with the bits at rows >= n cleared.
__device__ __forceinline__ uint32_t mask_word(const uint32_t* __restrict__ mask, size_t w, size_t n) {
  const size_t first = w * 32;
  if (first >= n) return 0u;
  uint32_t word = mask[w];
  if (n - first < 32) word &= (1u << (n - first)) - 1u;
  return word;
}

__device__ __forceinline__ void store_word(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.u32 [%0], %1;" : : "l"(p), "r"(v) : "memory");
}

template <int N>
__device__ __forceinline__ void copy_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" : : "r"(s), "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" : : "r"(s), "l"(gmem), "n"(N) : "memory");
  }
}

__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;" : : : "memory"); }

// Wait until at most kBuffers - 1 groups of copies are in flight.
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;" : : "n"(kBuffers - 1) : "memory");
}

// Elements of T before `p`'s 16-byte chunk boundary: where a run that starts
// at p begins inside its first chunk.
template <typename T>
__device__ __forceinline__ int chunk_shift(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15u) / sizeof(T));
}

// Exclusive sum of one value a thread over the block; *total gets the sum.
__device__ __forceinline__ int block_exclusive_sum(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? warp_sums[w] : 0;
    all += warp_sums[w];
  }
  *total = all;
  return before + x - v;
}

// Publish the tile's count: an aggregate, or tile 0's prefix.
__device__ __forceinline__ void publish(unsigned* status, unsigned tile, int count) {
  store_word(status + tile, tile == 0 ? kPrefixBit | static_cast<unsigned>(count) : static_cast<unsigned>(count) + 1u);
}

// Four descriptors, loaded relaxed in one 16-byte access (each word is its
// own message; the four need not be read at one instant).
__device__ __forceinline__ void load_words4(const unsigned* p, unsigned (&d)[4]) {
  asm volatile("ld.relaxed.gpu.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]) : "l"(p) : "memory");
}

// Warp 0, after publish(): the selected rows of the tiles before this one
// (every lane gets it); publishes the tile's prefix.  A step reads 128
// tiles' descriptors, four a lane (lane l the group of four tiles l groups
// before the newest), and waits only for those newer than the newest
// prefix; the walk stops at a prefix, which tile 0 always holds.  The walk
// is the pass's critical path: about 264 tiles are in flight, so a step of
// 32 descriptors made it several round trips to L2.
__device__ __forceinline__ int walk_back(unsigned* status, unsigned tile, int count) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) return 0;
  const long long top = static_cast<long long>(tile) - 1;  // the newest tile before this one
  int before = 0;
  for (long long newest = top >> 2;; newest -= 32) {
    const long long group = newest - lane;
    unsigned d[4];
    auto load = [&]() {
      if (group >= 0) {
        load_words4(status + 4 * group, d);
      } else {  // before tile 0: a prefix of 0, never reached past tile 0's
        d[0] = d[1] = d[2] = d[3] = kPrefixBit;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (4 * group + e > top) d[e] = 1u;  // this tile and later ones: an aggregate of 0
      }
    };
    load();
    unsigned holders;  // lanes holding a prefix
    int mine;          // this lane's newest prefix (element), or -1
    int first;         // the newest lane holding a prefix, or 32
    while (true) {
      mine = -1;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (d[e] & kPrefixBit) mine = e;
      }
      holders = __ballot_sync(kFull, mine >= 0);
      first = holders ? __ffs(holders) - 1 : 32;
      bool pending = false;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pending |= (lane < first || (lane == first && e >= mine)) && d[e] == 0u;
      }
      if (!__any_sync(kFull, pending)) break;
      if (pending) load();
    }
    int v = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (lane < first || (lane == first && e >= mine)) {
        v += static_cast<int>((d[e] & kPrefixBit) ? (d[e] & ~kPrefixBit) : d[e] - 1u);
      }
    }
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    before += v;
    if (holders) break;
  }
  if (lane == 0) store_word(status + tile, kPrefixBit | static_cast<unsigned>(before + count));
  return before;
}

// Start copies of g[e0, e0 + count) into s[sh + i] (sh = chunk_shift(g + e0)),
// one 16-byte copy a chunk, element by element at the run's unaligned ends;
// a chunk whose first element is run element i0 is skipped when !need(i0).
template <typename T, typename Need>
__device__ __forceinline__ void copy_run(T* s, const T* g, size_t e0, int count, Need need) {
  constexpr int V = 16 / sizeof(T);
  const int sh = chunk_shift<T>(g + e0);
  const T* base = g + e0 - sh;  // 16-byte aligned
  const int end = sh + count;
  for (int k = threadIdx.x * V; k < end; k += kThreads * V) {
    if (!need(k - sh)) continue;
    if (k >= sh && k + V <= end) {
      copy_async<16>(s + k, base + k);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (k + e >= sh && k + e < end) copy_async<sizeof(T)>(s + k + e, base + k + e);
      }
    }
  }
}

// out[g0 + i] = s[sh + i] for i in [0, count), or 0 when s is null, where sh =
// chunk_shift(out + g0): 16-byte stores, scalar at the run's unaligned ends.
template <typename T>
__device__ __forceinline__ void store_run(T* __restrict__ out, size_t g0, const T* s, int count) {
  constexpr int V = 16 / sizeof(T);
  const int sh = chunk_shift<T>(out + g0);
  T* base = out + g0 - sh;
  const int end = sh + count;
  for (int k = threadIdx.x * V; k < end; k += kThreads * V) {
    if (k >= sh && k + V <= end) {
      *reinterpret_cast<uint4*>(base + k) = s ? *reinterpret_cast<const uint4*>(s + k) : make_uint4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        if (k + e >= sh && k + e < end) base[k + e] = s ? s[k + e] : T(0);
      }
    }
  }
}

// A part of a tile (one ring buffer's worth of a plane), once the tile's
// look-back is done.
struct Part {
  size_t row0;     // first row
  int rows;        // rows in the part (fewer at the end of the input)
  int rank0;       // selected rows of the tile before the part
  int count;       // selected rows in the part
  size_t before;   // selected rows before the part (E before it)
  int sel_at;      // where the selected run starts in the stage
  int unsel_at;    // where a split's unselected run starts in the stage
};

template <int kWords>
struct Shared {
  uint32_t words[kWords + 2];  // the tile's selection words at [1, kWords]; [0] and [kWords + 1] are 0
  int word_rank[kWords];       // selected rows of the tile before each word
  int warp_sums[kWarps];
  unsigned ticket;
  int before;
};

// Copy plane p of a part into a ring buffer: a value plane's rows (in a
// compaction, only 16-byte chunks holding a selected row), or a bitmap
// plane's words.  words[j] holds the part's rows [32 (j - 1), 32 j).
template <bool kSplit>
__device__ __forceinline__ void copy_plane(const Planes& planes, int p, unsigned char* buf, size_t row0,
                                           int rows, const uint32_t* words) {
  const int kind = kSplit ? kValue4 : planes.kind[p];
  if (kind == kPackedWords) {
    copy_run<uint32_t>(reinterpret_cast<uint32_t*>(buf), static_cast<const uint32_t*>(planes.in[p]), row0 / 32,
                       (rows + 31) / 32, [](int) { return true; });
    return;
  }
  // whether the part's rows among the V from i0 (>= -V, < rows) hold a
  // selected one: a part without one must start no copy (see move_plane)
  auto need = [&](int i0, int V) {
    if (kSplit) return true;
    const int j = (i0 + 32) >> 5;
    const uint64_t pair = (static_cast<uint64_t>(words[j + 1]) << 32) | words[j];
    uint32_t bits = static_cast<uint32_t>(pair >> (i0 + 32 - 32 * j)) & ((1u << V) - 1u);
    if (i0 < 0) bits &= ~0u << -i0;
    if (rows - i0 < V) bits &= (1u << (rows - i0)) - 1u;
    return bits != 0u;
  };
  if (kind == kValue8) {
    copy_run<uint64_t>(reinterpret_cast<uint64_t*>(buf), static_cast<const uint64_t*>(planes.in[p]), row0, rows,
                       [&](int i0) { return need(i0, 2); });
  } else {
    copy_run<uint32_t>(reinterpret_cast<uint32_t*>(buf), static_cast<const uint32_t*>(planes.in[p]), row0, rows,
                       [&](int i0) { return need(i0, 4); });
  }
}

// f(k, wd, rank) for each word k of a part that holds a selected row (every
// word in a split), rank = the word's first rank in the part.  A warp takes
// kChunk consecutive words at a time, loads their words and ranks a lane
// each and visits the ones it needs: a sparse part costs a load and a ballot.
template <int kWords, bool kSplit, typename F>
__device__ __forceinline__ void for_each_word(const Part& t, const uint32_t* words, const int* word_rank, F f) {
  constexpr int kChunk = kWords / kWarps >= 32 ? 32 : (kWords / kWarps > 0 ? kWords / kWarps : 1);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwords = (t.rows + 31) / 32;
  for (int k0 = warp * kChunk; k0 < nwords; k0 += kWarps * kChunk) {
    const bool mine = lane < kChunk && k0 + lane < nwords;
    const uint32_t wd = mine ? words[k0 + lane + 1] : 0u;
    const int rank = mine ? word_rank[k0 + lane] - t.rank0 : 0;
    for (unsigned todo = __ballot_sync(kFull, mine && (kSplit || wd != 0u)); todo; todo &= todo - 1) {
      const int j = __ffs(todo) - 1;
      f(k0 + j, __shfl_sync(kFull, wd, j), __shfl_sync(kFull, rank, j));
    }
  }
}

// The part's rows of one value plane from its ring buffer to the stage: the
// selected ones to sel_at + rank, a split's others to unsel_at + (row - rank).
template <typename T, int kWords, bool kSplit>
__device__ __forceinline__ void stage_rows(const T* raw, T* stage, const Part& t, const uint32_t* words,
                                           const int* word_rank) {
  const int lane = threadIdx.x & 31;
  const uint32_t below = (1u << lane) - 1u;
  for_each_word<kWords, kSplit>(t, words, word_rank, [&](int k, uint32_t wd, int first) {
    const int r = 32 * k + lane;
    const int rank = first + __popc(wd & below);
    if ((wd >> lane) & 1u) {
      stage[t.sel_at + rank] = raw[r];
    } else if (kSplit && r < t.rows) {
      stage[t.unsel_at + r - rank] = raw[r];
    }
  });
}

// A bitmap plane: the selected rows' bits, as 0/1 int32, to the stage.
template <int kWords>
__device__ __forceinline__ void stage_bits(const uint32_t* raw, int32_t* stage, const Part& t,
                                           const uint32_t* words, const int* word_rank) {
  const int lane = threadIdx.x & 31;
  const uint32_t below = (1u << lane) - 1u;
  for_each_word<kWords, false>(t, words, word_rank, [&](int k, uint32_t wd, int first) {
    if ((wd >> lane) & 1u) {
      stage[t.sel_at + first + __popc(wd & below)] = static_cast<int32_t>((raw[k] >> lane) & 1u);
    }
  });
}

// Plane p of a part: ring buffer -> stage (then a barrier) -> its outputs,
// zero tails included.  `next` starts the copy that takes over the ring
// buffer once the stage holds the plane.  A compaction's value plane in a
// part without a selected row copied nothing and stages nothing: it skips
// the wait and both barriers and only writes zeros (no copy into its buffer
// is in flight to race the next one).  The
// zero tail of a part is the tile's, cut the same way: with U the unselected
// rows before the part and U' those up to its end, it zeroes [n - U', n - U).
template <typename T, int kWords, bool kSplit, typename Next>
__device__ __forceinline__ void move_plane(const Planes& planes, int p, const unsigned char* buf,
                                           unsigned char* stage_bytes, Part t, const uint32_t* words,
                                           const int* word_rank, size_t n, Next next, bool bits) {
  constexpr int V = 16 / sizeof(T);
  T* stage = reinterpret_cast<T*>(stage_bytes);
  T* out = static_cast<T*>(planes.out[p]);
  const size_t u_before = t.row0 - t.before;  // U
  const int unselected = t.rows - t.count;
  t.sel_at = chunk_shift<T>(out + t.before);
  if (kSplit || bits || t.count > 0) {
    wait_copies();
    __syncthreads();  // the item is in its buffer; the stage is free
    if constexpr (kSplit) {  // the unselected run after the selected one, aligned to its output
      const int at = t.sel_at + t.count;
      t.unsel_at = at + ((chunk_shift<T>(static_cast<T*>(planes.unsel[p]) + u_before) - at) % V + V) % V;
    }
    if (bits) {
      const uint32_t* raw = reinterpret_cast<const uint32_t*>(buf) +
                            chunk_shift<uint32_t>(static_cast<const uint32_t*>(planes.in[p]) + t.row0 / 32);
      stage_bits<kWords>(raw, reinterpret_cast<int32_t*>(stage), t, words, word_rank);
    } else {
      const T* raw = reinterpret_cast<const T*>(buf) + chunk_shift<T>(static_cast<const T*>(planes.in[p]) + t.row0);
      stage_rows<T, kWords, kSplit>(raw, stage, t, words, word_rank);
    }
    __syncthreads();  // the stage is full and the ring buffer free
  }
  next();
  // store_run reads element i of a run at s[shift + i], shift being its
  // output's chunk_shift: sel_at is that shift, unsel_at is congruent to it
  const T* none = nullptr;
  store_run<T>(out, t.before, stage, t.count);                     // selected rows to [E, E')
  store_run<T>(out, n - u_before - unselected, none, unselected);  // zeros to [n - U', n - U)
  if constexpr (kSplit) {
    T* unsel = static_cast<T*>(planes.unsel[p]);
    store_run<T>(unsel, u_before, stage + t.unsel_at - chunk_shift<T>(unsel + u_before), unselected);
    store_run<T>(unsel, n - t.before - t.count, none, t.count);  // zeros to [n - E', n - E)
  }
}

// One tile a block: kParts parts of kPartBytes of the launch's widest plane
// W (4 or 8 bytes).  MODE is a compaction or a split (mask or bit form).
template <int W, int MODE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
compact_pass(Planes planes, const uint32_t* __restrict__ mask, int bit, size_t n, unsigned* counter,
             unsigned* status, int* count_out) {
  constexpr int kRows = kPartBytes / W;  // rows a part
  constexpr int kWords = kRows / 32;
  constexpr int kTileWords = kWords * kParts;
  constexpr bool kSplit = MODE != kCompact;
  constexpr int kWordsPerThread = (kTileWords + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Shared<kTileWords> sh;
  unsigned char* stage = smem + kBuffers * kRawBytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    sh.ticket = atomicAdd(counter, 1u);
    sh.words[0] = sh.words[kTileWords + 1] = 0u;
  }
  __syncthreads();
  const unsigned tile = sh.ticket;
  const size_t row0 = static_cast<size_t>(tile) * kRows * kParts;
  const int rows = n - row0 < static_cast<size_t>(kRows) * kParts ? static_cast<int>(n - row0) : kRows * kParts;

  // the selection words: from the mask, or (the split's bit form) the rows of
  // plane 0 whose bit `bit` is zero, a warp ballot a word
  if constexpr (MODE != kSplitBit) {
    for (int k = threadIdx.x; k < kTileWords; k += kThreads) sh.words[k + 1] = mask_word(mask, row0 / 32 + k, n);
  } else {
    const uint32_t* __restrict__ key = static_cast<const uint32_t*>(planes.in[0]);
    constexpr int kUnroll = 4;
    for (int k0 = warp; k0 < kTileWords; k0 += kUnroll * kWarps) {
      uint32_t v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = 32 * (k0 + u * kWarps) + lane;
        v[u] = r < rows ? key[row0 + r] : 0u;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * kWarps;
        const uint32_t word = __ballot_sync(kFull, 32 * k + lane < rows && !((v[u] >> bit) & 1u));
        if (lane == 0 && k < kTileWords) sh.words[k + 1] = word;
      }
    }
  }
  __syncthreads();

  // each word's rank in the tile and the tile's count, published at once
  uint32_t mine[kWordsPerThread];
  int c = 0, count = 0;
#pragma unroll
  for (int j = 0; j < kWordsPerThread; ++j) {
    const int k = threadIdx.x * kWordsPerThread + j;
    mine[j] = k < kTileWords ? sh.words[k + 1] : 0u;
    c += __popc(mine[j]);
  }
  int rank = block_exclusive_sum(c, sh.warp_sums, &count);
#pragma unroll
  for (int j = 0; j < kWordsPerThread; ++j) {
    const int k = threadIdx.x * kWordsPerThread + j;
    if (k < kTileWords) sh.word_rank[k] = rank;
    rank += __popc(mine[j]);
  }
  if (threadIdx.x == 0) publish(status, tile, count);

  // item i of the tile is plane i % P of part i / P; item i goes through ring
  // buffer i % kBuffers, its copy started when item i - kBuffers leaves it
  const int nplanes = planes.count;
  const int nparts = (rows + kRows - 1) / kRows;
  const int items = nparts * nplanes;
  auto start_copy = [&](int i) {
    if (i < items) {
      const int s = i / nplanes;
      copy_plane<kSplit>(planes, i - s * nplanes, smem + (i % kBuffers) * kRawBytes, row0 + static_cast<size_t>(s) * kRows,
                         min(kRows, rows - s * kRows), sh.words + s * kWords);
    }
    commit_copies();
  };
  for (int i = 0; i < kBuffers; ++i) start_copy(i);  // in flight during the look-back
  if (warp == 0) {
    const int before = walk_back(status, tile, count);
    if (lane == 0) {
      sh.before = before;
      if (tile == gridDim.x - 1) *count_out = before + count;
    }
  }
  __syncthreads();
  const size_t before = static_cast<size_t>(sh.before);

  for (int i = 0; i < items; ++i) {
    const int s = i / nplanes, p = i - s * nplanes;
    Part t;
    t.row0 = row0 + static_cast<size_t>(s) * kRows;
    t.rows = min(kRows, rows - s * kRows);
    t.rank0 = sh.word_rank[s * kWords];
    t.count = (s + 1 < nparts ? sh.word_rank[(s + 1) * kWords] : count) - t.rank0;
    t.before = before + t.rank0;
    const uint32_t* words = sh.words + s * kWords;
    const int* word_rank = sh.word_rank + s * kWords;
    const unsigned char* buf = smem + (i % kBuffers) * kRawBytes;
    auto next = [&]() { start_copy(i + kBuffers); };
    const int kind = kSplit ? kValue4 : planes.kind[p];
    if (kind == kValue8) {
      move_plane<uint64_t, kWords, kSplit>(planes, p, buf, stage, t, words, word_rank, n, next, false);
    } else {
      move_plane<uint32_t, kWords, kSplit>(planes, p, buf, stage, t, words, word_rank, n, next, kind == kPackedWords);
    }
  }
}

// ---- host side -------------------------------------------------------------

long long tiles_for(long long n, int rows) { return (n + rows - 1) / rows; }

template <int W, int MODE>
cudaError_t launch(const Planes& planes, const uint32_t* mask, int bit, size_t n, void* scratch, int* count,
                   cudaStream_t s) {
  // the attribute holds for the current device only: set it on every launch
  cudaError_t err =
      cudaFuncSetAttribute(compact_pass<W, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, kDynamicShared);
  if (err != cudaSuccess) return err;
  const long long ntiles = tiles_for(static_cast<long long>(n), kPartBytes / W * kParts);
  err = cudaMemsetAsync(scratch, 0, kStatusOffset + static_cast<size_t>((ntiles + 3) / 4 * 4) * sizeof(unsigned), s);
  if (err != cudaSuccess) return err;
  if (ntiles == 0) return cudaMemsetAsync(count, 0, sizeof(int), s);
  unsigned* counter = static_cast<unsigned*>(scratch);
  unsigned* status = reinterpret_cast<unsigned*>(static_cast<unsigned char*>(scratch) + kStatusOffset);
  compact_pass<W, MODE><<<static_cast<unsigned>(ntiles), kThreads, kDynamicShared, s>>>(
      planes, mask, bit, n, counter, status, count);
  return cudaGetLastError();
}

bool aligned_to(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

// Bytes of scratch a compaction or split of n rows needs (never 0): the
// ticket, then one descriptor a tile of the smallest tile.
extern "C" long long arrow_compact_scratch_bytes(long long n) {
  const long long ntiles = tiles_for(n > 0 ? n : 0, kMinTileRows);
  const long long words = (ntiles + 3) / 4 * 4;  // whole groups of four descriptors
  return static_cast<long long>(kStatusOffset) + (words > 0 ? words : 4) * static_cast<long long>(sizeof(unsigned));
}

// in/out/kinds: host arrays of `nplanes` entries; kinds: 0 = 4-byte value
// plane, 1 = 8-byte value plane, 2 = packed bitmap plane (out: 0/1 int32).
// Each plane is aligned to its element.  mask: ceil(n/32) packed words.
// scratch: arrow_compact_scratch_bytes(n) bytes.  count_out: one device int.
// Returns cudaGetLastError() of the launch.
extern "C" int arrow_compact_multi(const void* const* in, void* const* out, const int* kinds, int nplanes,
                                   const void* mask, long long n, void* scratch, void* count_out,
                                   void* stream) {
  if (nplanes < 0 || nplanes > kMaxPlanes || n < 0 || n >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Planes planes;
  planes.count = nplanes;
  int widest = 4;
  for (int p = 0; p < nplanes; ++p) {
    if (kinds[p] < kValue4 || kinds[p] > kPackedWords) return static_cast<int>(cudaErrorInvalidValue);
    const int width = kinds[p] == kValue8 ? 8 : 4;
    if (!aligned_to(in[p], width) || !aligned_to(out[p], width)) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    if (width == 8) widest = 8;
    planes.in[p] = in[p];
    planes.out[p] = out[p];
    planes.kind[p] = kinds[p];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* m = static_cast<const uint32_t*>(mask);
  int* count = static_cast<int*>(count_out);
  const size_t rows = static_cast<size_t>(n);
  const cudaError_t err = widest == 8 ? launch<8, kCompact>(planes, m, 0, rows, scratch, count, s)
                                      : launch<4, kCompact>(planes, m, 0, rows, scratch, count, s);
  return static_cast<int>(err);
}

// in/sel/unsel: host arrays of `nplanes` (1..8) device pointers to 4-byte
// rows.  mask: ceil(n/32) packed words, or null to select the rows whose
// plane-0 bit `bit` (0..31) is zero.  scratch: arrow_compact_scratch_bytes(n)
// bytes; count_out: one device int (the selected rows).  Returns
// cudaGetLastError() of the launch.
extern "C" int arrow_split_multi(const void* const* in, void* const* sel, void* const* unsel, int nplanes,
                                 const void* mask, int bit, long long n, void* scratch, void* count_out,
                                 void* stream) {
  if (nplanes < 1 || nplanes > kMaxSplitPlanes || n < 0 || n >= (1LL << 31) ||
      (mask == nullptr && (bit < 0 || bit > 31))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Planes planes;
  planes.count = nplanes;
  for (int p = 0; p < nplanes; ++p) {
    if (!aligned_to(in[p], 4) || !aligned_to(sel[p], 4) || !aligned_to(unsel[p], 4)) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    planes.in[p] = in[p];
    planes.out[p] = sel[p];
    planes.unsel[p] = unsel[p];
    planes.kind[p] = kValue4;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* m = static_cast<const uint32_t*>(mask);
  int* count = static_cast<int*>(count_out);
  const size_t rows = static_cast<size_t>(n);
  const cudaError_t err = m == nullptr ? launch<4, kSplitBit>(planes, m, bit, rows, scratch, count, s)
                                       : launch<4, kSplitMask>(planes, m, 0, rows, scratch, count, s);
  return static_cast<int>(err);
}
