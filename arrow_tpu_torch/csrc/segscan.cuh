// Inclusive segmented (or plain) scan of one to three planes (kernel B2):
// the kernel.  segscan.cu instantiates it for the 4-byte types and holds the
// entry points; segscan_wide.cu instantiates it for the 8-byte types.  The two
// translation units build in parallel.
//
// Replaces arrow_tpu/compute/kernels/segscan.py::segscan_pallas (planes of
// one dtype that share one flag plane) and segmented_scan_pallas (its
// one-plane call), the Pallas kernel built by `_make_kernel`.  Same function,
// in flat order, on each plane:
//   out[i] = vals[i]                      if flags[i] or i == 0
//            combine(out[i-1], vals[i])   otherwise
// with combine in {add, max, min, first}.  first is not commutative: every
// combine here keeps the older operand on the left.
//
// Types: i32, u32, f32, i64, u64, f64.  u32/u64 arrive as the same bits as
// i32/i64 (the port stores unsigned values as signed patterns) and compare
// unsigned for max/min.  Integer adds wrap.  Float max/min propagate NaN, as
// jnp.maximum/jnp.minimum and torch.maximum/torch.minimum do.  64-bit adds
// need no limb pairs on the GPU.  Because f64 add is covered, the group-by's
// f64 sum accumulator runs through this kernel on the card; the JAX package
// computed that accumulator with its log-depth XLA ladder only because Pallas
// on the TPU had no f64.  The result is the same function.
//
// What bounds it on the H100: bytes, each plane read once and written once
// and the flag bytes read once.  The TPU kernel carries the running
// aggregate from one grid step to the next; GPU blocks run in parallel in no
// order, so this is a single-pass scan with decoupled look-back (Merrill and
// Garland, "Single-pass Parallel Prefix Scan with Decoupled Look-back",
// NVIDIA 2016), which moves just those bytes.  It scans (flag, value) pairs
// with the associative operator
//   (f1, v1) . (f2, v2) = (f1 | f2, f2 ? v2 : combine(v1, v2)).
// One launch; each block takes one 16 KB tile of each plane (128 threads x
// 32 rows, 16 rows for 8-byte types) and
//   1. takes its tile index from an atomic counter in the scratch, not from
//      blockIdx.x: blocks are not scheduled in index order, and a block that
//      waited on a tile that no resident block holds would hang the card;
//   2. loads its rows and flags once: 16-byte coalesced loads (lane l on
//      bytes 16l..16l+15), staged through shared memory into each thread's
//      consecutive rows; a thread's flag bytes are two 16-byte loads (one
//      for 8-byte types);
//   3. scans its rows per thread, then across the block, and publishes the
//      tile's aggregate pair;
//   4. warp 0 looks back over the predecessors' descriptors, 32 at a time,
//      combined oldest first (lane 0 the oldest), and stops at the first
//      inclusive prefix or the first set flag: a segment start makes
//      everything older irrelevant, so with dense flags it takes one step;
//   5. publishes the tile's inclusive prefix and writes its rows once,
//      staged back through shared memory.
// Descriptors: a 64-bit status word per tile holds the status (0 not yet, 1
// aggregate, 2 inclusive prefix) and the flag.  A one-plane scan with a
// 4-byte carry packs the value into the same word, written with one store.
// Otherwise the values sit in arrays of their own (aggregates, prefixes),
// stored before the status word with release order and read after it with
// acquire order.  The scratch is zeroed on the stream at every call.
// An f32 add carries its tile prefixes and each thread's running prefix in
// f64 and rounds each output row once: a chain of 32 768 tile prefixes
// rounded in f32 at every link could miss the rtol of 1e-6 it is held to.
// Rows past n act as (0, identity), a right identity of the operator; a left
// identity does not exist for `first`, so the first tile and thread start
// from their own first row.  The ragged last tile, and a call whose pointers
// are not all 16-byte aligned (a view with a storage offset), load and store
// element by element through the same staging.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Tile shape: of 128 threads x 128 bytes a thread, 256 x 64, 256 x 128,
// 512 x 64 and 64 x 128, the first was best or within 6% of best on every
// call timed (tools/segscan_tile_shapes.py): more bytes in flight per SM
// than 256 x 64, and fewer block-wide steps per byte.
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kThreadBytes = 128;  // a thread's rows of one plane: 32 x 4 B or 16 x 8 B
static_assert(kThreadBytes == 64 || kThreadBytes == 128, "a thread's flags are 8, 16 or 32 bytes");
constexpr int kChunks = kThreads * kThreadBytes / 16;  // 16-byte chunks of a staged plane
constexpr int kMaxPlanes = 3;
constexpr int kHeaderBytes = 128;  // the tile counter
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kAggregate = 1, kPrefix = 2;

enum DType : int { kI32 = 0, kU32 = 1, kF32 = 2, kI64 = 3, kU64 = 4, kF64 = 5 };
enum Op : int { kAdd = 0, kMax = 1, kMin = 2, kFirst = 3 };

template <typename C, int NP>
struct Pair {
  C v[NP];
  int f;
};

// the type a plane's prefixes are carried in: f64 for an f32 add
template <typename T> struct AddCarry { using type = T; };
template <> struct AddCarry<float> { using type = double; };

template <typename T> __device__ __forceinline__ bool is_nan(T) { return false; }
template <> __device__ __forceinline__ bool is_nan<float>(float x) { return isnan(x); }
template <> __device__ __forceinline__ bool is_nan<double>(double x) { return isnan(x); }

// wrapping add: signed overflow is done in the unsigned type
template <typename T> __device__ __forceinline__ T add(T a, T b) { return a + b; }
template <> __device__ __forceinline__ int add<int>(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
template <> __device__ __forceinline__ long long add<long long>(long long a, long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}

// the value a missing row past n takes: combine(v, identity) == v
template <typename T, int OP> __device__ __forceinline__ T right_identity();
#define ARROW_IDENTITIES(T, LOWEST, HIGHEST)                                        \
  template <> __device__ __forceinline__ T right_identity<T, kAdd>() { return static_cast<T>(0); } \
  template <> __device__ __forceinline__ T right_identity<T, kFirst>() { return static_cast<T>(0); } \
  template <> __device__ __forceinline__ T right_identity<T, kMax>() { return LOWEST; } \
  template <> __device__ __forceinline__ T right_identity<T, kMin>() { return HIGHEST; }
ARROW_IDENTITIES(int, INT32_MIN, INT32_MAX)
ARROW_IDENTITIES(unsigned, 0u, UINT32_MAX)
ARROW_IDENTITIES(float, -INFINITY, INFINITY)
ARROW_IDENTITIES(long long, INT64_MIN, INT64_MAX)
ARROW_IDENTITIES(unsigned long long, 0ull, UINT64_MAX)
ARROW_IDENTITIES(double, -static_cast<double>(INFINITY), static_cast<double>(INFINITY))
#undef ARROW_IDENTITIES

template <typename T, int OP>
__device__ __forceinline__ T combine(T a, T b) {
  if (OP == kAdd) return add<T>(a, b);
  if (OP == kFirst) return a;
  if (is_nan<T>(a)) return a;
  if (is_nan<T>(b)) return b;
  if (OP == kMax) return a < b ? b : a;
  return b < a ? b : a;
}

template <typename C, int OP, int NP>
__device__ __forceinline__ Pair<C, NP> combine_pairs(const Pair<C, NP>& a, const Pair<C, NP>& b) {
  Pair<C, NP> r;
#pragma unroll
  for (int p = 0; p < NP; ++p) r.v[p] = b.f ? b.v[p] : combine<C, OP>(a.v[p], b.v[p]);
  r.f = a.f | b.f;
  return r;
}

template <typename C, int OP, int NP>
__device__ __forceinline__ Pair<C, NP> identity_pair() {
  Pair<C, NP> r;
#pragma unroll
  for (int p = 0; p < NP; ++p) r.v[p] = right_identity<C, OP>();
  r.f = 0;
  return r;
}

template <typename C, int NP>
__device__ __forceinline__ Pair<C, NP> shfl_up(const Pair<C, NP>& x, int d) {
  Pair<C, NP> y;
#pragma unroll
  for (int p = 0; p < NP; ++p) y.v[p] = __shfl_up_sync(kFull, x.v[p], d);
  y.f = __shfl_up_sync(kFull, x.f, d);
  return y;
}

template <typename C, int NP>
__device__ __forceinline__ Pair<C, NP> shfl(const Pair<C, NP>& x, int lane) {
  Pair<C, NP> y;
#pragma unroll
  for (int p = 0; p < NP; ++p) y.v[p] = __shfl_sync(kFull, x.v[p], lane);
  y.f = __shfl_sync(kFull, x.f, lane);
  return y;
}

template <typename C, int OP, int NP>
__device__ __forceinline__ Pair<C, NP> warp_inclusive(Pair<C, NP> x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Pair<C, NP> y = shfl_up(x, d);
    if (lane >= d) x = combine_pairs<C, OP, NP>(y, x);
  }
  return x;
}

// Block-wide scan of one pair per thread, in thread order: warp shuffle
// scans, then warp 0 scans the warp totals the same way.  Gives the thread's
// exclusive pair (none for thread 0); warp_tot[kWarps - 1] is then the
// tile's aggregate.
template <typename C, int OP, int NP>
__device__ __forceinline__ bool block_exclusive(const Pair<C, NP>& x, Pair<C, NP>* warp_tot,
                                                Pair<C, NP>& excl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Pair<C, NP> incl = warp_inclusive<C, OP, NP>(x, lane);
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    Pair<C, NP> t = lane < kWarps ? warp_tot[lane] : identity_pair<C, OP, NP>();
    t = warp_inclusive<C, OP, NP>(t, lane);
    if (lane < kWarps) warp_tot[lane] = t;
  }
  __syncthreads();
  const Pair<C, NP> up = shfl_up(incl, 1);
  if (lane > 0) {
    excl = warp > 0 ? combine_pairs<C, OP, NP>(warp_tot[warp - 1], up) : up;
    return true;
  }
  if (warp > 0) {
    excl = warp_tot[warp - 1];
    return true;
  }
  return false;
}

// ---- tile descriptors ------------------------------------------------------

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" : : "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned bits32(int x) { return static_cast<unsigned>(x); }
__device__ __forceinline__ unsigned bits32(unsigned x) { return x; }
__device__ __forceinline__ unsigned bits32(float x) { return __float_as_uint(x); }
template <typename C> __device__ __forceinline__ C from_bits32(unsigned b);
template <> __device__ __forceinline__ int from_bits32<int>(unsigned b) { return static_cast<int>(b); }
template <> __device__ __forceinline__ unsigned from_bits32<unsigned>(unsigned b) { return b; }
template <> __device__ __forceinline__ float from_bits32<float>(unsigned b) { return __uint_as_float(b); }

// Status word: bits 0-1 the status, bit 2 the flag, bits 32-63 the value
// when packed.
template <typename C, int NP>
struct Descriptors {
  static constexpr bool kPacked = NP == 1 && sizeof(C) == 4;
  unsigned long long* status;
  C* aggregate;  // ntiles x NP, when not packed
  C* prefix;     // ntiles x NP, when not packed

  __device__ __forceinline__ void publish(int tile, unsigned long long st, const Pair<C, NP>& x) const {
    unsigned long long word = st | (static_cast<unsigned long long>(x.f) << 2);
    if constexpr (kPacked) {
      word |= static_cast<unsigned long long>(bits32(x.v[0])) << 32;
    } else {
      C* dst = (st == kPrefix ? prefix : aggregate) + static_cast<size_t>(tile) * NP;
#pragma unroll
      for (int p = 0; p < NP; ++p) __stcg(dst + p, x.v[p]);
    }
    store_release(status + tile, word);
  }

  // Spins until `tile` has published; returns its status and pair.
  __device__ __forceinline__ unsigned long long wait(int tile, Pair<C, NP>& x) const {
    unsigned long long word;
    do {
      word = load_acquire(status + tile);
    } while ((word & 3) == 0);
    const unsigned long long st = word & 3;
    x.f = static_cast<int>((word >> 2) & 1);
    if constexpr (kPacked) {
      x.v[0] = from_bits32<C>(static_cast<unsigned>(word >> 32));
    } else {
      const C* src = (st == kPrefix ? prefix : aggregate) + static_cast<size_t>(tile) * NP;
#pragma unroll
      for (int p = 0; p < NP; ++p) x.v[p] = __ldcg(src + p);
    }
    return st;
  }
};

// The exclusive prefix of `tile` (> 0), for every lane of the calling warp.
template <typename C, int OP, int NP>
__device__ Pair<C, NP> look_back(const Descriptors<C, NP>& d, int tile) {
  const int lane = threadIdx.x & 31;
  Pair<C, NP> acc;  // the tiles after the current window, up to tile - 1
  bool have = false;
  for (int newest = tile - 1;; newest -= 32) {
    const int t = newest - 31 + lane;  // lane 31 the newest, lane 0 the oldest
    Pair<C, NP> x = identity_pair<C, OP, NP>();
    bool stop = false;
    if (t >= 0) {
      const unsigned long long st = d.wait(t, x);
      stop = st == kPrefix || x.f;
    }
    // tile 0 publishes its prefix at once, so a window that reaches below
    // tile 0 always holds a stop
    const unsigned stops = __ballot_sync(kFull, stop);
    const int oldest = stops ? 31 - __clz(stops) : 0;
    // scan lanes oldest..31 in order; the older lanes take no part
    const bool in = lane >= oldest;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const Pair<C, NP> y = shfl_up(x, s);
      const bool y_in = __shfl_up_sync(kFull, static_cast<int>(in), s) != 0;
      if (lane >= s && in && y_in) x = combine_pairs<C, OP, NP>(y, x);
    }
    const Pair<C, NP> w = shfl(x, 31);
    acc = have ? combine_pairs<C, OP, NP>(w, acc) : w;
    have = true;
    if (stops) return acc;
  }
}

// ---- staging ---------------------------------------------------------------

// 16-byte chunk c of a staged plane lives in slot swizzle(c): a warp's run of
// consecutive chunks, and chunk j of each of 8 neighbouring threads' runs of 4
// or 8 chunks, then fall in distinct banks.
__device__ __forceinline__ int swizzle(int c) { return c ^ ((c >> 3) & 7); }

template <typename T>
union Chunks {
  uint4 c[kThreadBytes / 16];
  T v[kThreadBytes / sizeof(T)];
};

template <typename T>
__device__ __forceinline__ T* staged(unsigned char* stage, int e) {
  constexpr int kPerChunk = 16 / sizeof(T);
  return reinterpret_cast<T*>(stage + swizzle(e / kPerChunk) * 16) + e % kPerChunk;
}

// The tile's rows of one plane into shared memory, then this thread's rows
// into registers.  Rows past n are left unset.
template <typename T>
__device__ __forceinline__ Chunks<T> load_rows(const T* src, size_t base, size_t n, bool vec,
                                               unsigned char* stage) {
  constexpr int kItems = kThreadBytes / sizeof(T);
  uint4* s4 = reinterpret_cast<uint4*>(stage);
  if (vec) {
    const uint4* g = reinterpret_cast<const uint4*>(src + base);
#pragma unroll
    for (int j = 0; j < kChunks / kThreads; ++j) {
      const int c = threadIdx.x + j * kThreads;
      s4[swizzle(c)] = __ldcs(g + c);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int e = threadIdx.x + j * kThreads;
      if (base + e < n) *staged<T>(stage, e) = src[base + e];
    }
  }
  __syncthreads();
  Chunks<T> mine;
#pragma unroll
  for (int j = 0; j < kThreadBytes / 16; ++j) mine.c[j] = s4[swizzle(threadIdx.x * (kThreadBytes / 16) + j)];
  __syncthreads();  // the stage is reused
  return mine;
}

// This thread's rows into shared memory, then the tile's rows of one plane
// out; rows past n are not written.
template <typename T>
__device__ __forceinline__ void store_rows(const Chunks<T>& mine, T* dst, size_t base, size_t n,
                                           bool vec, unsigned char* stage) {
  constexpr int kItems = kThreadBytes / sizeof(T);
  uint4* s4 = reinterpret_cast<uint4*>(stage);
#pragma unroll
  for (int j = 0; j < kThreadBytes / 16; ++j) s4[swizzle(threadIdx.x * (kThreadBytes / 16) + j)] = mine.c[j];
  __syncthreads();
  if (vec) {
    uint4* g = reinterpret_cast<uint4*>(dst + base);
#pragma unroll
    for (int j = 0; j < kChunks / kThreads; ++j) {
      const int c = threadIdx.x + j * kThreads;
      g[c] = s4[swizzle(c)];
    }
  } else {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int e = threadIdx.x + j * kThreads;
      if (base + e < n) dst[base + e] = *staged<T>(stage, e);
    }
  }
  __syncthreads();  // the stage is reused
}

// Bit k set when this thread's row k starts a segment (rows past n: 0).
template <int kItems>
__device__ __forceinline__ unsigned load_flags(const uint8_t* flags, size_t base, size_t n, bool vec,
                                               uint8_t* fstage) {
  union {
    uint4 v16[2];
    uint2 v8;
    unsigned w[8];
  } b;
  const uint8_t* src = vec ? flags + base + static_cast<size_t>(threadIdx.x) * kItems
                           : fstage + threadIdx.x * kItems;
  if (!vec) {
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int e = threadIdx.x + j * kThreads;
      fstage[e] = base + e < n ? flags[base + e] : 0;
    }
    __syncthreads();
  }
  if constexpr (kItems == 8) {
    b.v8 = *reinterpret_cast<const uint2*>(src);
  } else {
#pragma unroll
    for (int j = 0; j < kItems / 16; ++j) b.v16[j] = reinterpret_cast<const uint4*>(src)[j];
  }
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < kItems; ++k) bits |= ((b.w[k >> 2] >> (8 * (k & 3))) & 0xffu) ? (1u << k) : 0u;
  return bits;
}

// ---- the kernel ------------------------------------------------------------

template <typename T, int NP>
struct Args {
  const T* in[NP];
  T* out[NP];
  const uint8_t* flags;  // null: a plain scan
  size_t n;
  int aligned;  // every pointer 16-byte aligned
  unsigned* counter;
  unsigned long long* status;
  void* values;  // aggregates, then prefixes (not packed)
  int ntiles;
};

template <typename T, typename C, int OP, int NP>
__global__ void __launch_bounds__(kThreads) seg_lookback(Args<T, NP> a) {
  constexpr int kItems = kThreadBytes / sizeof(T);
  constexpr int kTile = kThreads * kItems;
  __shared__ alignas(16) unsigned char stage[kChunks * 16];
  __shared__ alignas(16) uint8_t fstage[kTile];
  __shared__ Pair<C, NP> warp_tot[kWarps];
  __shared__ Pair<C, NP> tile_excl;
  __shared__ int tile_index;

  if (threadIdx.x == 0) tile_index = static_cast<int>(atomicAdd(a.counter, 1u));
  __syncthreads();
  const int tile = tile_index;
  const size_t base = static_cast<size_t>(tile) * kTile;
  const size_t first = base + static_cast<size_t>(threadIdx.x) * kItems;  // this thread's first row
  const bool vec = a.aligned && base + kTile <= a.n;
  const unsigned fbits = a.flags ? load_flags<kItems>(a.flags, base, a.n, vec, fstage) : 0u;

  C item[NP][kItems];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const Chunks<T> rows = load_rows<T>(a.in[p], base, a.n, vec, stage);
#pragma unroll
    for (int k = 0; k < kItems; ++k)
      item[p][k] = first + k < a.n ? static_cast<C>(rows.v[k]) : right_identity<C, OP>();
  }

  // the thread's own inclusive pairs first: a float sum then adds the large
  // prefix once per row instead of rounding each row onto it in turn
#pragma unroll
  for (int k = 1; k < kItems; ++k) {
    if (!((fbits >> k) & 1u)) {
#pragma unroll
      for (int p = 0; p < NP; ++p) item[p][k] = combine<C, OP>(item[p][k - 1], item[p][k]);
    }
  }
  Pair<C, NP> mine;
#pragma unroll
  for (int p = 0; p < NP; ++p) mine.v[p] = item[p][kItems - 1];
  mine.f = fbits != 0;
  Pair<C, NP> texcl;
  const bool has_texcl = block_exclusive<C, OP, NP>(mine, warp_tot, texcl);

  if (threadIdx.x < 32) {
    const Descriptors<C, NP> d{a.status, static_cast<C*>(a.values),
                               static_cast<C*>(a.values) + static_cast<size_t>(a.ntiles) * NP};
    const Pair<C, NP> agg = warp_tot[kWarps - 1];
    if (tile == 0) {
      if (threadIdx.x == 0) d.publish(0, kPrefix, agg);
    } else {
      if (threadIdx.x == 0) d.publish(tile, kAggregate, agg);
      const Pair<C, NP> excl = look_back<C, OP, NP>(d, tile);
      if (threadIdx.x == 0) {
        d.publish(tile, kPrefix, combine_pairs<C, OP, NP>(excl, agg));
        tile_excl = excl;
      }
    }
  }
  __syncthreads();

  // the pair of every row before this thread's first row, if there is one
  bool has = tile > 0;
  Pair<C, NP> run;
  if (has) run = tile_excl;
  if (has_texcl) {
    run = has ? combine_pairs<C, OP, NP>(run, texcl) : texcl;
    has = true;
  }
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    Chunks<T> rows;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const bool started = (fbits & ((2u << k) - 1u)) != 0;  // a segment starts in rows 0..k
      rows.v[k] = static_cast<T>(has && !started ? combine<C, OP>(run.v[p], item[p][k]) : item[p][k]);
    }
    store_rows<T>(rows, a.out[p], base, a.n, vec, stage);
  }
}

// ---- host side -------------------------------------------------------------

inline int item_bytes(int dtype) { return dtype == kI32 || dtype == kU32 || dtype == kF32 ? 4 : 8; }
inline int carry_bytes(int dtype, int op) { return dtype == kF32 && op == kAdd ? 8 : item_bytes(dtype); }

inline long long tiles_for(long long n, int dtype) {
  const long long tile = static_cast<long long>(kThreads) * (kThreadBytes / item_bytes(dtype));
  return (n + tile - 1) / tile;
}

inline long long scratch_bytes(long long n, int dtype, int op, int nplanes) {
  const long long ntiles = tiles_for(n, dtype);
  const bool packed = nplanes == 1 && carry_bytes(dtype, op) == 4;
  return kHeaderBytes + ntiles * 8 + (packed ? 0 : 2 * ntiles * nplanes * carry_bytes(dtype, op));
}

struct Call {
  const void* const* in;
  void* const* out;
  const uint8_t* flags;
  size_t n;
  int aligned;
  unsigned char* scratch;
  long long ntiles;
  cudaStream_t stream;
};

inline Call make_call(const void* const* in, void* const* out, const void* flags, long long n, int aligned,
                      void* scratch, int dtype, void* stream) {
  return Call{in, out, static_cast<const uint8_t*>(flags), static_cast<size_t>(n), aligned,
              static_cast<unsigned char*>(scratch), tiles_for(n, dtype), static_cast<cudaStream_t>(stream)};
}

template <typename T, typename C, int OP, int NP>
cudaError_t launch(const Call& c) {
  Args<T, NP> a;
  for (int p = 0; p < NP; ++p) {
    a.in[p] = static_cast<const T*>(c.in[p]);
    a.out[p] = static_cast<T*>(c.out[p]);
  }
  a.flags = c.flags;
  a.n = c.n;
  a.aligned = c.aligned;
  a.counter = reinterpret_cast<unsigned*>(c.scratch);
  a.status = reinterpret_cast<unsigned long long*>(c.scratch + kHeaderBytes);
  a.values = c.scratch + kHeaderBytes + c.ntiles * 8;
  a.ntiles = static_cast<int>(c.ntiles);
  seg_lookback<T, C, OP, NP><<<static_cast<unsigned>(c.ntiles), kThreads, 0, c.stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename C, int OP>
cudaError_t launch_planes(int nplanes, const Call& c) {
  switch (nplanes) {
    case 1: return launch<T, C, OP, 1>(c);
    case 2: return launch<T, C, OP, 2>(c);
    case 3: return launch<T, C, OP, 3>(c);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_op(int op, int nplanes, const Call& c) {
  switch (op) {
    case kAdd: return launch_planes<T, typename AddCarry<T>::type, kAdd>(nplanes, c);
    case kMax: return launch_planes<T, T, kMax>(nplanes, c);
    case kMin: return launch_planes<T, T, kMin>(nplanes, c);
    case kFirst: return launch_planes<T, T, kFirst>(nplanes, c);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The launch of the 8-byte types (segscan_wide.cu), on arguments that
// arrow_segscan has checked and scratch it has zeroed.
cudaError_t arrow_segscan_wide(const void* const* in, void* const* out, int nplanes, const void* flags,
                               int dtype, int op, long long n, int aligned, void* scratch, void* stream);
