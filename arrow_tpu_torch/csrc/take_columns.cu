// Gather of many columns by one or two index planes in one launch: the
// join's output take (compute/join.py hash_join).
//
// Replaces no TPU kernel: the JAX package's join takes each output column
// with ops.take, which XLA compiles to a gather.  It was added because that
// step, as one gather a column, took half of the join's device time on the
// H100: each column widened its u32 index plane to int64, built a live-row
// mask over the whole emit capacity, clamped the index, gathered every row
// (the dead ones too) and wrote the column a second time to zero the dead
// rows (PERF.md section 5).  Same function as ops.swizzle.gather for each
// column: out[i] = src[min(idx[i], rows - 1)] for i < total, zeros (data and
// validity) for i in [total, cap); the validity bits are gathered alike, and
// BOOL data (packed bits) is gathered a bit a row and packed again, LSB
// first, as the port's bitmaps are.
//
// What bounds it on the H100: the random reads.  Each live row of each
// column reads one element at a random place of its source, and the card
// fetches a whole 32-byte sector for it (a 1e8-row source column is 0.4-0.8
// GB, far past the 50 MB L2), so the reads cost 32 bytes a row and column
// whatever the element's width; then each output is written once (cap rows,
// the dead ones as zeros) and each index plane read once (live rows only).
// The arithmetic is a clamp and an address a row.  The design:
//   - one launch takes up to kMaxColumns columns of both sides; each
//     column's descriptor (source, element width or packed bits, the source's
//     rows for the clamp, its validity, which index plane, the outputs) is
//     passed by value in the kernel's parameters, so that nothing is copied
//     from the host and nothing waits for the stream;
//   - a thread owns kRows = 4 consecutive output rows: one 16-byte load of
//     the 4 indices from each plane the launch reads, clamped in registers
//     for every column that reads it;
//   - it issues the gathered loads of kGroup = 4 columns before any of their
//     stores, so that 16 or more independent random reads are in flight a
//     thread, then writes each column's 4 rows with one 4-, 8- or 16-byte
//     store (two for 8-byte elements).  Loading all 16 columns before any
//     store was 15% slower at join q5's shapes (16 columns' loaded rows are
//     144 registers a thread, which leave fewer threads resident), one
//     column at a time the same as four within 2%; L1-bypassing loads
//     (ld.global.cg), streaming stores (st.global.cs) and blocks of 128 or
//     512 threads changed nothing: the random reads run at the card's rate
//     for scattered 32-byte sectors, about 29 G sectors a second (PERF.md);
//   - packed bits (validity, BOOL data): 4 ballots a warp give its 128 rows'
//     bits, which 4 lanes interleave into the warp's 4 output words;
//   - rows at and past `total` read nothing, neither index nor source, and
//     are written as zeros; rows past `cap` are not written.
// Index arithmetic is 64-bit; total <= cap < 2^31.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxColumns = 16;
constexpr int kMaxPlanes = 2;
constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows a thread
constexpr int kGroup = 4;  // columns a thread loads before it stores them
constexpr int kWarpWords = 32 * kRows / 32;  // output bitmap words a warp

enum Kind : int { kBytes1 = 0, kBytes2 = 1, kBytes4 = 2, kBytes8 = 3, kBits = 4 };

struct Column {
  const void* data;               // source values; kBits: packed words
  const uint32_t* validity;       // source validity words, or null
  void* out;                      // cap rows; kBits: ceil(cap / 32) words
  uint32_t* out_validity;         // ceil(cap / 32) words, or null with validity
  unsigned long long rows;        // source rows (kBits: words x 32), at least 1
  unsigned long long valid_rows;  // source validity words x 32
  int kind;
  int plane;
};

struct Params {
  Column col[kMaxColumns];
  const uint32_t* plane[kMaxPlanes];
  long long total;
  long long cap;
  int ncols;
  int planes_read;  // bit p: some column reads plane p
};

// a column's 4 gathered rows (zero where dead) and their validity bits
struct Gathered {
  unsigned long long v[kRows];
  unsigned valid;
};

__device__ __forceinline__ unsigned long long load_elem(int kind, const void* data, unsigned long long j) {
  switch (kind) {
    case kBytes1: return __ldg(static_cast<const unsigned char*>(data) + j);
    case kBytes2: return __ldg(static_cast<const unsigned short*>(data) + j);
    case kBytes4: return __ldg(static_cast<const unsigned*>(data) + j);
    case kBytes8: return __ldg(static_cast<const unsigned long long*>(data) + j);
    default: return (__ldg(static_cast<const unsigned*>(data) + (j >> 5)) >> (j & 31)) & 1u;
  }
}

__device__ __forceinline__ void gather(const Column& c, const uint32_t (&i0)[kRows], const uint32_t (&i1)[kRows],
                                       int live, Gathered& g) {
  g.valid = 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    g.v[r] = 0;
    if (r < live) {
      const unsigned long long i = c.plane == 0 ? i0[r] : i1[r];
      g.v[r] = load_elem(c.kind, c.data, i < c.rows ? i : c.rows - 1);
      if (c.validity != nullptr) {
        const unsigned long long j = i < c.valid_rows ? i : c.valid_rows - 1;
        g.valid |= ((__ldg(c.validity + (j >> 5)) >> (j & 31)) & 1u) << r;
      }
    }
  }
}

// 8 bits to bits 0, 4, ..., 28
__device__ __forceinline__ uint32_t spread4(uint32_t x) {
  x = (x | (x << 12)) & 0x000F000Fu;
  x = (x | (x << 6)) & 0x03030303u;
  return (x | (x << 3)) & 0x11111111u;
}

// The warp's 128 rows of one bitmap, row r of lane l in bit r of bits[l],
// as its kWarpWords words from word0 on; every lane of the warp calls it.
__device__ __forceinline__ void store_bits(uint32_t* out, unsigned bits, int lane, long long word0,
                                           long long nwords) {
  uint32_t b[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) b[r] = __ballot_sync(0xFFFFFFFFu, (bits >> r) & 1u);
  const long long w = word0 + lane;
  if (lane < kWarpWords && w < nwords) {
    // bit 4j + r of word k is row r of lane 8k + j: bit 8k + j of b[r]
    uint32_t word = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) word |= spread4((b[r] >> (8 * lane)) & 0xFFu) << r;
    out[w] = word;
  }
}

template <typename T>
__device__ __forceinline__ void store_rows(void* out, long long base, int inside, const Gathered& g) {
  T* o = static_cast<T*>(out) + base;
  if (inside == kRows) {
    if constexpr (sizeof(T) <= 2) {  // 4 rows packed in one 4-byte or two 4-byte words
      constexpr int kPer = 4 / sizeof(T);
      uint32_t w[sizeof(T)] = {};
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        w[r / kPer] |= static_cast<uint32_t>(static_cast<T>(g.v[r])) << (8 * sizeof(T) * (r % kPer));
      }
      if constexpr (sizeof(T) == 1) {
        *reinterpret_cast<uint32_t*>(o) = w[0];
      } else {
        *reinterpret_cast<uint2*>(o) = make_uint2(w[0], w[1]);
      }
    } else if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<uint4*>(o) = make_uint4(static_cast<uint32_t>(g.v[0]), static_cast<uint32_t>(g.v[1]),
                                                static_cast<uint32_t>(g.v[2]), static_cast<uint32_t>(g.v[3]));
    } else {
      reinterpret_cast<ulonglong2*>(o)[0] = make_ulonglong2(g.v[0], g.v[1]);
      reinterpret_cast<ulonglong2*>(o)[1] = make_ulonglong2(g.v[2], g.v[3]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r < inside) o[r] = static_cast<T>(g.v[r]);
    }
  }
}

// Warp-uniform branches only around store_bits: a column's kind and its
// validity are the same for every lane.
__device__ __forceinline__ void put(const Column& c, const Gathered& g, long long base, int inside, int lane,
                                    long long word0, long long nwords) {
  switch (c.kind) {
    case kBytes1: store_rows<uint8_t>(c.out, base, inside, g); break;
    case kBytes2: store_rows<uint16_t>(c.out, base, inside, g); break;
    case kBytes4: store_rows<uint32_t>(c.out, base, inside, g); break;
    case kBytes8: store_rows<unsigned long long>(c.out, base, inside, g); break;
    default: {
      unsigned bits = 0;
#pragma unroll
      for (int r = 0; r < kRows; ++r) bits |= static_cast<unsigned>(g.v[r]) << r;
      store_bits(static_cast<uint32_t*>(c.out), bits, lane, word0, nwords);
    }
  }
  if (c.out_validity != nullptr) store_bits(c.out_validity, g.valid, lane, word0, nwords);
}

__device__ __forceinline__ void load_indices(const uint32_t* plane, long long base, int live, uint32_t (&idx)[kRows]) {
  if (live == kRows) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(plane + base));
    idx[0] = v.x, idx[1] = v.y, idx[2] = v.z, idx[3] = v.w;
  } else {
#pragma unroll
    for (int r = 0; r < kRows; ++r) idx[r] = r < live ? __ldg(plane + base + r) : 0u;
  }
}

// Every lane of every warp runs to the end (the ballots need the whole
// warp); a lane past `cap` stores nothing.  The descriptors are read in
// place from the parameter space (__grid_constant__: no local copy).
__global__ void __launch_bounds__(kThreads) take_columns_kernel(const __grid_constant__ Params p) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long base = t * kRows;
  const int lane = threadIdx.x & 31;
  const long long word0 = (base - lane * kRows) / 32;
  const long long nwords = (p.cap + 31) / 32;
  const long long live_rows = p.total - base, inside_rows = p.cap - base;
  const int live = live_rows <= 0 ? 0 : (live_rows >= kRows ? kRows : static_cast<int>(live_rows));
  const int inside = inside_rows <= 0 ? 0 : (inside_rows >= kRows ? kRows : static_cast<int>(inside_rows));
  uint32_t i0[kRows] = {0, 0, 0, 0}, i1[kRows] = {0, 0, 0, 0};
  if (live > 0) {
    if (p.planes_read & 1) load_indices(p.plane[0], base, live, i0);
    if (p.planes_read & 2) load_indices(p.plane[1], base, live, i1);
  }
#pragma unroll
  for (int c0 = 0; c0 < kMaxColumns; c0 += kGroup) {
    if (c0 < p.ncols) {
      Gathered g[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (c0 + k < p.ncols) gather(p.col[c0 + k], i0, i1, live, g[k]);
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        if (c0 + k < p.ncols) put(p.col[c0 + k], g[k], base, inside, lane, word0, nwords);
      }
    }
  }
}

bool aligned_to(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

// Column c: data[c] (its rows[c] rows; kind 4: packed words, rows = words x
// 32), validity[c] (valid_rows[c] bits) or null, out[c] (cap rows, or
// ceil(cap / 32) words for kind 4), out_validity[c] (ceil(cap / 32) words;
// null where validity[c] is), kinds[c] (0-3: 1, 2, 4 or 8 bytes, 4: packed
// bits), planes[c] (the index plane it reads).  index_planes: nplanes (1 or
// 2) device pointers to cap u32 rows each, 16-byte aligned.  At most 16
// columns.  Returns cudaGetLastError() of the launch.
extern "C" int arrow_take_columns(const void* const* data, const void* const* validity, void* const* out,
                                  void* const* out_validity, const long long* rows, const long long* valid_rows,
                                  const int* kinds, const int* planes, int ncols, const void* const* index_planes,
                                  int nplanes, long long total, long long cap, void* stream) {
  if (ncols < 1 || ncols > kMaxColumns || nplanes < 1 || nplanes > kMaxPlanes || cap < 0 || cap >= (1LL << 31) ||
      total < 0 || total > cap) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = {};
  p.total = total;
  p.cap = cap;
  p.ncols = ncols;
  for (int q = 0; q < nplanes; ++q) {
    if (!aligned_to(index_planes[q], 16)) return static_cast<int>(cudaErrorMisalignedAddress);
    p.plane[q] = static_cast<const uint32_t*>(index_planes[q]);
  }
  static const int kWidth[] = {1, 2, 4, 8, 4};
  for (int c = 0; c < ncols; ++c) {
    const int kind = kinds[c];
    if (kind < kBytes1 || kind > kBits || planes[c] < 0 || planes[c] >= nplanes || rows[c] < 1 ||
        (validity[c] == nullptr) != (out_validity[c] == nullptr) || (validity[c] != nullptr && valid_rows[c] < 1)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const int w = kWidth[kind];
    if (!aligned_to(data[c], w) || !aligned_to(out[c], kind == kBits ? 4 : w * kRows) ||
        !aligned_to(validity[c], 4) || !aligned_to(out_validity[c], 4)) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    Column& col = p.col[c];
    col.data = data[c];
    col.validity = static_cast<const uint32_t*>(validity[c]);
    col.out = out[c];
    col.out_validity = static_cast<uint32_t*>(out_validity[c]);
    col.rows = static_cast<unsigned long long>(rows[c]);
    col.valid_rows = static_cast<unsigned long long>(validity[c] != nullptr ? valid_rows[c] : 1);
    col.kind = kind;
    col.plane = planes[c];
    p.planes_read |= 1 << planes[c];
  }
  if (cap == 0) return static_cast<int>(cudaSuccess);
  const long long threads = (cap + kRows - 1) / kRows;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  take_columns_kernel<<<blocks, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
