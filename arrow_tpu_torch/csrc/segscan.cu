// Inclusive segmented (or plain) scan of one plane (kernel B2).
//
// Replaces arrow_tpu/compute/kernels/segscan.py::segscan_pallas /
// segmented_scan_pallas (the Pallas kernel built by `_make_kernel`).  Same
// function, in flat order:
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
// What bounds it on the H100: bytes.  It reads the values (and 1-byte flags)
// once for the tile aggregates and once more for the scan, and writes the
// output once: about 3 x width x n bytes (+ 2n for flags).  The scan works
// on (flag, value) pairs with the associative operator
//   (f1, v1) . (f2, v2) = (f1 | f2, f2 ? v2 : combine(v1, v2)),
// as a three-phase reduce-then-scan:
//   1. seg_tile_reduce: one block per 4096-row tile (256 threads x 16
//      consecutive rows) reduces the tile to one pair;
//   2. seg_scan_tiles: one block of 1024 threads scans the tile pairs in
//      place (inclusive), 1024 tiles per step;
//   3. seg_tile_scan: each tile scans its rows again, seeded with the
//      inclusive pair of the tiles before it.
// Rows past n act as (0, identity), a right identity of the operator, so the
// ragged last tile needs no special case; a left identity does not exist for
// `first`, so the first tile and thread start from their own first row.
// A decoupled look-back single pass, and staging the tile through shared
// memory for coalesced loads, are later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int kTile = kThreads * kItems;
constexpr int kScanThreads = 1024;  // the one block that scans the tile pairs
constexpr int kScanWarps = kScanThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

enum DType : int { kI32 = 0, kU32 = 1, kF32 = 2, kI64 = 3, kU64 = 4, kF64 = 5 };
enum Op : int { kAdd = 0, kMax = 1, kMin = 2, kFirst = 3 };

template <typename T>
struct Pair {
  T v;
  int f;
};

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

template <typename T, int OP>
__device__ __forceinline__ Pair<T> combine(Pair<T> a, Pair<T> b) {
  Pair<T> r;
  r.v = b.f ? b.v : combine<T, OP>(a.v, b.v);
  r.f = a.f | b.f;
  return r;
}

template <typename T, int OP>
__device__ __forceinline__ Pair<T> load(const T* vals, const uint8_t* flags, size_t i, size_t n) {
  Pair<T> p;
  if (i < n) {
    p.v = vals[i];
    p.f = flags ? (flags[i] != 0) : 0;
  } else {
    p.v = right_identity<T, OP>();
    p.f = 0;
  }
  return p;
}

template <typename T, int OP>
__device__ __forceinline__ Pair<T> warp_inclusive(Pair<T> x, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    Pair<T> y;
    y.v = __shfl_up_sync(kFull, x.v, d);
    y.f = __shfl_up_sync(kFull, x.f, d);
    if (lane >= d) x = combine<T, OP>(y, x);
  }
  return x;
}

// Inclusive scan of one pair per thread over a block of NWARPS warps, in
// thread order: warp shuffle scans, then warp 0 scans the warp totals the
// same way, so every result is a log-depth chain of combines.
template <typename T, int OP, int NWARPS>
__device__ __forceinline__ Pair<T> block_inclusive(Pair<T> x, Pair<T>* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_inclusive<T, OP>(x, lane);
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    Pair<T> t;
    if (lane < NWARPS) {
      t = warp_tot[lane];
    } else {
      t.v = right_identity<T, OP>();
      t.f = 0;
    }
    t = warp_inclusive<T, OP>(t, lane);
    if (lane < NWARPS) warp_tot[lane] = t;
  }
  __syncthreads();
  if (warp > 0) x = combine<T, OP>(warp_tot[warp - 1], x);
  __syncthreads();  // warp_tot may be reused by the caller
  return x;
}

template <typename T, int OP>
__global__ void seg_tile_reduce(const T* vals, const uint8_t* flags, size_t n, Pair<T>* agg) {
  __shared__ Pair<T> warp_tot[kWarps];
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile + static_cast<size_t>(threadIdx.x) * kItems;
  Pair<T> acc = load<T, OP>(vals, flags, base, n);
#pragma unroll
  for (int k = 1; k < kItems; ++k) acc = combine<T, OP>(acc, load<T, OP>(vals, flags, base + k, n));
  acc = block_inclusive<T, OP, kWarps>(acc, warp_tot);
  if (threadIdx.x == kThreads - 1) agg[blockIdx.x] = acc;
}

// In place: tile pairs -> inclusive scan of the tile pairs.
template <typename T, int OP>
__global__ void seg_scan_tiles(Pair<T>* agg, int ntiles) {
  __shared__ Pair<T> warp_tot[kScanWarps];
  __shared__ Pair<T> carry;
  for (int base = 0; base < ntiles; base += kScanThreads) {
    const int i = base + threadIdx.x;
    Pair<T> x;
    if (i < ntiles) {
      x = agg[i];
    } else {
      x.v = right_identity<T, OP>();
      x.f = 0;
    }
    x = block_inclusive<T, OP, kScanWarps>(x, warp_tot);
    if (base > 0) x = combine<T, OP>(carry, x);
    if (i < ntiles) agg[i] = x;
    __syncthreads();  // every thread has read carry
    if (threadIdx.x == kScanThreads - 1) carry = x;
    __syncthreads();
  }
}

template <typename T, int OP>
__global__ void seg_tile_scan(const T* vals, const uint8_t* flags, size_t n,
                              const Pair<T>* tiles_incl, T* out) {
  __shared__ Pair<T> warp_tot[kWarps];
  __shared__ Pair<T> thread_incl[kThreads];
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile + static_cast<size_t>(threadIdx.x) * kItems;
  Pair<T> item[kItems];
#pragma unroll
  for (int k = 0; k < kItems; ++k) item[k] = load<T, OP>(vals, flags, base + k, n);
  // the thread's own inclusive pairs first: a float sum then adds the large
  // prefix once per row instead of rounding each row onto it in turn
#pragma unroll
  for (int k = 1; k < kItems; ++k) item[k] = combine<T, OP>(item[k - 1], item[k]);
  thread_incl[threadIdx.x] = block_inclusive<T, OP, kWarps>(item[kItems - 1], warp_tot);
  __syncthreads();

  // the pair of every row before this thread's first row, if there is one
  bool has = blockIdx.x > 0;
  Pair<T> run;
  if (has) run = tiles_incl[blockIdx.x - 1];
  if (threadIdx.x > 0) {
    const Pair<T> e = thread_incl[threadIdx.x - 1];
    run = has ? combine<T, OP>(run, e) : e;
    has = true;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (base + k < n) out[base + k] = (has ? combine<T, OP>(run, item[k]) : item[k]).v;
  }
}

template <typename T, int OP>
cudaError_t launch(const void* vals, const uint8_t* flags, size_t n, void* scratch, void* out,
                   cudaStream_t s) {
  const int ntiles = static_cast<int>((n + kTile - 1) / kTile);
  if (ntiles == 0) return cudaSuccess;
  const T* v = static_cast<const T*>(vals);
  Pair<T>* agg = static_cast<Pair<T>*>(scratch);
  cudaError_t err;
  seg_tile_reduce<T, OP><<<ntiles, kThreads, 0, s>>>(v, flags, n, agg);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  seg_scan_tiles<T, OP><<<1, kScanThreads, 0, s>>>(agg, ntiles);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  seg_tile_scan<T, OP><<<ntiles, kThreads, 0, s>>>(v, flags, n, agg, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_op(int op, const void* vals, const uint8_t* flags, size_t n, void* scratch,
                      void* out, cudaStream_t s) {
  switch (op) {
    case kAdd: return launch<T, kAdd>(vals, flags, n, scratch, out, s);
    case kMax: return launch<T, kMax>(vals, flags, n, scratch, out, s);
    case kMin: return launch<T, kMin>(vals, flags, n, scratch, out, s);
    case kFirst: return launch<T, kFirst>(vals, flags, n, scratch, out, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Bytes of tile scratch the scan needs for n rows.
extern "C" long long arrow_segscan_scratch_bytes(long long n) {
  const long long ntiles = (n + kTile - 1) / kTile;
  return ntiles * static_cast<long long>(sizeof(Pair<double>));
}

// vals/out: n elements of `dtype`; flags: n bytes (0 = continue) or null for
// a plain scan; scratch: arrow_segscan_scratch_bytes(n) bytes.
extern "C" int arrow_segscan(const void* vals, const void* flags, int dtype, int op, long long n,
                             void* scratch, void* out, void* stream) {
  if (n < 0 || n >= (1LL << 40)) return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* f = static_cast<const uint8_t*>(flags);
  const size_t rows = static_cast<size_t>(n);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case kI32: err = launch_op<int>(op, vals, f, rows, scratch, out, s); break;
    case kU32: err = launch_op<unsigned>(op, vals, f, rows, scratch, out, s); break;
    case kF32: err = launch_op<float>(op, vals, f, rows, scratch, out, s); break;
    case kI64: err = launch_op<long long>(op, vals, f, rows, scratch, out, s); break;
    case kU64: err = launch_op<unsigned long long>(op, vals, f, rows, scratch, out, s); break;
    case kF64: err = launch_op<double>(op, vals, f, rows, scratch, out, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
