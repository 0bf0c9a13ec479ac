// One pass of a stable pairwise merge of sorted runs (kernel B7).
//
// Replaces arrow_tpu/compute/kernels/merge.py::merge_pass_pallas (the Pallas
// kernel built by `_make_kernel`), also behind sort_kv_pallas.  Same
// function: the planes hold sorted runs of run_len rows, by the int32 key in
// plane 0; runs 2k and 2k+1 (A and B) merge into one sorted run of 2 x
// run_len rows, and every plane follows its key.  A's rows come before B's on
// equal keys, so the merge is stable.  In unique-payload mode plane 1 breaks
// ties instead, (key, payload) compared as signed int32.  The last pair may
// have a short B run, or none (a bye: its A run is copied).  Any n < 2^31 and
// any run_len >= 1 are taken.
//
// What bounds it on the H100: bytes.  Each plane is read once and written
// once, 8 x planes x n bytes a pass, plus the key read into shared memory.
// The design is merge path:
//   - each block owns a span of up to 2048 output rows.  Where a run pair
//     holds at least that many rows, the span lies in one pair: thread 0
//     finds the span's co-ranks (how many of its first outputs come from A)
//     by binary search on the two diagonals, and the block loads exactly the
//     A and B rows the span needs into shared memory.  Where pairs are
//     shorter, the span holds whole pairs and the block loads them as they
//     lie;
//   - each thread takes 8 consecutive outputs, finds its own co-rank in
//     shared memory and merges them, writing the source row of each output
//     to shared memory;
//   - the block then copies every plane's rows to the output in order, so the
//     writes are coalesced and the reads stay within the span's two windows.
// Index arithmetic is 64-bit.  The merge needs no scratch memory: the
// wrapper allocates only the output planes.
//
// Not carried over from the TPU kernel: the prefetching VMEM deques, the
// Batcher half-cleaner and bitonic network over 4096-element tiles, the
// window-position tiebreak plane, the reversed-tile gathers and the
// run-length multiple of 8192.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kSpan = kThreads * kItems;  // output rows per block
constexpr int kMaxPlanes = 8;

struct Planes {
  const int32_t* in[kMaxPlanes];
  int32_t* out[kMaxPlanes];
  int count;
};

// Whether A's row (ka, pa) goes before B's row (kb, pb).
template <bool UNIQUE>
__device__ __forceinline__ bool a_first(int32_t ka, int32_t pa, int32_t kb, int32_t pb) {
  if (UNIQUE) return ka < kb || (ka == kb && pa <= pb);
  return ka <= kb;
}

// How many of the first k rows of merge(A, B) come from A.  Generic
// pointers: the runs may lie in device or shared memory; pa/pb are read in
// unique-payload mode only.
template <bool UNIQUE>
__device__ long long co_rank(long long k, const int32_t* ka, const int32_t* pa, long long la,
                             const int32_t* kb, const int32_t* pb, long long lb) {
  long long lo = k > lb ? k - lb : 0;
  long long hi = k < la ? k : la;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const long long other = k - 1 - mid;
    if (a_first<UNIQUE>(ka[mid], UNIQUE ? pa[mid] : 0, kb[other], UNIQUE ? pb[other] : 0)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// A run pair (or the part of one) staged in shared memory: outputs
// [start, start + la + lb) of the block merge A = keys[sa, sa + la) with
// B = keys[sb, sb + lb); ga/gb are the global rows of A[0] and B[0].
struct Segment {
  int start, sa, la, sb, lb;
  long long ga, gb;
};

template <bool UNIQUE>
__global__ void merge_runs(Planes planes, long long n, long long run) {
  __shared__ int32_t skey[kSpan];
  __shared__ int32_t spay[UNIQUE ? kSpan : 1];
  __shared__ int src[kSpan];
  __shared__ long long corank[2];

  const long long pair = 2 * run;
  const int32_t* key = planes.in[0];
  const int32_t* pay = UNIQUE ? planes.in[1] : nullptr;
  const bool big = pair >= kSpan;
  long long out0;  // global row of the span's first output
  int span;
  Segment one{};   // the span's segment when it lies in one pair
  if (big) {
    const long long per_pair = (pair + kSpan - 1) / kSpan;
    const long long full_pairs = n / pair;
    const long long b = blockIdx.x;
    long long p, s, plen;
    if (b < full_pairs * per_pair) {
      p = b / per_pair;
      s = b % per_pair;
      plen = pair;
    } else {
      p = full_pairs;
      s = b - full_pairs * per_pair;
      plen = n - full_pairs * pair;
    }
    const long long pstart = p * pair;
    const long long la = plen < run ? plen : run;
    const long long lb = plen - la;
    const long long o0 = s * kSpan;
    const long long o1 = o0 + kSpan < plen ? o0 + kSpan : plen;
    const int32_t* ka = key + pstart;
    const int32_t* kb = ka + la;
    const int32_t* pa = UNIQUE ? pay + pstart : nullptr;
    const int32_t* pb = UNIQUE ? pa + la : nullptr;
    if (threadIdx.x < 2) {
      corank[threadIdx.x] = co_rank<UNIQUE>(threadIdx.x ? o1 : o0, ka, pa, la, kb, pb, lb);
    }
    __syncthreads();
    const long long i0 = corank[0], i1 = corank[1];
    const long long j0 = o0 - i0, j1 = o1 - i1;
    one.start = 0;
    one.sa = 0;
    one.la = static_cast<int>(i1 - i0);
    one.sb = one.la;
    one.lb = static_cast<int>(j1 - j0);
    one.ga = pstart + i0;
    one.gb = pstart + la + j0;
    out0 = pstart + o0;
    span = static_cast<int>(o1 - o0);
    for (int x = threadIdx.x; x < one.la; x += kThreads) {
      skey[x] = ka[i0 + x];
      if (UNIQUE) spay[x] = pa[i0 + x];
    }
    for (int x = threadIdx.x; x < one.lb; x += kThreads) {
      skey[one.sb + x] = kb[j0 + x];
      if (UNIQUE) spay[one.sb + x] = pb[j0 + x];
    }
  } else {
    const long long per_block = kSpan / pair;  // whole pairs per block
    out0 = static_cast<long long>(blockIdx.x) * per_block * pair;
    const long long end = out0 + per_block * pair < n ? out0 + per_block * pair : n;
    span = static_cast<int>(end - out0);
    for (int x = threadIdx.x; x < span; x += kThreads) {
      skey[x] = key[out0 + x];
      if (UNIQUE) spay[x] = pay[out0 + x];
    }
  }
  __syncthreads();

  // each thread merges its kItems outputs, crossing pair ends as it goes
  const int x0 = threadIdx.x * kItems;
  const int x1 = x0 + kItems < span ? x0 + kItems : span;
  int x = x0;
  while (x < x1) {
    Segment seg = one;
    if (!big) {
      const int q = static_cast<int>(x / pair);
      const int sstart = static_cast<int>(q * pair);
      const int plen = span - sstart < pair ? span - sstart : static_cast<int>(pair);
      seg.start = sstart;
      seg.sa = sstart;
      seg.la = plen < run ? plen : static_cast<int>(run);
      seg.sb = sstart + seg.la;
      seg.lb = plen - seg.la;
      seg.ga = out0 + sstart;
      seg.gb = seg.ga + seg.la;
    }
    const int32_t* ka = skey + seg.sa;
    const int32_t* kb = skey + seg.sb;
    const int32_t* pa = UNIQUE ? spay + seg.sa : nullptr;
    const int32_t* pb = UNIQUE ? spay + seg.sb : nullptr;
    int i = static_cast<int>(co_rank<UNIQUE>(x - seg.start, ka, pa, seg.la, kb, pb, seg.lb));
    int j = x - seg.start - i;
    const int seg_end = seg.start + seg.la + seg.lb;
    for (; x < x1 && x < seg_end; ++x) {
      const bool take_a =
          j >= seg.lb ||
          (i < seg.la && a_first<UNIQUE>(ka[i], UNIQUE ? pa[i] : 0, kb[j], UNIQUE ? pb[j] : 0));
      src[x] = static_cast<int>(take_a ? seg.ga + i++ : seg.gb + j++);
    }
  }
  __syncthreads();

  for (int p = 0; p < planes.count; ++p) {
    const int32_t* in = planes.in[p];
    int32_t* out = planes.out[p] + out0;
    for (int y = threadIdx.x; y < span; y += kThreads) out[y] = in[src[y]];
  }
}

long long blocks_for(long long n, long long run) {
  const long long pair = 2 * run;
  if (pair >= kSpan) {
    const long long per_pair = (pair + kSpan - 1) / kSpan;
    const long long full_pairs = n / pair;
    const long long rest = n - full_pairs * pair;
    return full_pairs * per_pair + (rest + kSpan - 1) / kSpan;
  }
  const long long per_block = kSpan / pair;
  const long long pairs = (n + pair - 1) / pair;
  return (pairs + per_block - 1) / per_block;
}

}  // namespace

// in/out: `nplanes` host arrays of int32 device planes of n rows (plane 0 the
// key; in unique mode plane 1 the tiebreak).  Returns cudaGetLastError() of
// the launch.
extern "C" int arrow_merge_pass(const void* const* in, void* const* out, int nplanes, long long n,
                                long long run_len, int unique, void* stream) {
  if (nplanes < 1 || nplanes > kMaxPlanes || n < 0 || n >= (1LL << 31) || run_len < 1 ||
      (unique && nplanes < 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long run = run_len < n ? run_len : n;
  Planes planes;
  planes.count = nplanes;
  for (int p = 0; p < nplanes; ++p) {
    planes.in[p] = static_cast<const int32_t*>(in[p]);
    planes.out[p] = static_cast<int32_t*>(out[p]);
  }
  const long long blocks = blocks_for(n, run);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (unique) {
    merge_runs<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(planes, n, run);
  } else {
    merge_runs<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(planes, n, run);
  }
  return static_cast<int>(cudaGetLastError());
}
