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
// What bounds it on the H100: bytes.  Each plane must be read once and
// written once, 8 x planes x n bytes a pass; the merge itself is a few
// compares a row.  The design is a partitioned merge path in two launches:
//   1. merge_partition: tiles are kTile output rows, within one pair where a
//      pair holds at least kTile rows.  One thread a tile finds the co-rank
//      of the tile's first output (how many of the pair's outputs before it
//      come from A) by binary search over device memory, into the scratch
//      (one int32 a tile).  The tiles of a shorter pair need none: a tile
//      holds whole pairs.
//   2. merge_tiles: one block a tile.  It reads its two co-ranks, which give
//      its A and B windows, and starts the copies of both windows of every
//      plane into a ring of kBuffers shared buffers: a window's 16-byte
//      aligned middle by one bulk copy (TMA, completing on the buffer's
//      mbarrier), the at most three rows at each unaligned end by 4-byte
//      cp.async; the key (and in unique mode the payload) first.  The next
//      planes fly while the keys merge, and a buffer freed by one plane's
//      copy-out takes the plane kBuffers on.
//      Each thread takes kItems consecutive outputs, finds its co-rank in
//      the staged windows and walks them, writing each output's source (its
//      index in the tile's A window, then B window) to shared memory.  Then,
//      plane by plane, the block gathers its rows from the ring by those
//      sources and writes them with 16-byte stores (scalar only at the
//      tile's unaligned ends).  The key plane is read from device memory
//      once, like every other plane.
// The partition and the tile's own search compare with one function
// (a_first): with any other comparison two tiles could disagree on where a
// run of equal keys is cut at their boundary, and lose or double a row.
// The walk and the sources' writes touch shared memory kItems rows apart
// from thread to thread: with 16 outputs a thread that was a 16-way bank
// conflict on every write (and on the keys where one run leads), 0.2 ms of
// the rank-fill call; an odd kItems has none.  tools/merge_tile_shapes.py
// times the shape and the copies (PERF.md): 128 threads of 29 outputs and
// three buffers (a 60 KB block, three an SM), and bulk copies, which beat
// 16-byte cp.async copies by up to 7%.  Index arithmetic is 64-bit wherever
// a pair, run or tile length is multiplied.
//
// Not carried over from the TPU kernel: the prefetching VMEM deques, the
// Batcher half-cleaner and bitonic network over 4096-element tiles, the
// window-position tiebreak plane, the reversed-tile gathers and the
// run-length multiple of 8192.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Tile shape; tools/merge_tile_shapes.py times alternatives.  kItems is odd
// so that threads kItems rows apart hit distinct shared-memory banks.
constexpr int kThreads = 128;
constexpr int kItems = 29;                 // consecutive outputs a thread merges
constexpr int kTile = kThreads * kItems;   // output rows a tile: 3712
constexpr int kBuffers = 3;                // plane buffers in the shared ring
constexpr int kBufferRows = kTile + 16;    // a buffer: both windows and their misalignment
constexpr int kPartitionThreads = 256;
constexpr int kMaxPlanes = 8;
static_assert(kTile % 4 == 0 && kBuffers >= 2, "tiles of whole 16-byte chunks; unique mode stages two planes");

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
// pointers: the runs lie in device memory (the partition) or shared memory
// (a tile); pa/pb are read in unique-payload mode only.
template <bool UNIQUE, typename I>
__device__ __forceinline__ I co_rank(I k, const int32_t* ka, const int32_t* pa, I la, const int32_t* kb,
                                     const int32_t* pb, I lb) {
  I lo = k > lb ? k - lb : 0;
  I hi = k < la ? k : la;
  while (lo < hi) {
    const I mid = (lo + hi) >> 1;
    const I other = k - 1 - mid;
    if (a_first<UNIQUE>(ka[mid], UNIQUE ? pa[mid] : 0, kb[other], UNIQUE ? pb[other] : 0)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Tiles of a pass: kTile output rows a tile within a pair when a pair
// (2 x run rows) holds at least kTile, else as many whole pairs as fit.
__host__ __device__ inline long long tiles_for(long long n, long long run) {
  const long long pair = 2 * run;
  if (pair >= kTile) {
    const long long per_pair = (pair + kTile - 1) / kTile;
    const long long full_pairs = n / pair;
    return full_pairs * per_pair + (n - full_pairs * pair + kTile - 1) / kTile;
  }
  const long long per_tile = kTile / pair;
  return ((n + pair - 1) / pair + per_tile - 1) / per_tile;
}

// Where tile b of a pass with pairs of at least kTile rows lies: its pair's
// first row and length, and the tile's first output within the pair.
struct Place {
  long long pstart, plen, o0;
};

__device__ __forceinline__ Place place(long long b, long long n, long long run) {
  const long long pair = 2 * run;
  const long long per_pair = (pair + kTile - 1) / kTile;
  const long long full_pairs = n / pair;
  Place at;
  if (b < full_pairs * per_pair) {
    at.pstart = b / per_pair * pair;
    at.o0 = b % per_pair * kTile;
    at.plen = pair;
  } else {
    at.pstart = full_pairs * pair;
    at.o0 = (b - full_pairs * per_pair) * kTile;
    at.plen = n - at.pstart;
  }
  return at;
}

// One thread a tile: the co-rank of the tile's first output in its pair.
template <bool UNIQUE>
__global__ void __launch_bounds__(kPartitionThreads)
merge_partition(const int32_t* key, const int32_t* pay, long long n, long long run, int* __restrict__ corank,
                long long ntiles) {
  const long long b = static_cast<long long>(blockIdx.x) * kPartitionThreads + threadIdx.x;
  if (b >= ntiles) return;
  const Place at = place(b, n, run);
  const long long la = at.plen < run ? at.plen : run;
  const int32_t* ka = key + at.pstart;
  const int32_t* pa = UNIQUE ? pay + at.pstart : nullptr;
  corank[b] = static_cast<int>(
      co_rank<UNIQUE, long long>(at.o0, ka, pa, la, ka + la, UNIQUE ? pa + la : nullptr, at.plen - la));
}

// A tile: outputs [out0, out0 + span) merge the A window (la rows from
// global row ga) with the B window (lb rows from gb).  A tile of whole pairs
// has one window, la = span rows from out0, and lb = 0.
struct Tile {
  long long out0, ga, gb;
  int span, la, lb;
};

__device__ __forceinline__ Tile tile_of(long long b, long long n, long long run, const int* corank) {
  const long long pair = 2 * run;
  Tile t;
  if (pair >= kTile) {
    const Place at = place(b, n, run);
    const long long la = at.plen < run ? at.plen : run;
    const long long o1 = at.o0 + kTile < at.plen ? at.o0 + kTile : at.plen;
    const long long i0 = corank[b];
    const long long i1 = o1 == at.plen ? la : corank[b + 1];  // the next tile is in this pair
    t.out0 = at.pstart + at.o0;
    t.span = static_cast<int>(o1 - at.o0);
    t.ga = at.pstart + i0;
    t.la = static_cast<int>(i1 - i0);
    t.gb = at.pstart + la + (at.o0 - i0);
    t.lb = t.span - t.la;
  } else {
    const long long rows = kTile / pair * pair;
    t.out0 = b * rows;
    t.span = static_cast<int>(n - t.out0 < rows ? n - t.out0 : rows);
    t.ga = t.out0;
    t.la = t.span;
    t.gb = t.out0 + t.span;
    t.lb = 0;
  }
  return t;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" : : "r"(smem_addr(smem)), "l"(gmem) : "memory");
}

__device__ __forceinline__ void commit_copies() { asm volatile("cp.async.commit_group;" : : : "memory"); }

// Wait until at most N groups of cp.async copies are in flight.
template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;" : : "n"(N) : "memory");
}

__device__ __forceinline__ void init_barrier(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" : : "r"(smem_addr(bar)) : "memory");
}

// Wait for the phase of `bar` with this parity to complete.  A wait that
// never ends traps (a launch error) rather than hanging the card.
__device__ __forceinline__ void wait_barrier(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  for (long long spin = 0; !done; ++spin) {
    asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    if (spin > (1LL << 22)) __trap();
  }
}

// Rows of int32 before p's 16-byte chunk boundary.
__device__ __forceinline__ int chunk_shift(const int32_t* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) & 15u) / 4);
}

__device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// Where a plane's windows lie in its buffer: the A window is copied to
// offset 0 and the B window to b_at, the chunk after A's last row, so that
// A's row i lies at a + i and B's row j at b + j.
struct Stage {
  int a, b_at, b;
};

__device__ __forceinline__ Stage stage_of(const int32_t* in, const Tile& t) {
  const int a = chunk_shift(in + t.ga);
  const int b_at = round4(a + t.la);
  return {a, b_at, b_at + chunk_shift(in + t.gb)};
}

// Start the copies of a plane's A and B windows into its buffer, each
// window's row i at its chunk shift + i: thread 0 copies the 16-byte
// aligned middle of both by bulk copies (TMA) that complete on `bar`,
// threads 0-7 the at most three rows at each end by 4-byte cp.async.
__device__ __forceinline__ void copy_windows(int32_t* buf, const int32_t* in, const Tile& t,
                                             unsigned long long* bar) {
  const int32_t* g[2] = {in + t.ga, in + t.gb};
  int32_t* s[2] = {buf, buf + stage_of(in, t).b_at};
  const int count[2] = {t.la, t.lb};
  int k0[2], k1[2], sh[2];  // the window's whole chunks are [k0, k1) from g - sh
  unsigned bytes = 0;
  for (int w = 0; w < 2; ++w) {
    sh[w] = chunk_shift(g[w]);
    const int end = sh[w] + count[w];
    k0[w] = round4(sh[w]);
    k1[w] = (end & ~3) < k0[w] ? k0[w] : (end & ~3);
    bytes += 4u * static_cast<unsigned>(k1[w] - k0[w]);
    const int32_t* base = g[w] - sh[w];  // 16-byte aligned
    const int i = threadIdx.x;
    if (i < 4 && sh[w] + i < k0[w] && sh[w] + i < end) copy_async4(s[w] + sh[w] + i, base + sh[w] + i);
    if (i >= 4 && i < 8 && k1[w] + i - 4 < end) copy_async4(s[w] + k1[w] + i - 4, base + k1[w] + i - 4);
  }
  if (threadIdx.x == 0) {
    // the buffer was last read through the generic proxy; the bulk copy writes through the async one
    asm volatile("fence.proxy.async.shared::cta;" : : : "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" : : "r"(smem_addr(bar)), "r"(bytes)
                 : "memory");
    for (int w = 0; w < 2; ++w) {
      if (k1[w] > k0[w]) {
        asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                     : : "r"(smem_addr(s[w] + k0[w])), "l"(g[w] - sh[w] + k0[w]),
                       "r"(4u * static_cast<unsigned>(k1[w] - k0[w])), "r"(smem_addr(bar)) : "memory");
      }
    }
  }
}

// Sources of outputs [first, last) of merge(A, B), A = (ka, pa)[0, la) and
// B = (kb, pb)[0, lb): src[x] = va + i for A's row i, vb + j for B's row j.
template <bool UNIQUE>
__device__ __forceinline__ void merge_outputs(const int32_t* ka, const int32_t* pa, int la, const int32_t* kb,
                                              const int32_t* pb, int lb, int first, int last, int va, int vb,
                                              int* src) {
  int i = co_rank<UNIQUE, int>(first, ka, pa, la, kb, pb, lb);
  int j = first - i;
  int32_t ak = 0, ap = 0, bk = 0, bp = 0;
  if (i < la) {
    ak = ka[i];
    if (UNIQUE) ap = pa[i];
  }
  if (j < lb) {
    bk = kb[j];
    if (UNIQUE) bp = pb[j];
  }
  for (int x = first; x < last; ++x) {
    if (j >= lb || (i < la && a_first<UNIQUE>(ak, ap, bk, bp))) {
      src[x] = va + i++;
      if (i < la) {
        ak = ka[i];
        if (UNIQUE) ap = pa[i];
      }
    } else {
      src[x] = vb + j++;
      if (j < lb) {
        bk = kb[j];
        if (UNIQUE) bp = pb[j];
      }
    }
  }
}

// One block a tile (see the note at the top).  Dynamic shared memory: the
// sources (kBufferRows ints), then nbuf plane buffers of kBufferRows.
template <bool UNIQUE>
__global__ void __launch_bounds__(kThreads)
merge_tiles(Planes planes, long long n, long long run, const int* __restrict__ corank, int nbuf) {
  extern __shared__ __align__(16) int32_t smem[];
  int* src = smem;
  int32_t* ring = smem + kBufferRows;
  const Tile t = tile_of(blockIdx.x, n, run, corank);
  auto buffer = [&](int p) { return ring + (p % nbuf) * kBufferRows; };
  // a buffer's barrier completes a phase when the bulk copies into it land
  __shared__ alignas(8) unsigned long long landed[kBuffers];
  if (threadIdx.x == 0) {
    for (int b = 0; b < kBuffers; ++b) init_barrier(&landed[b]);
    asm volatile("fence.mbarrier_init.release.cluster;" : : : "memory");
  }
  __syncthreads();
  // plane p's windows into its buffer; its ends as one group of cp.async
  // copies (an empty group past the last plane, so that group p is always
  // plane p's)
  auto start_copy = [&](int p) {
    if (p < planes.count) copy_windows(buffer(p), planes.in[p], t, &landed[p % nbuf]);
    commit_copies();
  };
  // plane p is in its buffer for this thread: its ends' group and its bulk
  // copies (the buffer's (p / nbuf)-th phase) have landed
  auto wait_plane = [&](int p) { wait_barrier(&landed[p % nbuf], (p / nbuf) & 1); };
  for (int p = 0; p < kBuffers; ++p) start_copy(p);

  // the sources, stored at osh + x so that src[k..k+4) matches the output's
  // 16-byte chunk k (the outputs are 16-byte aligned)
  const int osh = static_cast<int>(t.out0 & 3);
  wait_copies<UNIQUE ? kBuffers - 2 : kBuffers - 1>();  // the key (and the payload) have landed
  wait_plane(0);
  if (UNIQUE) wait_plane(1);
  __syncthreads();
  {
    const Stage k0 = stage_of(planes.in[0], t);
    const int32_t* key = buffer(0);
    Stage p1 = {0, 0, 0};
    const int32_t* pay = key;
    if (UNIQUE) {
      p1 = stage_of(planes.in[1], t);
      pay = buffer(1);
    }
    const int x0 = threadIdx.x * kItems;
    const int x1 = x0 + kItems < t.span ? x0 + kItems : t.span;
    if (2 * run >= kTile) {
      merge_outputs<UNIQUE>(key + k0.a, pay + p1.a, t.la, key + k0.b, pay + p1.b, t.lb, x0, x1, 0, t.la, src + osh);
    } else {  // whole pairs of pair rows each; a thread's outputs may cross pair ends
      const int pair = static_cast<int>(2 * run);
      for (int x = x0; x < x1;) {
        const int s0 = x / pair * pair;
        const int plen = t.span - s0 < pair ? t.span - s0 : pair;
        const int la = plen < run ? plen : static_cast<int>(run);
        const int last = x1 < s0 + plen ? x1 : s0 + plen;
        merge_outputs<UNIQUE>(key + k0.a + s0, pay + p1.a + s0, la, key + k0.a + s0 + la, pay + p1.a + s0 + la,
                              plen - la, x - s0, last - s0, s0, s0 + la, src + osh + s0);
        x = last;
      }
    }
  }

  const int end = osh + t.span;
  for (int p = 0; p < planes.count; ++p) {
    wait_copies<kBuffers - 1>();
    wait_plane(p);
    __syncthreads();  // plane p is in its buffer, and every source is written
    const int32_t* buf = buffer(p);
    const Stage at = stage_of(planes.in[p], t);
    const int pa = at.a, pb = at.b - t.la;  // source v lies at v + pa (A) or v + pb (B)
    auto row = [&](int v) { return buf[v + (v < t.la ? pa : pb)]; };
    int32_t* out = planes.out[p] + (t.out0 - osh);  // 16-byte aligned
    for (int k = threadIdx.x * 4; k < end; k += kThreads * 4) {
      if (k >= osh && k + 4 <= end) {
        const int4 v = *reinterpret_cast<const int4*>(src + k);
        *reinterpret_cast<int4*>(out + k) = make_int4(row(v.x), row(v.y), row(v.z), row(v.w));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k + e >= osh && k + e < end) out[k + e] = row(src[k + e]);
        }
      }
    }
    if (p + kBuffers < planes.count) __syncthreads();  // its buffer is free for plane p + kBuffers
    start_copy(p + kBuffers);
  }
}

template <bool UNIQUE>
cudaError_t launch(const Planes& planes, long long n, long long run, int* corank, cudaStream_t s) {
  const int nbuf = planes.count < kBuffers ? planes.count : kBuffers;
  const int smem = (nbuf + 1) * kBufferRows * static_cast<int>(sizeof(int32_t));
  // the attribute holds for the current device only: set it on every launch
  cudaError_t err = cudaFuncSetAttribute(merge_tiles<UNIQUE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long ntiles = tiles_for(n, run);
  if (2 * run >= kTile) {
    const long long blocks = (ntiles + kPartitionThreads - 1) / kPartitionThreads;
    merge_partition<UNIQUE><<<static_cast<unsigned>(blocks), kPartitionThreads, 0, s>>>(
        planes.in[0], UNIQUE ? planes.in[1] : nullptr, n, run, corank, ntiles);
  }
  merge_tiles<UNIQUE><<<static_cast<unsigned>(ntiles), kThreads, smem, s>>>(planes, n, run, corank, nbuf);
  return cudaGetLastError();
}

}  // namespace

// Bytes of scratch a pass over n rows with runs of run_len needs (never 0):
// one co-rank a tile where the pairs hold at least a tile.
extern "C" long long arrow_merge_scratch_bytes(long long n, long long run_len) {
  if (n < 1 || run_len < 1) return 16;
  const long long run = run_len < n ? run_len : n;
  const long long bytes = 2 * run >= kTile ? tiles_for(n, run) * static_cast<long long>(sizeof(int)) : 0;
  return bytes > 16 ? bytes : 16;
}

// in/out: `nplanes` host arrays of int32 device planes of n rows (plane 0 the
// key; in unique mode plane 1 the tiebreak); the outputs 16-byte aligned.
// scratch: arrow_merge_scratch_bytes(n, run_len) bytes.  Returns
// cudaGetLastError() of the launches.
extern "C" int arrow_merge_pass(const void* const* in, void* const* out, int nplanes, long long n,
                                long long run_len, int unique, void* scratch, void* stream) {
  if (nplanes < 1 || nplanes > kMaxPlanes || n < 0 || n >= (1LL << 31) || run_len < 1 ||
      (unique && nplanes != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Planes planes;
  planes.count = nplanes;
  for (int p = 0; p < nplanes; ++p) {
    if (reinterpret_cast<uintptr_t>(in[p]) % 4 || reinterpret_cast<uintptr_t>(out[p]) % 16) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    planes.in[p] = static_cast<const int32_t*>(in[p]);
    planes.out[p] = static_cast<int32_t*>(out[p]);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  const long long run = run_len < n ? run_len : n;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* corank = static_cast<int*>(scratch);
  const cudaError_t err = unique ? launch<true>(planes, n, run, corank, s) : launch<false>(planes, n, run, corank, s);
  return static_cast<int>(err);
}
