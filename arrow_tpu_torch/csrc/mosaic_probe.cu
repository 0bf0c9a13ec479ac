// The 25 capability probes of tools/mosaic_probe.py as kernels for Hopper
// (sm_90a), each the counterpart of one probe's Pallas kernel: the 19 that
// go through simple_call (mosaic_probe.py:61) and the 6 that make their own
// pallas_call (:77 grid, :230, :254, :281 and :387 the DMA copies, :428 the
// prefetched scalar).
//
// Each probe runs once on one fixed tile of at most 128 KB.  Its bound on
// the card (its bytes over 3.35 TB/s, or for the int8 product its operations
// over the tensor cores' rate) is under a tenth of a microsecond, so what
// each kernel costs is a launch and the memory round trips that its design
// puts one after another.  What each shows is that the card does the probe's
// operation in the way the TPU kernel did:
//
// - lane movement (the rolls, the lane gathers, the lane cumsum and the
//   in-row sort) is done by a warp that holds a 128-wide row as 4
//   consecutive elements a lane, loaded and stored as one 16-byte word, with
//   __shfl_sync between the lanes (below);
// - row movement (the sublane gather, the row write and store, the
//   transpose) goes through a tile in shared memory;
// - the DMA probes (the row-offset copy, the row write, the sized copy and
//   the HBM-to-HBM copy) move 16 bytes a thread since their redesigns
//   (below); three of the bulk-copy designs (cp.async.bulk, the TMA's
//   one-dimensional form, on an mbarrier or a bulk group) stay behind
//   kOffsetBulk, kWriteBulk and kHbmBulk.
//
// All twenty probe kernels here (the lane gather's four probes, the roll's
// two and the compare cast's two counting as one kernel each), and
// probe_r4.cu's merge step and mask matmul, are laid out for the card rather
// than for the TPU's tiles, so that every global load is in flight at once
// and nothing waits on a round trip that an earlier one could have covered:
//
// - dynamic_slice_vmem_rows (the probe through simple_call, :61: rows
//   [s, s + 8) of a (64, 128) int32 tile, s a device scalar).  Bound by
//   bytes: the window's 4 KB read and written, 0.0024 us.  8 blocks of 8
//   warps, a warp a row of the tile: each thread loads s and its 16 bytes of
//   the row at once, and stores them at row - s if its row is in the window.
//   That is one round trip for 32 KB read.  Reading s first and then only
//   the window (kSliceEveryRow false: 4 KB, one 16-byte load a thread) puts
//   a second round trip behind the first: 1.055x as long on an H100, in
//   turns (tools/probe_designs.py).
// - dma_unaligned_row_write (:254: src's 8 rows written at row s of a
//   (64, 128) int32 output, zeros elsewhere).  Bound by bytes: 36 KB,
//   0.011 us.  The kernel writes the zeros itself, so a call is one launch
//   and no fill.  8 blocks of 8 warps, a warp an output row: each block loads
//   s and all of src (16 bytes a thread) at once, src into shared memory, so
//   that no load waits on an address computed from s.  A thread outside the
//   window stores its zeros before the block's barrier; after it the
//   window's rows leave as 16-byte stores from shared memory.  A bulk copy a
//   block of its window rows, shared to global (kWriteBulk true), took
//   1.024x as long on an H100, in turns (tools/probe_designs.py).
// - dma_unaligned_row_offset (:230: rows [s, s + 8) of a (64, 128) int32
//   src, s a device scalar) is the row slice's function, so its C entry
//   launches slice_every_row.  Bound by bytes: the window's 4 KB read and
//   written, 0.0024 us.  Its bulk design (kOffsetBulk true, copy_rows_in: 8
//   blocks, each thread loading s first and thread 0 bringing the block's 8
//   rows, whose address does not depend on s, into shared memory by one bulk
//   copy on an mbarrier; the window's threads store 16 bytes after the wait)
//   is one round trip too, but its barrier set-up and wait took it to 1.087x
//   as long on an H100, in turns.
// - prefetch_scalar_grid (:428: x + s over (16, 128) int32, s a device
//   scalar, in the JAX grid's two (8, 128) blocks).  Bound by bytes: 16 KB,
//   0.0049 us.  Each of 2 x 256 threads loads s and its 16 bytes of x at once
//   through restrict pointers and makes one 16-byte store: no shared memory
//   and no barrier, so no load waits on the scalar.  One block of 512
//   threads (kScalarOneBlock true) took 1.050x as long on an H100, in turns.
// - grid_1d_blockspec (mosaic_probe.py:77, p_grid: x + 1 over a (256, 128)
//   int32 array in a grid of (64, 128) blocks).  Bound by bytes: 256 KB,
//   0.078 us.  The grid is 32 blocks of (8, 128) tiles, one 16-byte read-only
//   load and store a thread through restrict pointers, so the call is one
//   launch and one memory round trip.
// - matmul_int8_s32acc (the probe through simple_call, :61: (128, 128) int8
//   @ (128, 128) int8 -> int32).  Bound by bytes: 96 KB, 0.029 us (the
//   operations take 0.002 us).  The product is wgmma.mma_async m64n32k32
//   s8 x s8 -> s32 from shared memory, 4 k-steps into registers, in 8 blocks
//   of one warpgroup, each a 64 x 32 tile of the output, so that each of 8
//   SMs moves 20 KB (on an H100, tiles of 64 x 64 and 64 x 128 in 4 and 2
//   blocks took 1.07x and 1.20x as long: tools/probe_designs.py).  For 8-bit
//   types wgmma takes B only K-major, so B is transposed on the way in: a
//   thread loads 4 bytes of 16 rows, transposes four 4x4 byte blocks in
//   registers (__byte_perm) and stores 16 bytes of K for each of its 4
//   columns into the no-swizzle K-major layout, whose row groups are padded
//   by 16 bytes so that those stores meet no bank conflict.  A goes in as
//   16-byte chunks; the outputs leave as 8-byte pairs.
// - transpose_32b_128x128 (the probe through simple_call, :61: a.T over a
//   (128, 128) int32 tile).  Bound by bytes: 128 KB read and written,
//   0.039 us.  16 blocks of 256 threads, a block a 32 x 32 tile: each thread
//   makes one 16-byte load of a row into shared memory, whose rows are padded
//   by 16 bytes every 4 rows so that the 16-byte stores stay aligned and a
//   warp's column reads fall in 32 banks; after the one barrier it reads 4
//   words of a column and makes one 16-byte store.  The earlier design moved
//   4 bytes a thread 4 times each way.  Transposing 4 x 4 blocks in registers
//   instead (kTransposeShared false: a quad's 4 lanes swap words by two
//   rounds of __shfl_xor_sync, no shared memory and no barrier, but each
//   16-byte store fills half a 32-byte sector) took 1.05x as long on an
//   H100, in turns, in 32 blocks of 128 threads, and 1.08-1.11x in 16 of
//   256.
// - hbm_to_hbm_dma (:387: rows [8, 16) of a (64, 128) int32 src, copied HBM
//   to HBM).  Bound by bytes: 4 KB read and written, 0.0024 us.  One block
//   of 256 threads, one 16-byte load and one 16-byte store a thread.  8
//   blocks of one warp, a warp a row, took 1.00-1.03x as long on an H100,
//   in turns, and the bulk copies through shared memory as the TPU's DMA
//   makes them (kHbmBulk true: one thread brings the rows in on an mbarrier
//   and sends them out, waiting only until the store has read shared
//   memory) 1.03x.
// - bitcast_f32_u32 (the probe through simple_call, :61: the bits of an
//   (8, 128) float32 tile as uint32).  Bound by bytes: 4 KB read and
//   written, 0.0024 us.  A bit copy, so its C entry launches the HBM-to-HBM
//   copy's kernel at row 0: one block of 256 threads, one 16-byte load and
//   store a thread.  The earlier design, 4 blocks of 4-byte loads and stores
//   through plain pointers, took 1.044x as long on an H100, and 8 blocks of
//   one warp 1.055x, in ten rounds of turns (tools/probe_designs.py).
// - cumsum_sublanes_f32 (the probe through simple_call, :61: the running sum
//   down the 64 rows of a (64, 128) float32 tile).  Bound by bytes: 64 KB
//   read and written, 0.020 us.  Its contract is the plain version's order:
//   each column adds row after row, bit for bit, so no tree scan, no carries
//   between row segments and no wider sum.  4 blocks of 32 threads, a thread
//   a column: its 64 loads (a warp's 128 contiguous bytes each) all issued
//   before the first add, then the 63 adds, then the stores.  The earlier
//   design (one block of 128 threads, plain pointers and a run-time row
//   count) made 64 dependent load-add-store rounds: 4.8-4.9x as long on an
//   H100, in turns.  The tile through shared memory (kCumsumStaged true:
//   16-byte loads, one barrier, the adds in place, 16-byte stores) took
//   1.13-1.20x as long, and one block of 128 threads (kCumsumThreads 128)
//   1.08-1.14x (tools/probe_designs.py).
// - gather_sublanes_taa_axis0 (the probe through simple_call, :61: out[r, c]
//   = x[idx[r, c], c] over (64, 128) int32, idx in [0, 64)).  Bound by
//   bytes: 96 KB read and written, 0.029 us.  8 blocks of a 16-column
//   stripe: each thread loads its 16 bytes of x and of idx together, x's
//   into the stripe in shared memory, and after the one barrier reads its 4
//   gathered words and makes one 16-byte store; an index outside [0, 64)
//   traps.  The earlier design (one block of 1024 threads staging all of x
//   by 4-byte loads, idx loaded only after the barrier) took 2.20x as long
//   on an H100, in turns; x read at the gathered rows without shared memory
//   (kGatherDirect true: a second round trip, and a 32-byte sector a lane
//   for each of a warp's 4 gathered loads) 1.14-1.17x; reading the stripe
//   rotated over 32 banks was no faster (tools/probe_designs.py).
// - dma_dynamic_size_rows (:281: the first s rows of a (64, 128) int32 src,
//   s a device scalar clamped to [0, 64], zeros below them).  Bound by
//   bytes: 36 KB at s = 8, 0.011 us.  8 blocks of 8 warps: each thread
//   loads s and its 16 bytes of src at once and stores its word or zeros as
//   16 bytes: no shared memory, no barrier, no zero fill.  The earlier
//   design (a shared tile zeroed by 4-byte stores, then one bulk copy of s
//   rows issued after s's load, on an mbarrier) took 1.47x as long on an
//   H100, in turns; reading s first and then only its rows
//   (kSizedCountFirst true) 1.03-1.05x.
// - dynamic_store_vmem_rows (the probe through simple_call, :61: a's 8 rows
//   at row s of a zeroed (64, 128) int32 output) is the row write's
//   function, so its C entry launches write_rows: 8 blocks loading s and the
//   rows together, zeros before the barrier, the window after it.  Bound by
//   bytes: 36 KB, 0.011 us.  The earlier design (one block of 1024 threads:
//   a 32 KB shared tile zeroed by 4-byte stores, a barrier, then s, then a's
//   rows, a second barrier, 4-byte stores out) took 1.47x as long on an
//   H100 80GB HBM3 at 700 W, in turns, twice (tools/probe_designs.py).
// - lax_sort_in_kernel (the probe through simple_call, :61: each row of an
//   (8, 128) int32 tile sorted ascending).  Bound by bytes: 8 KB, 0.0024 us.
//   A warp a row, each in a block of its own so that the 8 rows run on 8
//   SMs; lane L holds elements 4L..4L+3 (one 16-byte load, one 16-byte
//   store).  Of the bitonic network's 28 stages, the 13 of distance 1 and 2
//   are compare-exchanges between a lane's registers and the 15 of distance
//   4-64 shuffles: 60 SHFL a warp in a chain of 15 stages.  The earlier
//   design (one block of 8 warps, element c in register c >> 5 of lane
//   c & 31, 4-byte accesses: 100 SHFL a warp in a chain of 25) took
//   1.18-1.20x as long on an H100 80GB HBM3 at 700 W, in turns; 8
//   consecutive elements a lane, 16 lanes a row in 4 blocks (kSortEightALane
//   true: 10 shuffle stages of 8 SHFL, twice the register work a stage)
//   1.05-1.06x.
// - cumsum_lanes_i32 (the probe through simple_call, :61: the running sum
//   along each row of an (8, 128) int32 tile, wrapping).  Bound by bytes:
//   8 KB, 0.0024 us.  One block of 8 warps, a warp a row: lane h loads
//   elements 4h..4h+3 with one 16-byte load, adds them in registers, takes
//   the sum of the lanes before it from one 5-stage shuffle scan of the lane
//   totals and makes one 16-byte store: 5 dependent SHFL, no shared memory.
//   The earlier design (4-byte accesses through plain pointers: 4 chained
//   load-scan-store rounds, 23 dependent SHFL) took 1.34-1.37x as long on
//   an H100 80GB HBM3 at 700 W, in turns; 8 blocks of one warp
//   (kCumsumLanesGrid true) 1.02-1.05x (tools/probe_designs.py).
// - gather_lanes_taa_8x128_i32, gather_lanes_f32, gather_lanes_taa_256x128_i32
//   and gather_lanes_256wide_2gathers (the probes through simple_call, :61:
//   out[r, c] = x[r, idx[r, c]] over 128 outputs a row, from rows of 128
//   int32, 128 float32 or 256 int32 values).  Bound by bytes: 12 KB,
//   0.0037 us (384 KB, 0.117 us for the 256 rows; 16 KB, 0.0049 us for the
//   256-wide row).  A warp a row: x's row and lane h's 4 indices loaded
//   together as 16-byte words, each output shuffled from the lane that
//   holds it (W / 32 SHFL and selects), one 16-byte store: no shared memory.
//   8 blocks of one warp, 32 blocks of 8 warps for the 256 rows.  An index
//   outside [0, W) traps.  The earlier design (one block of 8 warps, 4-byte
//   accesses through plain pointers, each idx load after the store before
//   it) took 1.19-1.25x as long on an H100 80GB HBM3 at 700 W, in turns;
//   the warp's row through shared memory (kGatherShuffle false) 0.98-1.05x
//   at W = 128 and 0.99-1.01x at W = 256 (tools/probe_designs.py).
// - pltpu_roll_static and pltpu_roll_dynamic (the probes through
//   simple_call, :61: np.roll along the lanes of an (8, 128) int32 tile by
//   3, or by s read on the device).  Bound by bytes: 8 KB, 0.0024 us.  One
//   block of 8 warps, a warp a row (roll_lanes<Dynamic, Shift>): lane h
//   loads elements 4h..4h+3 as one 16-byte word, the shift with it; each of
//   its 4 registers comes from one lane by one __shfl_sync (3 for the
//   static shift 3, a template argument), then selects on the shift's m
//   and one 16-byte store.  The earlier design (element c in register c >>
//   5 of lane c & 31: five 4-byte loads and four 4-byte stores through
//   plain pointers, 4 SHFL and 14 selects, two % of the shift) took 1.039x
//   as long on an H100 80GB HBM3 at 700 W, in five rounds of turns (1.081x
//   static and 0.985x dynamic in one round of another call); the warp's
//   row through shared memory (kRollStaged true) 1.000-1.001x
//   (tools/probe_designs.py).
// - smem_scratch_scalar_loop (the probe through simple_call, :61: the
//   wrapping int32 sum of a[0:8, 0] filled into an (8, 128) tile).  Bound
//   by bytes: 32 B read and 4 KB written, 0.0012 us.  One block of 256
//   threads, each issuing its 8 loads before its first add, then one
//   16-byte store: no shared scalar, no barrier.  The earlier design
//   (thread 0's sum into a __shared__ scalar, a __syncthreads, then 4-byte
//   stores) took 1.065x as long on an H100 80GB HBM3 at 700 W, in five
//   rounds of turns (1.042x in one round of another call); one load a lane
//   summed by three __shfl_xor_sync stages (kScalarLaneSum true) 0.996x and
//   1.022x, a tie (tools/probe_designs.py).
// - cmp_to_int8_vector and cmp_to_bf16_vector (the probes through
//   simple_call, :61: (a > 50) cast to int8 or bf16 over a (32, 128) int32
//   tile).  Bound by bytes: 20 KB and 24 KB, 0.0061 and 0.0073 us.  One
//   kernel behind both, greater_to<Bits, One>: 4 blocks of 256 threads,
//   each one 16-byte load of 4 consecutive elements, 4 compares, the 4
//   results packed into one 4- or 8-byte store as the output type's bits
//   (0x01; the bf16 1.0 is 0x3F80, with no float round trip).  The earlier
//   kernels (16 blocks, a 4-byte load and a 1- or 2-byte store a thread
//   behind an i < n guard, the bf16 one through __float2bfloat16_rn) took
//   1.046-1.049x as long on an H100 80GB HBM3 at 700 W, in three rounds of
//   turns; 8 elements a thread in 2 blocks (kCompareEightAThread true)
//   1.040-1.043x (tools/probe_designs.py).
// - u32_shifts_popcount (the probe through simple_call, :61: (x >> 3) ^
//   (x << 2) ^ popcount(x) over an (8, 128) u32 tile).  Bound by bytes:
//   8 KB, 0.0024 us.  One block of 256 threads, each one 16-byte load, 4
//   POPC and one 16-byte store, no guard.  The earlier kernel (4 blocks of
//   4-byte words behind an i < n guard) took 1.046x as long, in three rounds
//   of turns; 128 threads of two words each (kShiftsTwoWords true) 1.037x
//   (tools/probe_designs.py).
//
// One C entry a probe, arrow_probe_<label>(inputs..., out, stream), in the
// order of the JAX probe's pallas_call arguments (the device scalar first
// where the probe has one); each returns cudaGetLastError().  The wrappers
// are in arrow_tpu_torch/tools/mosaic_probe.py; a pointer is 16-byte aligned.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;
constexpr unsigned kFull = 0xffffffffu;

// ---------------------------------------------------------------------------
// elementwise and grid probes

// grid_1d_blockspec: x + 1 over (256, 128) int32, one block an (8, 128) tile
// (4 KB), one 16-byte load and store a thread: every load of the grid is in
// flight at once.
constexpr int kGridRows = 256;
constexpr int kTileRows = 8;
constexpr int kTileThreads = kTileRows * kLanes / 4;
constexpr int kRowWords = kLanes / 4;  // 16-byte words of a 128-lane int32 row

__global__ void __launch_bounds__(kTileThreads) add_one_tiles(const int4* __restrict__ x, int4* __restrict__ out) {
  const int i = blockIdx.x * kTileThreads + threadIdx.x;
  int4 v = __ldg(x + i);
  v.x += 1;
  v.y += 1;
  v.z += 1;
  v.w += 1;
  out[i] = v;
}

// prefetch_scalar_grid's two designs: the JAX grid, one block an (8, 128)
// tile, or the whole (16, 128) array in one block (kScalarOneBlock)
constexpr bool kScalarOneBlock = false;
constexpr int kScalarThreads = kScalarOneBlock ? 2 * kTileThreads : kTileThreads;

// x + s[0] over (16, 128) int32, wrapping: each thread loads s and its 16
// bytes of x together, adds and stores 16 bytes (no shared memory, no
// barrier, so no load waits on the scalar)
__global__ void __launch_bounds__(kScalarThreads)
    add_scalar_tiles(const int32_t* __restrict__ s, const int4* __restrict__ x, int4* __restrict__ out) {
  const unsigned add = static_cast<unsigned>(__ldg(s));
  const int i = blockIdx.x * kScalarThreads + threadIdx.x;
  const int4 v = __ldg(x + i);
  out[i] = make_int4(static_cast<int>(v.x + add), static_cast<int>(v.y + add), static_cast<int>(v.z + add),
                     static_cast<int>(v.w + add));
}

// The compare casts' designs: 4 elements a thread (one 16-byte load, 4
// blocks of 256), or 8 (two 16-byte loads, 2 blocks; kCompareEightAThread)
constexpr bool kCompareEightAThread = false;
constexpr int kCompareElems = 32 * kLanes;  // the probes' (32, 128) int32 tile
constexpr int kCompareLoads = kCompareEightAThread ? 2 : 1;  // 16-byte loads a thread
constexpr int kCompareBlocks = kCompareElems / (4 * kCompareLoads) / kTileThreads;

// cmp_to_int8_vector and cmp_to_bf16_vector: out[i] = a[i] > than as the
// Bits-wide pattern One (0x01, the int8 1; 0x3F80, the bf16 1.0) or 0.
// Thread t loads its 4 x kCompareLoads consecutive elements as kCompareLoads
// 16-byte words, all issued before its first compare, and packs the results
// little-endian (element k in byte or halfword k) into 32-bit words that
// leave as one store: 4 or 8 bytes, or 16 for 8 bf16.  The tile's length is
// the probes', so there is no guard; no shared memory, no barrier.
template <typename Bits, uint32_t One>
__global__ void __launch_bounds__(kTileThreads)
    greater_to(const int4* __restrict__ a, int32_t than, uint32_t* __restrict__ out) {
  constexpr int kPer = 4 * kCompareLoads;                        // elements a thread
  constexpr int kWords = kPer * sizeof(Bits) / 4;                // 32-bit words of its output
  constexpr int kBits = 8 * sizeof(Bits);
  const int t = blockIdx.x * kTileThreads + threadIdx.x;
  int4 v[kCompareLoads];
#pragma unroll
  for (int w = 0; w < kCompareLoads; ++w) v[w] = __ldg(a + kCompareLoads * t + w);
  uint32_t o[kWords] = {};
#pragma unroll
  for (int w = 0; w < kCompareLoads; ++w) {
    const int32_t x[4] = {v[w].x, v[w].y, v[w].z, v[w].w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = 4 * w + k;  // the element's place in the thread's output
      o[e * kBits / 32] |= (x[k] > than ? One : 0u) << (e * kBits % 32);
    }
  }
  if constexpr (kWords == 1) {
    out[t] = o[0];
  } else if constexpr (kWords == 2) {
    reinterpret_cast<uint2*>(out)[t] = make_uint2(o[0], o[1]);
  } else {
    reinterpret_cast<uint4*>(out)[t] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// u32_shifts_popcount's designs: one block of 256 threads, a 16-byte word
// each, or 128 threads of two words each (kShiftsTwoWords)
constexpr bool kShiftsTwoWords = false;
constexpr int kShiftsThreads = kShiftsTwoWords ? kTileThreads / 2 : kTileThreads;

__device__ __forceinline__ uint32_t shift_xor_popcount(uint32_t x) {
  return (x >> 3) ^ (x << 2) ^ static_cast<uint32_t>(__popc(x));
}

__device__ __forceinline__ uint4 shift_xor_popcount(uint4 v) {
  return make_uint4(shift_xor_popcount(v.x), shift_xor_popcount(v.y), shift_xor_popcount(v.z),
                    shift_xor_popcount(v.w));
}

// (x >> 3) ^ (x << 2) ^ popcount(x) over an (8, 128) u32 tile, logical
// shifts in uint32_t: each thread loads its 16-byte words of x (the second,
// in kShiftsTwoWords, 2 KB further on) before its first shift and stores
// 16 bytes a word; no guard, no shared memory, no barrier.
__global__ void __launch_bounds__(kShiftsThreads)
    shifts_popcount(const uint4* __restrict__ a, uint4* __restrict__ out) {
  const int i = threadIdx.x;
  if constexpr (kShiftsTwoWords) {
    const uint4 v0 = __ldg(a + i), v1 = __ldg(a + i + kShiftsThreads);
    out[i] = shift_xor_popcount(v0);
    out[i + kShiftsThreads] = shift_xor_popcount(v1);
  } else {
    out[i] = shift_xor_popcount(__ldg(a + i));
  }
}

// smem_scratch_scalar_loop's designs: every thread loads the 8 words, or
// each lane one of them, summed across the lanes by shuffles (kScalarLaneSum)
constexpr bool kScalarLaneSum = false;

// The wrapping int32 sum of a[i, 0] for i < 8, filled into the (8, 128)
// output: one block of 256 threads, one 16-byte store each.  Each thread
// issues its 8 loads of a[i * 128] (a broadcast of one sector a warp) before
// its first add and adds in uint32_t, so the sum wraps as the int32 one
// does; no shared scalar, no barrier.  The other design loads a[(lane & 7),
// 0] a lane, so that every group of 8 lanes holds the 8 words, and sums them
// by three __shfl_xor_sync stages.
__global__ void __launch_bounds__(kTileThreads)
    scalar_loop_fill(const int32_t* __restrict__ a, int4* __restrict__ out) {
  uint32_t sum;
  if constexpr (kScalarLaneSum) {
    sum = __ldg(a + (threadIdx.x & (kTileRows - 1)) * kLanes);
#pragma unroll
    for (int d = 1; d < kTileRows; d <<= 1) sum += __shfl_xor_sync(kFull, sum, d);
  } else {
    uint32_t v[kTileRows];
#pragma unroll
    for (int i = 0; i < kTileRows; ++i) v[i] = __ldg(a + i * kLanes);
    sum = v[0];
#pragma unroll
    for (int i = 1; i < kTileRows; ++i) sum += v[i];
  }
  const int s = static_cast<int>(sum);
  out[threadIdx.x] = make_int4(s, s, s, s);
}

// ---------------------------------------------------------------------------
// lane and row movement: a warp a row, lane h holding elements 4h..4h+3 (the
// rolls, the lane gathers); the sublane gather and the transpose through
// shared memory

// An index into N lanes or rows (the lane gathers' row, the sublane
// gather's tile); one outside [0, N) traps rather than reading outside them.
template <int N>
__device__ __forceinline__ int checked_index(int i) {
  if (static_cast<unsigned>(i) >= static_cast<unsigned>(N)) __trap();
  return i;
}

// the lane gathers' designs: each output shuffled from the lane that holds
// it, or the warp's row through shared memory (kGatherShuffle false)
constexpr bool kGatherShuffle = true;

// out[r, c] = x[r, idx[r, c]] over 128 outputs a row from rows of W = 128
// or 256 32-bit values of any type, a warp a row, Warps rows a block.  Lane
// h loads elements W / 32 h.. of x's row (one or two 16-byte words) and
// idx[r, 4h..4h+3] (one) through restrict pointers, all in flight together.
// Each of its 4 outputs is then shuffled from the lane that holds it, W / 32
// __shfl_sync and selects an output; the other design stores the lane's
// words into the warp's row in shared memory with 16-byte stores and after
// a __syncwarp reads its 4 gathered words there.  One 16-byte store of the 4
// outputs; no block barrier.
template <int W, int Warps>
__global__ void __launch_bounds__(Warps * 32)
    gather_lanes(const int4* __restrict__ x, const int4* __restrict__ idx, int4* __restrict__ out) {
  constexpr int kPer = W / 32;      // elements of x a lane
  constexpr int kWords = kPer / 4;  // 16-byte words of x a lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int r = blockIdx.x * Warps + warp;
  int4 v[kWords];
#pragma unroll
  for (int w = 0; w < kWords; ++w) v[w] = __ldg(x + r * (W / 4) + lane * kWords + w);
  const int4 k = __ldg(idx + r * kRowWords + lane);
  const int c[4] = {checked_index<W>(k.x), checked_index<W>(k.y), checked_index<W>(k.z), checked_index<W>(k.w)};
  int32_t got[4];
  if constexpr (kGatherShuffle) {  // element e of lane h is element kPer h + e of the row
    int32_t own[kPer];
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      own[4 * w] = v[w].x;
      own[4 * w + 1] = v[w].y;
      own[4 * w + 2] = v[w].z;
      own[4 * w + 3] = v[w].w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      got[j] = 0;
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int32_t t = __shfl_sync(kFull, own[e], c[j] / kPer);
        if (c[j] % kPer == e) got[j] = t;
      }
    }
  } else {
    __shared__ alignas(16) int32_t rows[Warps][W];
    int4* row = reinterpret_cast<int4*>(rows[warp]);
#pragma unroll
    for (int w = 0; w < kWords; ++w) row[lane * kWords + w] = v[w];
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 4; ++j) got[j] = rows[warp][c[j]];
  }
  out[r * kRowWords + lane] = make_int4(got[0], got[1], got[2], got[3]);
}

// the rolls' designs: each source register shuffled from the lane that holds
// it, or the warp's row through shared memory (kRollStaged)
constexpr bool kRollStaged = false;

// np.roll along the lanes of an (8, 128) int32 tile: out[r, c] = a[r, (c -
// s) mod 128], s = Shift, or read from the device (Dynamic) together with
// the row, whose address does not depend on it.  One block of 8 warps, a
// warp a row: lane h loads elements 4h..4h+3 with one 16-byte load.  With
// s & 127 = 4q + m (0 <= m < 4; the residue for every int32, INT_MIN too),
// output register e of lane h is register (e - m) & 3 of lane h - q - [e <
// m]; so source register k goes to output register (k + m) & 3 from lane h -
// q - [k + m >= 4]: 4 independent __shfl_sync (none where a static shift
// keeps the register in its lane), then selects on the warp-uniform m (none
// for a static shift), then one 16-byte store.  The other design stores the
// lane's 16 bytes into the warp's row in shared memory and after a
// __syncwarp reads its 4 words there.
template <bool Dynamic, int Shift>
__global__ void __launch_bounds__(kTileThreads)
    roll_lanes(const int32_t* __restrict__ s, const int4* __restrict__ a, int4* __restrict__ out) {
  const int i = threadIdx.x;  // the lane's 16-byte word of the tile
  const int lane = i & 31;
  int shift = Shift;
  if constexpr (Dynamic) shift = __ldg(s);
  const int4 v = __ldg(a + i);
  const int r = shift & (kLanes - 1), q = r >> 2, m = r & 3;
  int32_t o[4];
  if constexpr (kRollStaged) {
    __shared__ alignas(16) int32_t rows[kTileRows][kLanes];
    int32_t* row = rows[i / 32];
    reinterpret_cast<int4*>(row)[lane] = v;
    __syncwarp();
#pragma unroll
    for (int e = 0; e < 4; ++e) o[e] = row[(4 * lane + e - r) & (kLanes - 1)];
  } else {
    const int32_t own[4] = {v.x, v.y, v.z, v.w};
    int32_t got[4];  // got[k]: source register k of its lane, for output register (k + m) & 3
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int back = q + (k + m >= 4);
      got[k] = (!Dynamic && back == 0) ? own[k] : __shfl_sync(kFull, own[k], (lane - back) & 31);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = (e - m) & 3;  // selects on compile-time indices: nothing goes to local memory
      o[e] = k == 0 ? got[0] : k == 1 ? got[1] : k == 2 ? got[2] : got[3];
    }
  }
  out[i] = make_int4(o[0], o[1], o[2], o[3]);
}

// The first row of an 8-row window at row `first` (read from the device) of
// a 64-row tile; a window past the tile traps (a launch error) rather than
// reading or writing outside its buffers.
__device__ __forceinline__ int window_row(int first) {
  if (first < 0 || first > 64 - kTileRows) __trap();
  return first;
}

// gather_sublanes_taa_axis0's two designs: a block a stripe of kStripe
// columns through shared memory, or no shared memory, x read at the gathered
// rows after idx (kGatherDirect: a second, dependent round trip)
constexpr bool kGatherDirect = false;
constexpr int kStripe = 16;
constexpr int kStripeWords = kStripe / 4;  // 16-byte words of a stripe's row

// out[r, c] = x[idx[r, c], c] over (64, 128) int32, 8 blocks of a 16-column
// stripe (4 KB each of x, idx and out), thread t at row t / 4, word t % 4 of
// the stripe: its 16 bytes of x and of idx loaded together, x's into the
// stripe in shared memory, one barrier, then its 4 gathered words read from
// the stripe and stored as 16 bytes.  The stripe's rows are 16 words, not
// padded, so its 16-byte stores stay aligned; a warp's read of word j of 8
// gathered rows then falls on 8 banks (up to 4 ways on random rows).
__global__ void __launch_bounds__(kTileThreads)
    gather_stripe(const int4* __restrict__ x, const int4* __restrict__ idx, int4* __restrict__ out) {
  __shared__ alignas(16) int32_t stripe[64 * kStripe];
  const int r = threadIdx.x / kStripeWords, q = threadIdx.x % kStripeWords;
  const int i = r * kRowWords + kStripeWords * blockIdx.x + q;  // 16-byte word i of the tile
  const int4 v = __ldg(x + i);
  const int4 k = __ldg(idx + i);
  *reinterpret_cast<int4*>(stripe + r * kStripe + 4 * q) = v;
  __syncthreads();
  const int32_t* col = stripe + 4 * q;
  out[i] = make_int4(col[checked_index<64>(k.x) * kStripe], col[checked_index<64>(k.y) * kStripe + 1],
                     col[checked_index<64>(k.z) * kStripe + 2], col[checked_index<64>(k.w) * kStripe + 3]);
}

// The same without shared memory: 8 blocks of 8 warps, a warp a row, each
// thread its 16 bytes of idx, then 4 loads of x at the gathered rows.
__global__ void __launch_bounds__(kTileThreads)
    gather_direct(const int32_t* __restrict__ x, const int4* __restrict__ idx, int4* __restrict__ out) {
  const int i = blockIdx.x * kTileThreads + threadIdx.x;  // 16-byte word i of the tile
  const int4 k = __ldg(idx + i);
  const int32_t* col = x + 4 * (i % kRowWords);
  out[i] = make_int4(__ldg(col + checked_index<64>(k.x) * kLanes), __ldg(col + checked_index<64>(k.y) * kLanes + 1),
                     __ldg(col + checked_index<64>(k.z) * kLanes + 2),
                     __ldg(col + checked_index<64>(k.w) * kLanes + 3));
}

// dynamic_slice_vmem_rows' two designs: every row at once (one round trip),
// or s and then the window alone (two)
constexpr bool kSliceEveryRow = true;

// 8 blocks of 8 warps, a warp a row of the (64, 128) tile: s and the thread's
// 16 bytes loaded together, stored at row - s when the row is in the window
__global__ void __launch_bounds__(kTileThreads)
    slice_every_row(const int32_t* __restrict__ s, const int4* __restrict__ a, int4* __restrict__ out) {
  const int got = __ldg(s);
  const int i = blockIdx.x * kTileThreads + threadIdx.x;  // 16-byte word i of the tile, in row i / kRowWords
  const int4 v = __ldg(a + i);
  const int row = i / kRowWords - window_row(got);
  if (row >= 0 && row < kTileRows) out[row * kRowWords + i % kRowWords] = v;
}

// one block: s, then one 16-byte word of the window a thread
__global__ void __launch_bounds__(kTileThreads)
    slice_window(const int32_t* __restrict__ s, const int4* __restrict__ a, int4* __restrict__ out) {
  out[threadIdx.x] = __ldg(a + window_row(__ldg(s)) * kRowWords + threadIdx.x);
}

// transpose_32b_128x128's designs: a 32 x 32 tile a block in shared memory
// (kTransposeShared), or 4 x 4 blocks transposed in registers, in blocks of
// kTransposeThreads
constexpr bool kTransposeShared = true;
constexpr int kTransposeThreads = 128;
constexpr int kTransposeWords = kLanes * kRowWords;  // 16-byte words of the (128, 128) tile, a thread each

// One round of a 4 x 4 transpose across the 4 lanes of a quad, lane k holding
// row k in r[0..3]: bit M of the lane index trades places with bit M of the
// register index, so r[j] with (j & M) != (k & M) becomes the partner lane's
// r[j ^ M].  Each register is picked by a select on a compile-time index, so
// nothing goes to local memory.
template <int M>
__device__ __forceinline__ void swap_index_bit(int32_t (&r)[4], int k) {
  const bool high = (k & M) != 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (j & M) continue;  // each pair (j, j | M) once
    const int32_t got = __shfl_xor_sync(kFull, high ? r[j] : r[j | M], M);
    if (high) {
      r[j] = got;
    } else {
      r[j | M] = got;
    }
  }
}

// out = a.T over (128, 128) int32, a thread a 16-byte word; a and out 16-byte
// aligned.  The 4 lanes of a quad load rows 4p..4p+3 of 4-column group g, and
// two rounds of swap_index_bit (xor 1, then xor 2) leave lane k holding output
// row 4g + k, columns 4p..4p+3: one 16-byte store.  A warp's 8 quads take 8
// consecutive groups of one p, so its loads cover 4 whole 128-byte row
// segments, and its stores 16 of each 32-byte sector of 32 output rows (the
// warp at p ^ 1 writes the other 16).  No shared memory, no barrier.
__global__ void __launch_bounds__(kTransposeThreads)
    transpose_quads(const int4* __restrict__ a, int4* __restrict__ out) {
  const int t = blockIdx.x * kTransposeThreads + threadIdx.x;
  const int k = t & 3, warp = t >> 5;
  const int p = warp >> 2, g = 8 * (warp & 3) + ((t >> 2) & 7);
  const int4 v = __ldg(a + (4 * p + k) * kRowWords + g);
  int32_t r[4] = {v.x, v.y, v.z, v.w};
  swap_index_bit<1>(r, k);
  swap_index_bit<2>(r, k);
  out[(4 * g + k) * kRowWords + p] = make_int4(r[0], r[1], r[2], r[3]);
}

// A 32 x 32 tile in shared memory, its rows in groups of 4 padded by 4 words:
// every row starts 16-byte aligned, and a warp's 4-byte reads of rows 4q + i
// (q < 8) in 4 columns fall in 32 banks.
constexpr int kSide = 32;
__host__ __device__ constexpr int padded_row(int row) { return row * kSide + 4 * (row >> 2); }

// out = a.T, a block a 32 x 32 tile (block (x, y): rows 32 y.., columns
// 32 x..): each thread loads 16 bytes of a row into the tile; after the
// barrier it reads 4 words of a column and stores them as 16 bytes of an
// output row.  Loads and stores each cover whole 128-byte row segments.
__global__ void __launch_bounds__(kSide * kSide / 4)
    transpose_tile(const int4* __restrict__ a, int4* __restrict__ out) {
  __shared__ alignas(16) int32_t tile[padded_row(kSide)];
  const int row = threadIdx.x >> 3, q = threadIdx.x & 7;
  const int4 v = __ldg(a + (kSide * blockIdx.y + row) * kRowWords + kSide / 4 * blockIdx.x + q);
  *reinterpret_cast<int4*>(tile + padded_row(row) + 4 * q) = v;
  __syncthreads();
  // output row 32 x + row is tile column `row`; its word q, tile rows 4q..4q+3
  const int4 w = make_int4(tile[padded_row(4 * q) + row], tile[padded_row(4 * q + 1) + row],
                           tile[padded_row(4 * q + 2) + row], tile[padded_row(4 * q + 3) + row]);
  out[(kSide * blockIdx.x + row) * kRowWords + kSide / 4 * blockIdx.y + q] = w;
}

// ---------------------------------------------------------------------------
// bulk copies: cp.async.bulk on an mbarrier (global to shared) or a bulk
// group (shared to global)

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Thread 0: initialise the barrier (one arrival a phase) and make it visible
// to the async proxy, so that a bulk copy may arrive on it.
__device__ __forceinline__ void init_barrier_async(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" : : "r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" : : : "memory");
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

// Thread 0: arrive on `bar` expecting `bytes`, and copy them (a multiple of
// 16, both addresses 16-byte aligned) from global to shared.
__device__ __forceinline__ void bulk_load(void* smem, const void* gmem, unsigned bytes, unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" : : "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               : : "r"(smem_addr(smem)), "l"(gmem), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// One thread: copy `bytes` from shared to global and wait until the copy has
// read its source, so that the block may exit (the write lands after it;
// nothing in the kernel reads it).
__device__ __forceinline__ void bulk_store(void* gmem, const void* smem, unsigned bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               : : "l"(gmem), "r"(smem_addr(smem)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" : : : "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" : : : "memory");
}

// Make this thread's generic-proxy writes to shared memory visible to the
// async proxy (a bulk copy that reads or overwrites them).
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" : : : "memory");
}

constexpr unsigned kRowBytes = kLanes * 4;

// dma_unaligned_row_offset's two designs: the row slice's slice_every_row
// (16-byte loads of every row with s), or a bulk copy a block of its own rows
// (kOffsetBulk)
constexpr bool kOffsetBulk = false;

// Rows [s, s + 8) of the (64, 128) src: 8 blocks of 8 warps, a block 8 rows
// of src (4 KB) and a warp a row.  Every thread loads s first; thread 0 sets
// up the block's barrier and brings the block's rows, whose address does not
// depend on s, into shared memory by one bulk copy.  After the wait a thread
// whose row is in the window stores its 16 bytes at row - s.
__global__ void __launch_bounds__(kTileThreads)
    copy_rows_in(const int32_t* __restrict__ s, const int4* __restrict__ src, int4* __restrict__ out) {
  __shared__ alignas(128) int4 rows[kTileThreads];
  __shared__ alignas(8) unsigned long long bar;
  const int got = __ldg(s);
  if (threadIdx.x == 0) {
    init_barrier_async(&bar);
    bulk_load(rows, src + blockIdx.x * kTileThreads, kTileRows * kRowBytes, &bar);
  }
  __syncthreads();  // the barrier's set-up, seen by every thread before it waits
  wait_barrier(&bar, 0);
  const int i = blockIdx.x * kTileThreads + threadIdx.x;  // 16-byte word i of src, in row i / kRowWords
  const int row = i / kRowWords - window_row(got);
  if (row >= 0 && row < kTileRows) out[row * kRowWords + i % kRowWords] = rows[threadIdx.x];
}

// dma_unaligned_row_write's two designs: the window's rows leave as 16-byte
// stores, or as one bulk copy a block (kWriteBulk)
constexpr bool kWriteBulk = false;

// The whole (64, 128) output, src's 8 rows at [s, s + 8) and zeros elsewhere:
// 8 blocks of 8 warps, a warp an output row.  s and all of src (into shared
// memory) are loaded together; a thread outside the window stores its zeros
// before the barrier, and the window leaves after it.  The zero stores
// and the bulk copy touch disjoint rows, and the bulk copy has read shared
// memory before the block exits.
template <bool kBulk>
__global__ void __launch_bounds__(kTileThreads)
    write_rows(const int32_t* __restrict__ s, const int4* __restrict__ src, int4* __restrict__ out) {
  __shared__ alignas(128) int4 rows[kTileRows * kRowWords];
  const int got = __ldg(s);
  rows[threadIdx.x] = __ldg(src + threadIdx.x);
  const int first = window_row(got);
  const int i = blockIdx.x * kTileThreads + threadIdx.x;  // 16-byte word i of the output, in row i / kRowWords
  const int row = i / kRowWords - first;
  const bool window = row >= 0 && row < kTileRows;
  if (!window) out[i] = make_int4(0, 0, 0, 0);
  if constexpr (kBulk) fence_async_shared();
  __syncthreads();
  if constexpr (!kBulk) {
    if (window) out[i] = rows[row * kRowWords + i % kRowWords];
  } else if (threadIdx.x == 0) {
    const int lo = max(first, kTileRows * static_cast<int>(blockIdx.x));
    const int hi = min(first, kTileRows * static_cast<int>(blockIdx.x)) + kTileRows;
    if (lo < hi) bulk_store(out + lo * kRowWords, rows + (lo - first) * kRowWords, (hi - lo) * kRowBytes);
  }
}

// dma_dynamic_size_rows' designs: every row loaded with s (one round trip),
// or s and then only the rows below it (kSizedCountFirst: two)
constexpr bool kSizedCountFirst = false;

// The first s[0] rows (read on the device, clamped to [0, 64]) of the (64,
// 128) src, zeros below them: 8 blocks of 8 warps, a warp a row, each thread
// loading s and its 16 bytes of src together and making one 16-byte store,
// its word or zeros.  No shared memory, no barrier, no separate zero fill.
__global__ void __launch_bounds__(kTileThreads)
    copy_rows_sized(const int32_t* __restrict__ s, const int4* __restrict__ src, int4* __restrict__ out) {
  const int rows = min(max(__ldg(s), 0), 64);
  const int i = blockIdx.x * kTileThreads + threadIdx.x;  // 16-byte word i of the tile, in row i / kRowWords
  const bool keep = i / kRowWords < rows;
  if constexpr (kSizedCountFirst) {
    out[i] = keep ? __ldg(src + i) : make_int4(0, 0, 0, 0);
  } else {
    const int4 v = __ldg(src + i);
    out[i] = keep ? v : make_int4(0, 0, 0, 0);
  }
}

// hbm_to_hbm_dma's designs: 16-byte loads and stores in blocks of
// kHbmThreads (256: one block; 32: a warp a row), or bulk copies through
// shared memory (kHbmBulk)
constexpr bool kHbmBulk = false;
constexpr int kHbmThreads = 256;

// Rows [first, first + 8) of src (the HBM-to-HBM copy's [8, 16), the
// bitcast's [0, 8) of its float tile, as bits): one 16-byte load and one
// 16-byte store a thread (src and out 16-byte aligned), no shared memory, no
// barrier.
__global__ void __launch_bounds__(kHbmThreads)
    copy_rows_direct(const int4* __restrict__ src, int first, int4* __restrict__ out) {
  const int i = blockIdx.x * kHbmThreads + threadIdx.x;
  out[i] = __ldg(src + first * kRowWords + i);
}

// The same through shared memory, as the TPU's DMA engine copies HBM to HBM
// (Hopper has no bulk copy from global to global): one thread sets up the
// mbarrier, brings the rows in by one bulk load, waits on the barrier and
// sends them out by one bulk store.
__global__ void copy_rows_staged(const int4* src, int4* out) {
  __shared__ alignas(128) int4 buf[kTileRows * kRowWords];
  __shared__ alignas(8) unsigned long long bar;
  if (threadIdx.x == 0) {
    init_barrier_async(&bar);
    bulk_load(buf, src + kTileRows * kRowWords, kTileRows * kRowBytes, &bar);
    wait_barrier(&bar, 0);
    bulk_store(out, buf, kTileRows * kRowBytes);
  }
}

// ---------------------------------------------------------------------------
// scans, sort and matmul

// cumsum_lanes_i32's designs: the 8 rows' warps in one block, or a block
// each (kCumsumLanesGrid)
constexpr bool kCumsumLanesGrid = false;
constexpr int kCumsumLanesWarps = kCumsumLanesGrid ? 1 : kTileRows;

// cumsum along the lanes of an (8, 128) int32 tile, a warp a row: lane h
// loads elements 4h..4h+3 with one 16-byte load, sums them in registers,
// takes the sum of the lanes before it from one 5-stage __shfl_up_sync scan
// of the lane totals and makes one 16-byte store.  The adds are in uint32_t,
// so that the sum wraps as the int32 cumsum does.
__global__ void __launch_bounds__(kCumsumLanesWarps * 32)
    cumsum_lanes(const int4* __restrict__ a, int4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // the lane's 16-byte word of the tile
  const int4 v = __ldg(a + i);
  const uint32_t s0 = v.x, s1 = s0 + v.y, s2 = s1 + v.z, s3 = s2 + v.w;
  uint32_t through = s3;  // the sum of lanes 0..lane
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t t = __shfl_up_sync(kFull, through, d);
    if (lane >= d) through += t;
  }
  const uint32_t before = through - s3;
  out[i] = make_int4(static_cast<int>(s0 + before), static_cast<int>(s1 + before), static_cast<int>(s2 + before),
                     static_cast<int>(s3 + before));
}

// cumsum_sublanes_f32's designs: a thread a column in registers, or the tile
// through shared memory (kCumsumStaged); kCumsumThreads columns a block
constexpr bool kCumsumStaged = false;
constexpr int kCumsumThreads = 32;
constexpr int kCumsumRows = 64;
constexpr int kCumsumWords = kCumsumThreads / 4;  // 16-byte words of a block's columns in a row

// cumsum down the rows, a thread a column: all 64 loads first (restrict
// pointers, a compile-time row count, registers), then the adds in row
// order, then the stores.  One block an SM in the launch bounds lets ptxas
// keep the 64 values live (72 registers): under the default bound it held
// 64 and issued the last 10 loads after the first add, a second round trip.
__global__ void __launch_bounds__(kCumsumThreads, 1)
    cumsum_rows(const float* __restrict__ a, float* __restrict__ out) {
  const int c = blockIdx.x * kCumsumThreads + threadIdx.x;
  float v[kCumsumRows];
#pragma unroll
  for (int r = 0; r < kCumsumRows; ++r) v[r] = __ldg(a + r * kLanes + c);
#pragma unroll
  for (int r = 1; r < kCumsumRows; ++r) v[r] += v[r - 1];
#pragma unroll
  for (int r = 0; r < kCumsumRows; ++r) out[r * kLanes + c] = v[r];
}

// The same through the block's (64, kCumsumThreads) tile in shared memory:
// 16-byte loads in, one barrier, a thread a column adding in row order in
// place, one barrier, 16-byte stores out.
__global__ void __launch_bounds__(kCumsumThreads)
    cumsum_rows_staged(const float4* __restrict__ a, float4* __restrict__ out) {
  constexpr int kLoads = kCumsumRows * kCumsumWords / kCumsumThreads;
  __shared__ float4 tile[kCumsumRows * kCumsumWords];
  const int t = threadIdx.x;
  const int col = blockIdx.x * kCumsumWords;  // the block's first 16-byte word of a row
  float4 v[kLoads];
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = j * kCumsumThreads + t;
    v[j] = __ldg(a + (i / kCumsumWords) * kRowWords + col + i % kCumsumWords);
  }
#pragma unroll
  for (int j = 0; j < kLoads; ++j) tile[j * kCumsumThreads + t] = v[j];
  __syncthreads();
  float* column = reinterpret_cast<float*>(tile) + t;
  float acc = column[0];
#pragma unroll
  for (int r = 1; r < kCumsumRows; ++r) {
    acc += column[r * kCumsumThreads];
    column[r * kCumsumThreads] = acc;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kLoads; ++j) {
    const int i = j * kCumsumThreads + t;
    out[(i / kCumsumWords) * kRowWords + col + i % kCumsumWords] = tile[i];
  }
}

// lax_sort_in_kernel's designs: kSortPer consecutive elements of a row a
// lane, 4 (a warp a row, a block a row) or 8 (kSortEightALane: 16 lanes a
// row, two rows a warp, a block a warp)
constexpr bool kSortEightALane = false;
constexpr int kSortPer = kSortEightALane ? 8 : 4;
constexpr int kSortRowLanes = kLanes / kSortPer;   // lanes a row
constexpr int kSortWords = kSortPer / 4;           // 16-byte words a lane
constexpr int kSortRows = 32 / kSortRowLanes;      // rows a block of one warp

// Each 128-wide row of the (8, 128) tile sorted ascending by a bitonic
// network, with bitonic_rows' keep_min rule: lane h of a row holds elements
// kSortPer h.. of it in v[0..kSortPer), loaded and stored 16 bytes at a time.
// A stage of distance d < kSortPer compare-exchanges the lane's own v[j] and
// v[j | d] (compile-time indices, so nothing goes to local memory); a longer
// one trades each register with lane h ^ (d / kSortPer) by __shfl_xor_sync.
// No shared memory, no barrier.
__global__ void __launch_bounds__(32) sort_rows(const int4* __restrict__ a, int4* __restrict__ out) {
  const int h = threadIdx.x % kSortRowLanes;
  const int i = (blockIdx.x * 32 + threadIdx.x) * kSortWords;  // the lane's first 16-byte word of the tile
  int32_t v[kSortPer];
#pragma unroll
  for (int w = 0; w < kSortWords; ++w) {
    const int4 x = __ldg(a + i + w);
    v[4 * w] = x.x;
    v[4 * w + 1] = x.y;
    v[4 * w + 2] = x.z;
    v[4 * w + 3] = x.w;
  }
  const int c0 = kSortPer * h;  // the row's element in v[0]
#pragma unroll
  for (int lk = 1; (1 << lk) <= kLanes; ++lk) {  // stages k = 2, 4, ..., 128
    const int k = 1 << lk;
#pragma unroll
    for (int ld = lk - 1; ld >= 0; --ld) {  // distances d = k / 2, ..., 1
      const int d = 1 << ld;
      if (d < kSortPer) {
#pragma unroll
        for (int j = 0; j < kSortPer; ++j) {
          if (j & d) continue;  // each pair (j, j | d) once: element c0 + j keeps the min when ascending
          const bool up = ((c0 + j) & k) == 0;
          const int32_t lo = min(v[j], v[j | d]), hi = max(v[j], v[j | d]);
          v[j] = up ? lo : hi;
          v[j | d] = up ? hi : lo;
        }
      } else {
        const bool keep_min = ((c0 & d) == 0) == ((c0 & k) == 0);
#pragma unroll
        for (int j = 0; j < kSortPer; ++j) {
          const int32_t p = __shfl_xor_sync(kFull, v[j], d / kSortPer, kSortRowLanes);
          v[j] = keep_min ? min(v[j], p) : max(v[j], p);
        }
      }
    }
  }
#pragma unroll
  for (int w = 0; w < kSortWords; ++w) {
    out[i + w] = make_int4(v[4 * w], v[4 * w + 1], v[4 * w + 2], v[4 * w + 3]);
  }
}

// ---------------------------------------------------------------------------
// matmul_int8_s32acc: (128, 128) int8 @ (128, 128) int8 -> int32 on wgmma
//
// Both operands go to shared memory in wgmma's K-major layout without
// swizzle: core matrices of 8 rows x 16 bytes of K, each 128 contiguous bytes
// (a row every 16).  A row group's 8 core matrices follow one another along K
// (the leading byte offset, 128), and row groups are kGroupBytes apart (the
// stride byte offset).  The 16 bytes of padding between row groups put the
// 16-byte stores of B's transposition, whose 8 lanes of a phase hold 4 row
// groups and 2 rows of each, on 8 distinct 16-byte bank groups.

constexpr int kTileN = 32;  // output columns a block: (128 / 64) x (128 / kTileN) blocks of one warpgroup
constexpr int kCoreBytes = 128;
constexpr int kGroupBytes = 8 * kCoreBytes + 16;

// Byte offset of row `row`, 16-byte chunk `chunk` of K, in the K-major layout.
__device__ __forceinline__ int kmajor_offset(int row, int chunk) {
  return (row >> 3) * kGroupBytes + chunk * kCoreBytes + (row & 7) * 16;
}

// wgmma's shared-memory matrix descriptor of the K-major layout from `p`:
// start address, leading byte offset (K) and stride byte offset (rows), each
// in 16-byte units; base offset 0, no swizzle.
__device__ __forceinline__ uint64_t kmajor_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) | static_cast<uint64_t>(kCoreBytes >> 4) << 16 |
         static_cast<uint64_t>(kGroupBytes >> 4) << 32;
}

// A 4x4 byte block transposed in registers: word i holds row i's 4 bytes on
// entry, and byte i of each row (row r in byte r) on return.
__device__ __forceinline__ void transpose4x4(uint32_t& w0, uint32_t& w1, uint32_t& w2, uint32_t& w3) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w0, w1, 0x7362);
  const uint32_t t2 = __byte_perm(w2, w3, 0x5140), t3 = __byte_perm(w2, w3, 0x7362);
  w0 = __byte_perm(t0, t2, 0x5410);
  w1 = __byte_perm(t0, t2, 0x7632);
  w2 = __byte_perm(t1, t3, 0x5410);
  w3 = __byte_perm(t1, t3, 0x7632);
}

// d += A (64 x 32 bytes) @ B (32 x kTileN) for the warpgroup, both from
// shared memory: wgmma.mma_async s8 x s8 -> s32, kTileN / 2 accumulators a
// thread.
__device__ __forceinline__ void wgmma_m64nNk32(int32_t (&d)[kTileN / 2], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
      " %16, %17, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// The warpgroup's output tile: 4 wgmma k-steps (32 bytes of K each: 2 core
// matrices, 256 bytes along K), then wait for them.
__device__ __forceinline__ void wgmma_product(int32_t (&d)[kTileN / 2], const int8_t* sa, const int8_t* sb) {
  asm volatile("wgmma.fence.sync.aligned;" : : : "memory");
#pragma unroll
  for (int k = 0; k < kLanes / 32; ++k) {
    wgmma_m64nNk32(d, kmajor_desc(sa + 2 * k * kCoreBytes), kmajor_desc(sb + 2 * k * kCoreBytes));
  }
  asm volatile("wgmma.commit_group.sync.aligned;" : : : "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" : : : "memory");
#pragma unroll
  for (int i = 0; i < kTileN / 2; ++i) asm volatile("" : "+r"(d[i]) : : "memory");  // no read of d above the wait
}

// One warpgroup a block, which computes output rows [64 x, 64 x + 64),
// columns [kTileN y, kTileN y + kTileN) for block (x, y).  Staging, every
// global load in flight at once: its rows of A as 16-byte chunks, 4 a thread,
// each stored whole (a phase's 8 lanes take 8 rows of one chunk of K: 8 bank
// groups); its columns of B as (4 columns x 16 rows) blocks, one a thread
// while they last: 4 bytes of each of 16 rows (a warp's load is the tile's
// 32 bytes of 4 rows), transposed as four 4x4 blocks in registers into 16
// bytes of K for each of the 4 columns, stored as one 16-byte word each.
// Then one wgmma product, and each thread's pairs of adjacent outputs leave
// as 8-byte stores.
__global__ void __launch_bounds__(128)
    matmul_s8(const int4* __restrict__ a, const uint32_t* __restrict__ b, int32_t* __restrict__ out) {
  constexpr int kChunks = kLanes / 16;   // 16-byte chunks of a 128-byte row: B's 16-row slabs
  constexpr int kQuads = kTileN / 4;     // 4-column groups of the tile
  constexpr int kBlocksB = kQuads * kChunks;  // B's (4 x 16) blocks
  __shared__ alignas(128) int8_t sa[8 * kGroupBytes];
  __shared__ alignas(128) int8_t sb[kTileN / 8 * kGroupBytes];  // row n of B's transpose: column n of the tile
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int row0 = 64 * blockIdx.x, col0 = kTileN * blockIdx.y;
  int4 av[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = i * 128 + t;
    av[i] = __ldg(a + (row0 + (q >> 6) * 8 + (q & 7)) * kChunks + ((q >> 3) & 7));
  }
  uint32_t bw[(kBlocksB + 127) / 128][16];
#pragma unroll
  for (int s = 0; s < (kBlocksB + 127) / 128; ++s) {
    const int blk = s * 128 + t, slab = blk / kQuads, quad = blk % kQuads;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (blk < kBlocksB) bw[s][i] = __ldg(b + (16 * slab + i) * (kLanes / 4) + col0 / 4 + quad);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = i * 128 + t;
    *reinterpret_cast<int4*>(sa + kmajor_offset((q >> 6) * 8 + (q & 7), (q >> 3) & 7)) = av[i];
  }
#pragma unroll
  for (int s = 0; s < (kBlocksB + 127) / 128; ++s) {
    const int blk = s * 128 + t, slab = blk / kQuads, quad = blk % kQuads;
    if (blk < kBlocksB) {
#pragma unroll
      for (int i = 0; i < 16; i += 4) transpose4x4(bw[s][i], bw[s][i + 1], bw[s][i + 2], bw[s][i + 3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // column 4 quad + j, the slab's 16 bytes of K
        *reinterpret_cast<int4*>(sb + kmajor_offset(4 * quad + j, slab)) =
            make_int4(bw[s][j], bw[s][4 + j], bw[s][8 + j], bw[s][12 + j]);
      }
    }
  }
  fence_async_shared();  // the generic stores, visible to wgmma's reads
  __syncthreads();

  int32_t d[kTileN / 2];
#pragma unroll
  for (int i = 0; i < kTileN / 2; ++i) d[i] = 0;
  wgmma_product(d, sa, sb);
  // accumulator 4j + h: row 16 warp + lane / 4 + 8 (h >> 1), column 8j + 2 (lane & 3) + (h & 1)
  const int row = row0 + 16 * warp + (lane >> 2), col = col0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < kTileN / 8; ++j) {
    *reinterpret_cast<int2*>(out + row * kLanes + 8 * j + col) = make_int2(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<int2*>(out + (row + 8) * kLanes + 8 * j + col) = make_int2(d[4 * j + 2], d[4 * j + 3]);
  }
}

__global__ void empty_kernel() {}

template <typename T>
const T* in(const void* p) {
  return static_cast<const T*>(p);
}

template <typename T>
T* out_(void* p) {
  return static_cast<T*>(p);
}

int done() { return static_cast<int>(cudaGetLastError()); }


}  // namespace

#define STREAM static_cast<cudaStream_t>(stream)

extern "C" {

// an empty kernel: the launch time that is the floor of every probe
int arrow_probe_empty(void* stream) {
  empty_kernel<<<1, 32, 0, STREAM>>>();
  return done();
}

int arrow_probe_grid_1d_blockspec(const void* x, void* out, void* stream) {
  add_one_tiles<<<kGridRows / kTileRows, kTileThreads, 0, STREAM>>>(in<int4>(x), out_<int4>(out));
  return done();
}

int arrow_probe_prefetch_scalar_grid(const void* s, const void* x, void* out, void* stream) {
  add_scalar_tiles<<<2 * kTileThreads / kScalarThreads, kScalarThreads, 0, STREAM>>>(in<int32_t>(s), in<int4>(x),
                                                                                   out_<int4>(out));
  return done();
}

int arrow_probe_cmp_to_int8_vector(const void* a, void* out, void* stream) {
  greater_to<uint8_t, 0x01u><<<kCompareBlocks, kTileThreads, 0, STREAM>>>(in<int4>(a), 50, out_<uint32_t>(out));
  return done();
}

int arrow_probe_cmp_to_bf16_vector(const void* a, void* out, void* stream) {
  greater_to<uint16_t, 0x3F80u><<<kCompareBlocks, kTileThreads, 0, STREAM>>>(in<int4>(a), 50, out_<uint32_t>(out));
  return done();
}

int arrow_probe_u32_shifts_popcount(const void* a, void* out, void* stream) {
  shifts_popcount<<<1, kShiftsThreads, 0, STREAM>>>(in<uint4>(a), out_<uint4>(out));
  return done();
}

int arrow_probe_bitcast_f32_u32(const void* a, void* out, void* stream) {
  copy_rows_direct<<<kTileRows * kRowWords / kHbmThreads, kHbmThreads, 0, STREAM>>>(in<int4>(a), 0, out_<int4>(out));
  return done();
}

int arrow_probe_smem_scratch_scalar_loop(const void* a, void* out, void* stream) {
  scalar_loop_fill<<<1, kTileThreads, 0, STREAM>>>(in<int32_t>(a), out_<int4>(out));
  return done();
}

int arrow_probe_gather_lanes_taa_8x128_i32(const void* x, const void* idx, void* out, void* stream) {
  gather_lanes<kLanes, 1><<<kTileRows, 32, 0, STREAM>>>(in<int4>(x), in<int4>(idx), out_<int4>(out));
  return done();
}

int arrow_probe_gather_lanes_taa_256x128_i32(const void* x, const void* idx, void* out, void* stream) {
  gather_lanes<kLanes, kTileRows>
      <<<256 / kTileRows, kTileRows * 32, 0, STREAM>>>(in<int4>(x), in<int4>(idx), out_<int4>(out));
  return done();
}

int arrow_probe_gather_lanes_f32(const void* x, const void* idx, void* out, void* stream) {
  gather_lanes<kLanes, 1><<<kTileRows, 32, 0, STREAM>>>(in<int4>(x), in<int4>(idx), out_<int4>(out));
  return done();
}

int arrow_probe_gather_lanes_256wide_2gathers(const void* t, const void* idx, void* out, void* stream) {
  gather_lanes<2 * kLanes, 1><<<kTileRows, 32, 0, STREAM>>>(in<int4>(t), in<int4>(idx), out_<int4>(out));
  return done();
}

int arrow_probe_pltpu_roll_static(const void* a, void* out, void* stream) {
  roll_lanes<false, 3><<<1, kTileThreads, 0, STREAM>>>(nullptr, in<int4>(a), out_<int4>(out));
  return done();
}

int arrow_probe_pltpu_roll_dynamic(const void* s, const void* a, void* out, void* stream) {
  roll_lanes<true, 0><<<1, kTileThreads, 0, STREAM>>>(in<int32_t>(s), in<int4>(a), out_<int4>(out));
  return done();
}

int arrow_probe_gather_sublanes_taa_axis0(const void* x, const void* idx, void* out, void* stream) {
  if (kGatherDirect) {
    gather_direct<<<64 / kTileRows, kTileThreads, 0, STREAM>>>(in<int32_t>(x), in<int4>(idx), out_<int4>(out));
  } else {
    gather_stripe<<<kLanes / kStripe, kTileThreads, 0, STREAM>>>(in<int4>(x), in<int4>(idx), out_<int4>(out));
  }
  return done();
}

int arrow_probe_dynamic_slice_vmem_rows(const void* s, const void* a, void* out, void* stream) {
  if (kSliceEveryRow) {
    slice_every_row<<<64 / kTileRows, kTileThreads, 0, STREAM>>>(in<int32_t>(s), in<int4>(a), out_<int4>(out));
  } else {
    slice_window<<<1, kTileThreads, 0, STREAM>>>(in<int32_t>(s), in<int4>(a), out_<int4>(out));
  }
  return done();
}

int arrow_probe_dynamic_store_vmem_rows(const void* s, const void* a, void* out, void* stream) {
  write_rows<kWriteBulk><<<64 / kTileRows, kTileThreads, 0, STREAM>>>(in<int32_t>(s), in<int4>(a), out_<int4>(out));
  return done();
}

int arrow_probe_transpose_32b_128x128(const void* a, void* out, void* stream) {
  if (kTransposeShared) {
    transpose_tile<<<dim3(kLanes / kSide, kLanes / kSide), kSide * kSide / 4, 0, STREAM>>>(in<int4>(a),
                                                                                          out_<int4>(out));
  } else {
    transpose_quads<<<kTransposeWords / kTransposeThreads, kTransposeThreads, 0, STREAM>>>(in<int4>(a),
                                                                                         out_<int4>(out));
  }
  return done();
}

int arrow_probe_dma_unaligned_row_offset(const void* s, const void* src, void* out, void* stream) {
  if (kOffsetBulk) {
    copy_rows_in<<<64 / kTileRows, kTileThreads, 0, STREAM>>>(in<int32_t>(s), in<int4>(src), out_<int4>(out));
  } else {
    slice_every_row<<<64 / kTileRows, kTileThreads, 0, STREAM>>>(in<int32_t>(s), in<int4>(src), out_<int4>(out));
  }
  return done();
}

int arrow_probe_dma_unaligned_row_write(const void* s, const void* src, void* out, void* stream) {
  write_rows<kWriteBulk><<<64 / kTileRows, kTileThreads, 0, STREAM>>>(in<int32_t>(s), in<int4>(src), out_<int4>(out));
  return done();
}

int arrow_probe_dma_dynamic_size_rows(const void* s, const void* src, void* out, void* stream) {
  copy_rows_sized<<<64 / kTileRows, kTileThreads, 0, STREAM>>>(in<int32_t>(s), in<int4>(src), out_<int4>(out));
  return done();
}

int arrow_probe_hbm_to_hbm_dma(const void* src, void* out, void* stream) {
  if (kHbmBulk) {
    copy_rows_staged<<<1, 32, 0, STREAM>>>(in<int4>(src), out_<int4>(out));
  } else {
    copy_rows_direct<<<kTileRows * kRowWords / kHbmThreads, kHbmThreads, 0, STREAM>>>(in<int4>(src), kTileRows,
                                                                                     out_<int4>(out));
  }
  return done();
}

int arrow_probe_cumsum_lanes_i32(const void* a, void* out, void* stream) {
  cumsum_lanes<<<kTileRows / kCumsumLanesWarps, kCumsumLanesWarps * 32, 0, STREAM>>>(in<int4>(a), out_<int4>(out));
  return done();
}

int arrow_probe_cumsum_sublanes_f32(const void* a, void* out, void* stream) {
  if (kCumsumStaged) {
    cumsum_rows_staged<<<kLanes / kCumsumThreads, kCumsumThreads, 0, STREAM>>>(in<float4>(a), out_<float4>(out));
  } else {
    cumsum_rows<<<kLanes / kCumsumThreads, kCumsumThreads, 0, STREAM>>>(in<float>(a), out_<float>(out));
  }
  return done();
}

int arrow_probe_lax_sort_in_kernel(const void* a, void* out, void* stream) {
  sort_rows<<<kTileRows / kSortRows, 32, 0, STREAM>>>(in<int4>(a), out_<int4>(out));
  return done();
}

int arrow_probe_matmul_int8_s32acc(const void* a, const void* b, void* out, void* stream) {
  matmul_s8<<<dim3(kLanes / 64, kLanes / kTileN), 128, 0, STREAM>>>(in<int4>(a), in<uint32_t>(b), out_<int32_t>(out));
  return done();
}

}  // extern "C"
