// The two Pallas kernels of tools/probe_r4.py as kernels for Hopper (sm_90a):
//
// - merge_step (probe_r4.py:177, make_step_kernel): R steps of the merge
//   step's compute on tiles held on the chip.  A step takes 4096-row windows
//   of A and B (8192-row buffers, A's at row hA, B's at hA + 7, both wrapping;
//   merge.py:86 _flat_roll_left_dyn), reverses B's (merge.py:98
//   _reverse_tile), selects the bitonic (key k, tag t, value v) rows, cleans
//   them by 12 half-cleaner stages (distance 2048 down to 1) and adds k + v
//   into an int32 accumulator (wrapping); hA advances by 1789 mod 8192.  Row
//   i takes A's value where A's <= B's (t = i, v = k ^ 3), else B's (t =
//   8191 - i, v = k ^ 5).  Two forms, as in the JAX tool: the roll-pair form
//   puts the lesser row of each pair on the lower row (bit d of the row
//   index clear) at every stage; the XOR form does so at distances of 128
//   and more, and puts it on the upper row below 128, as its JAX form does.
//
//   Two invariants make a row one 64-bit key.  The tags are unique (i <
//   4096 for A's values, 8191 - i >= 4096 for B's), so no two rows have
//   equal (k, t), and both forms' rules are a plain min/max of (k, t) a
//   pair.  And v is a function of (k, t): v = k ^ (t < 4096 ? 3 : 5).  So a
//   step cleans key = (k ^ 0x80000000) << 13 | t, unsigned, which orders as
//   (k, t), and rebuilds k and v from it at the end.
//
//   A block of 256 threads holds the 4096 rows, 16 a thread, in layouts of
//   the row index's 12 bits with 4 of them in a thread's registers, so that
//   a stage is between two registers of a thread or two lanes of a warp:
//   (1) bits 11-8 in registers (stages 2048-256), built from the windows;
//   (2) bits 7-4 in registers (stages 128-16) and bits 3-0 in the lane
//   (stages 8-1 by __shfl_xor_sync), which holds the accumulator.  One
//   exchange through shared memory a step moves the keys from (1) to (2),
//   8 bytes a row each way, behind one block barrier; the steps take two
//   buffers in turns, so that no write of a step meets a read of the step
//   before.  The writer stores a row as 8 bytes, the reader loads two rows
//   as 16 (16 bytes both ways would need a bit in registers in both
//   layouts); layout 1's lane bits 3 and 4 are the row's 4 and 3, so that
//   both sides are free of bank conflicts.  The exchange design
//   (kStepShuffle false) moves the keys a second time, through a buffer
//   padded by 16 bytes every 128, to (3) bits 3-0 in registers (stages 8-1,
//   the accumulator, 16-byte stores out): two barriers a step, 16 more
//   shared bytes a row and no shuffle; on an H100 it took 1.004-1.006x as
//   long a step and 1.05-1.07x as long a call at R = 3, in turns, and the
//   earlier design (1024 threads of 4 rows, every stage or the five longest
//   through shared memory between two barriers) 3.07x (roll-pair) and 2.50x
//   (XOR) as long a step (tools/probe_designs.py).  A and B live in shared
//   memory for the whole run (the JAX kernel's VMEM), brought in by 16-byte
//   loads: 64 KB beside 68 KB of exchange buffers.  Bound by operations: a
//   step is 12 stages of 2048 64-bit compare-exchanges (2 compares and 4
//   selects each) on one SM's 64 integer lanes a clock.  One block is the
//   JAX kernel's one core; the wrapper can launch one block an SM, each on
//   the same data, for the card's rate.
// - mask_matmul (probe_r4.py:209, conv_kern): (x > 0) on a (128, 128) int32
//   tile as bf16 A fragments built in registers, times ones(128, 128) bf16,
//   by mma.sync m16n8k16 with f32 accumulators, rounded to bf16.  The TPU's
//   compiler refused a bf16 accumulator; f32 accumulators are the card's
//   answer, and the counts (at most 128) are exact in both.
//
// One C entry a kernel, in the order of the JAX kernel's arguments (the
// device scalar R first); each returns cudaGetLastError().  The wrappers are
// in arrow_tpu_torch/tools/probe_r4.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;
constexpr int kT = 4096;      // rows a window
constexpr int kBuf = 2 * kT;  // rows of A and of B
constexpr unsigned kFull = 0xffffffffu;

// the merge step's designs: stages 8-1 between the lanes of layout 2
// (kStepShuffle), or in layout 3 through a second exchange
constexpr bool kStepShuffle = true;
constexpr int kStepThreads = 256;
constexpr int kRows = kT / kStepThreads;     // rows a thread
constexpr int kSlots = kT / 2 + kT / 16;     // 16-byte slots of the second buffer: one pad every 8
constexpr int kStepSmem = 2 * kBuf * 4 + (kT / 2 + kSlots) * 16;

// (k, t) as one unsigned 64-bit key that orders as (k, t)
__device__ __forceinline__ uint64_t pack_row(int32_t k, int t) {
  return static_cast<uint64_t>(static_cast<uint32_t>(k) ^ 0x80000000u) << 13 | static_cast<uint32_t>(t);
}

// k + v of a cleaned key, both rebuilt from it (wrapping)
__device__ __forceinline__ uint32_t row_sum(uint64_t key) {
  const uint32_t k = static_cast<uint32_t>(key >> 13) ^ 0x80000000u;
  return k + (k ^ (key & kT ? 5u : 3u));
}

// One stage between the registers kDist apart: the lesser key to the lower
// register, which holds the lower row, or to the upper one (kMaxLower).
template <int kDist, bool kMaxLower>
__device__ __forceinline__ void clean(uint64_t (&key)[kRows]) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r & kDist) continue;
    const uint64_t lo = key[r], hi = key[r | kDist];
    const bool swap = kMaxLower ? lo < hi : hi < lo;
    key[r] = swap ? hi : lo;
    key[r | kDist] = swap ? lo : hi;
  }
}

// One stage between the lanes kDist apart: the lesser key to the lane whose
// bit kDist is clear, which holds the lower row, or to the other (kMaxLower).
template <int kDist, bool kMaxLower>
__device__ __forceinline__ void clean_lanes(uint64_t (&key)[kRows], int lane) {
  const bool lower = (lane & kDist) == 0;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const uint64_t p = __shfl_xor_sync(kFull, key[r], kDist);
    key[r] = (p < key[r]) == (lower != kMaxLower) ? p : key[r];
  }
}

template <bool kXor>
__global__ void __launch_bounds__(kStepThreads, 1)
    merge_step(const int32_t* __restrict__ r_dev, const int4* __restrict__ a, const int4* __restrict__ b,
               int4* __restrict__ out) {
  extern __shared__ int4 smem[];
  const int32_t* sa = reinterpret_cast<const int32_t*>(smem);
  const int32_t* sb = sa + kBuf;
  uint64_t* x1 = reinterpret_cast<uint64_t*>(smem + 2 * kBuf / 4);  // layout 1 to 2
  uint64_t* x2 = x1 + kT;  // the odd steps' 1 to 2; without kStepShuffle, 2 to 3
  const int tid = threadIdx.x;
  const int steps = __ldg(r_dev);
#pragma unroll
  for (int j = 0; j < kBuf / 4; j += kStepThreads) {
    smem[j + tid] = __ldg(a + j + tid);
    smem[kBuf / 4 + j + tid] = __ldg(b + j + tid);
  }
  // Layout 1: register r holds row r << 8 | t1, t1 the thread index with
  // bits 3 and 4 swapped, so that a half-warp's rows cover row bit 4, which
  // pairs the rows of the first buffer.  Layout 2: register r holds row
  // row2 | r << 4.  Layout 3: register r holds row tid << 4 | r.
  const int t1 = (tid & ~0x18) | (tid & 8) << 1 | (tid & 16) >> 1;
  const int row2 = (tid >> 4) << 8 | (tid & 15);
  // The first buffer holds row i at word (i >> 5) << 5 | (i & 15) << 1 |
  // (i >> 4 & 1): rows i and i | 16 share 16 bytes.  The second holds rows
  // 2c and 2c + 1 at 16-byte slot c + (c >> 3).
  const int put1 = (t1 & 0xE0) | (t1 & 15) << 1 | (t1 >> 4 & 1);       // + (r << 8)
  const int get1 = (tid >> 4) << 8 | (tid & 15) << 1;                   // + (q << 5): rows of 2q and 2q + 1
  const int put2 = 2 * ((tid >> 4) * 144 + ((tid & 15) >> 1)) + (tid & 1);  // + 18 r
  const int get2 = 18 * tid;                                             // + 2 q
  __syncthreads();
  uint32_t acc[kRows] = {};
  int h = 0;
  for (int step = 0; step < steps; ++step) {
    uint64_t key[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = r << 8 | t1;
      const int32_t wa = sa[(i + h) & (kBuf - 1)];
      const int32_t rb = sb[(kT + 6 - i + h) & (kBuf - 1)];
      key[r] = pack_row(min(wa, rb), wa <= rb ? i : kBuf - 1 - i);
    }
    clean<8, false>(key);  // distances 2048-256
    clean<4, false>(key);
    clean<2, false>(key);
    clean<1, false>(key);
    uint64_t* x = kStepShuffle && (step & 1) ? x2 : x1;
#pragma unroll
    for (int r = 0; r < kRows; ++r) x[(r << 8) + put1] = key[r];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kRows / 2; ++q) {
      const ulonglong2 two = *reinterpret_cast<const ulonglong2*>(x + get1 + (q << 5));
      key[2 * q] = two.x;
      key[2 * q + 1] = two.y;
    }
    clean<8, false>(key);  // distances 128-16: the XOR form's lesser row goes up below 128
    clean<4, kXor>(key);
    clean<2, kXor>(key);
    clean<1, kXor>(key);
    if constexpr (kStepShuffle) {
      const int lane = tid & 31;
      clean_lanes<8, kXor>(key, lane);
      clean_lanes<4, kXor>(key, lane);
      clean_lanes<2, kXor>(key, lane);
      clean_lanes<1, kXor>(key, lane);
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) x2[put2 + 18 * r] = key[r];
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kRows / 2; ++q) {
        const ulonglong2 two = *reinterpret_cast<const ulonglong2*>(x2 + get2 + 2 * q);
        key[2 * q] = two.x;
        key[2 * q + 1] = two.y;
      }
      clean<8, kXor>(key);  // distances 8-1
      clean<4, kXor>(key);
      clean<2, kXor>(key);
      clean<1, kXor>(key);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] += row_sum(key[r]);
    h = (h + 1789) & (kBuf - 1);
  }
  if constexpr (kStepShuffle) {
    int32_t* o = reinterpret_cast<int32_t*>(out + blockIdx.x * (kT / 4)) + row2;
#pragma unroll
    for (int r = 0; r < kRows; ++r) o[r << 4] = static_cast<int32_t>(acc[r]);
  } else {
    int4* o = out + blockIdx.x * (kT / 4) + tid * (kRows / 4);
#pragma unroll
    for (int j = 0; j < kRows / 4; ++j) {
      o[j] = make_int4(static_cast<int32_t>(acc[4 * j]), static_cast<int32_t>(acc[4 * j + 1]),
                       static_cast<int32_t>(acc[4 * j + 2]), static_cast<int32_t>(acc[4 * j + 3]));
    }
  }
}

// (x > 0) as bf16 @ ones(128, 128) bf16 -> bf16: warp w computes rows
// [16w, 16w + 16) as 16 m16n8 tiles over 8 k16 steps.  A's fragments are
// built from x in registers (bf16 1.0 is 0x3F80); B is all ones, so its
// fragment is two registers of 1.0 pairs.
__global__ void mask_matmul(const int32_t* x, uint16_t* out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tg = lane & 3;
  const int m0 = (threadIdx.x >> 5) * 16;
  auto pair = [&](int row, int col) {
    const int32_t* p = x + row * kLanes + col;
    return (p[0] > 0 ? 0x3F80u : 0u) | ((p[1] > 0 ? 0x3F80u : 0u) << 16);
  };
  constexpr uint32_t kOnes = 0x3F803F80u;
  float c[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.0f;
#pragma unroll
  for (int k0 = 0; k0 < kLanes; k0 += 16) {
    const uint32_t a0 = pair(m0 + g, k0 + tg * 2), a1 = pair(m0 + g + 8, k0 + tg * 2);
    const uint32_t a2 = pair(m0 + g, k0 + 8 + tg * 2), a3 = pair(m0 + g + 8, k0 + 8 + tg * 2);
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      asm volatile(
          "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
          "{%0, %1, %2, %3};"
          : "+f"(c[n][0]), "+f"(c[n][1]), "+f"(c[n][2]), "+f"(c[n][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(kOnes), "r"(kOnes));
    }
  }
  auto bf16 = [](float f) { return static_cast<uint16_t>(__bfloat16_as_ushort(__float2bfloat16_rn(f))); };
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int col = n * 8 + tg * 2;
    out[(m0 + g) * kLanes + col] = bf16(c[n][0]);
    out[(m0 + g) * kLanes + col + 1] = bf16(c[n][1]);
    out[(m0 + g + 8) * kLanes + col] = bf16(c[n][2]);
    out[(m0 + g + 8) * kLanes + col + 1] = bf16(c[n][3]);
  }
}

template <bool kXor>
int launch_step(const void* r, const void* a, const void* b, void* out, int blocks, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(merge_step<kXor>, cudaFuncAttributeMaxDynamicSharedMemorySize, kStepSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_step<kXor><<<blocks, kStepThreads, kStepSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(r), static_cast<const int4*>(a), static_cast<const int4*>(b),
      static_cast<int4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// `blocks` blocks, each the whole step on the same data into its own
// (32, 128) slice of out
int arrow_probe_mb_step_rollpair(const void* r, const void* a, const void* b, void* out, int blocks,
                                 void* stream) {
  return launch_step<false>(r, a, b, out, blocks, stream);
}

int arrow_probe_mb_step_taa(const void* r, const void* a, const void* b, void* out, int blocks, void* stream) {
  return launch_step<true>(r, a, b, out, blocks, stream);
}

int arrow_probe_i1_to_bf16_astype(const void* x, void* out, void* stream) {
  mask_matmul<<<1, 8 * 32, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const int32_t*>(x),
                                                                   static_cast<uint16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
