// The two Pallas kernels of tools/probe_r4.py as kernels for Hopper (sm_90a):
//
// - merge_step (probe_r4.py:177, make_step_kernel): R steps of the merge
//   step's compute on tiles held on the chip.  A step takes 4096-row windows
//   of A and B (8192-row buffers, A's at row hA, B's at hA + 7, both wrapping;
//   merge.py:86 _flat_roll_left_dyn), reverses B's (merge.py:98
//   _reverse_tile), selects the bitonic (key, tag, value) planes, cleans them
//   by 12 half-cleaner stages (distance 2048 down to 1) and adds key + value
//   into an int32 accumulator (wrapping); hA advances by 1789 mod 8192.  Two
//   forms, as in the JAX tool, that differ in the stages of distance < 128:
//   the roll-pair form runs every stage through shared memory, with the
//   roll-pair rule (the lower row keeps itself when (k, t) <= its partner's,
//   the upper row reads that decision); the XOR form runs those stages in
//   registers and through __shfl_xor_sync with the XOR-partner rule (a row
//   takes its partner where (k, t) < the partner's, negated on the upper
//   row), so it cleans them in the opposite order, as its JAX form does.
//   A block of 1024 threads holds the 4096 rows, 4 a thread: thread
//   (warp w, lane l) holds rows 128w + 32j + l, j < 4, so that distances 32
//   and 64 are between a thread's registers and shorter ones between lanes.
//   A and B live in shared memory for the whole run (the JAX kernel's VMEM),
//   beside the three exchange planes: 112 KB of dynamic shared memory.
//   The work is latency-bound: 12 stages a step, each two block barriers
//   where it exchanges through shared memory.  One block is the JAX
//   kernel's one core; the wrapper can launch one block an SM, each on the
//   same data, for the card's rate.
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
constexpr int kT = 4096;          // rows a window
constexpr int kBuf = 2 * kT;      // rows of A and of B
constexpr int kThreads = 1024;    // 4 rows a thread
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStepSmem = (2 * kBuf + 3 * kT) * 4;

struct Planes {
  int32_t k[4], t[4], v[4];
};

// The roll-pair rule at one row: keep itself where the lower of the pair is
// (k, t) <= the upper, on the lower row as on the upper.
__device__ __forceinline__ void roll_pair_rule(Planes& s, int j, bool upper, int32_t pk, int32_t pt, int32_t pv) {
  const int32_t lk = upper ? pk : s.k[j], lt = upper ? pt : s.t[j];
  const int32_t hk = upper ? s.k[j] : pk, ht = upper ? s.t[j] : pt;
  const bool keep = lk < hk || (lk == hk && lt <= ht);
  if (!keep) {
    s.k[j] = pk;
    s.t[j] = pt;
    s.v[j] = pv;
  }
}

// The XOR-partner rule at one row: take the partner where (k, t) < the
// partner's, negated on the upper row.
__device__ __forceinline__ void xor_rule(Planes& s, int j, bool upper, int32_t pk, int32_t pt, int32_t pv) {
  const bool less = s.k[j] < pk || (s.k[j] == pk && s.t[j] < pt);
  if (less != upper) {
    s.k[j] = pk;
    s.t[j] = pt;
    s.v[j] = pv;
  }
}

template <bool kXor>
__global__ void __launch_bounds__(kThreads) merge_step(const int32_t* r_dev, const int32_t* a, const int32_t* b,
                                                       int32_t* out) {
  extern __shared__ int32_t smem[];
  int32_t* sa = smem;
  int32_t* sb = sa + kBuf;
  int32_t* sk = sb + kBuf;
  int32_t* st = sk + kT;
  int32_t* sv = st + kT;
  for (int i = threadIdx.x; i < kBuf; i += kThreads) {
    sa[i] = a[i];
    sb[i] = b[i];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int steps = r_dev[0];
  __syncthreads();
  uint32_t acc[4] = {0, 0, 0, 0};
  int h = 0;
  for (int step = 0; step < steps; ++step) {
    Planes s;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = warp * kLanes + j * 32 + lane;
      const int32_t wa = sa[(i + h) & (kBuf - 1)];
      const int32_t rb = sb[(kT - 1 - i + h + 7) & (kBuf - 1)];
      const bool less = wa <= rb;
      s.k[j] = less ? wa : rb;
      s.t[j] = less ? i : 2 * kT - 1 - i;
      s.v[j] = less ? wa ^ 3 : rb ^ 5;
    }
#pragma unroll
    for (int d = kT / 2; d >= 1; d >>= 1) {
      if (kXor && d < kLanes) {
        int32_t pk[4], pt[4], pv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (d >= 32) {
            pk[j] = s.k[j ^ (d >> 5)];
            pt[j] = s.t[j ^ (d >> 5)];
            pv[j] = s.v[j ^ (d >> 5)];
          } else {
            pk[j] = __shfl_xor_sync(kFull, s.k[j], d);
            pt[j] = __shfl_xor_sync(kFull, s.t[j], d);
            pv[j] = __shfl_xor_sync(kFull, s.v[j], d);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) xor_rule(s, j, ((j * 32 + lane) & d) != 0, pk[j], pt[j], pv[j]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = warp * kLanes + j * 32 + lane;
          sk[i] = s.k[j];
          st[i] = s.t[j];
          sv[i] = s.v[j];
        }
        __syncthreads();
        int32_t pk[4], pt[4], pv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = (warp * kLanes + j * 32 + lane) ^ d;
          pk[j] = sk[p];
          pt[j] = st[p];
          pv[j] = sv[p];
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = warp * kLanes + j * 32 + lane;
          roll_pair_rule(s, j, (i & d) != 0, pk[j], pt[j], pv[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] += static_cast<uint32_t>(s.k[j]) + static_cast<uint32_t>(s.v[j]);
    h = (h + 1789) % kBuf;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) out[blockIdx.x * kT + warp * kLanes + j * 32 + lane] = static_cast<int32_t>(acc[j]);
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
  merge_step<kXor><<<blocks, kThreads, kStepSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(r), static_cast<const int32_t*>(a), static_cast<const int32_t*>(b),
      static_cast<int32_t*>(out));
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
