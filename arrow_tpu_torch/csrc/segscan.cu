// Kernel B2, the inclusive segmented scan of one to three planes: the entry
// points and the launches of the 4-byte types (i32, u32, f32).  The kernel and
// its design notes are in segscan.cuh; segscan_wide.cu launches the 8-byte
// types.
#include "segscan.cuh"

// Bytes of scratch (tile counter and descriptors) the scan needs.
extern "C" long long arrow_segscan_scratch_bytes(long long n, int dtype, int op, int nplanes) {
  return scratch_bytes(n, dtype, op, nplanes);
}

// in/out: nplanes (1-3) pointers to n elements of `dtype`; flags: n bytes
// (0 = continue) or null for a plain scan; aligned: every pointer is 16-byte
// aligned; scratch: arrow_segscan_scratch_bytes(...) bytes, zeroed here.
extern "C" int arrow_segscan(const void* const* in, void* const* out, int nplanes, const void* flags,
                             int dtype, int op, long long n, int aligned, void* scratch, void* stream) {
  if (n < 0 || n >= (1LL << 40) || nplanes < 1 || nplanes > kMaxPlanes || dtype < kI32 ||
      dtype > kF64 || op < kAdd || op > kFirst)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaError_t err = cudaMemsetAsync(scratch, 0, static_cast<size_t>(scratch_bytes(n, dtype, op, nplanes)),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (item_bytes(dtype) == 8)
    return static_cast<int>(arrow_segscan_wide(in, out, nplanes, flags, dtype, op, n, aligned, scratch, stream));
  const Call c = make_call(in, out, flags, n, aligned, scratch, dtype, stream);
  switch (dtype) {
    case kI32: err = launch_op<int>(op, nplanes, c); break;
    case kU32: err = launch_op<unsigned>(op, nplanes, c); break;
    default: err = launch_op<float>(op, nplanes, c); break;
  }
  return static_cast<int>(err);
}
