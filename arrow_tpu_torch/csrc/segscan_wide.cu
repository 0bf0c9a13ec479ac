// Kernel B2 for the 8-byte types (i64, u64, f64); see segscan.cuh.  A
// translation unit of its own so that nvcc builds it beside segscan.cu.
#include "segscan.cuh"

cudaError_t arrow_segscan_wide(const void* const* in, void* const* out, int nplanes, const void* flags,
                               int dtype, int op, long long n, int aligned, void* scratch, void* stream) {
  const Call c = make_call(in, out, flags, n, aligned, scratch, dtype, stream);
  switch (dtype) {
    case kI64: return launch_op<long long>(op, nplanes, c);
    case kU64: return launch_op<unsigned long long>(op, nplanes, c);
    default: return launch_op<double>(op, nplanes, c);
  }
}
