// Segmented row sum (K5) for Hopper: out[f, g] = sum of data[f, bounds[g] :
// bounds[g+1]] for monotone bounds, float32, added in slot order.
//
// Replaces gsplat_tpu/ops/segsum_pallas.py:_segsum_kernel (:38, wrapper
// segment_rowsum :126).  It reduces the rasterizer backward's per-slot
// gradients, laid out in emission order (a gaussian's slots are contiguous),
// to one gradient row per gaussian.  The TPU kernel's one-hot bf16 matmul,
// its 12-bit hi/lo boundary transport and its 512-segment grid steps are
// workarounds for a machine without cheap gathers and are not carried over.
//
// One thread per (segment, row): the thread walks its run serially, so the
// sum has one fixed order and the result is the same from run to run (no
// atomics).  Threads of a warp own neighbouring segments of one row, whose
// runs are neighbouring addresses (a gaussian covers a handful of tiles), so
// a warp's loads fall into a few cache lines and its stores are coalesced.
// Elements at or past bounds[E] are never read, whatever they hold.
//
// What bounds it on the H100: bytes.  Each live element of data is read once
// and each output written once, 4*(F*n_live + F*E + E) bytes, with one add
// per element.  A long run is walked by a single thread; runs here are short.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segment_rowsum_kernel(const float* __restrict__ data, long long P,
                      const int* __restrict__ bounds, long long E,
                      float* __restrict__ out) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= E) return;
  const int f = blockIdx.y;
  const int lo = bounds[g];
  const int hi = bounds[g + 1];
  const float* row = data + (long long)f * P;
  float sum = 0.0f;
  for (int s = lo; s < hi; ++s) sum += row[s];
  out[(long long)f * E + g] = sum;
}

}  // namespace

extern "C" {

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// data [F, P] f32, bounds [E+1] i32 monotone with 0 <= bounds <= P ->
// out [F, E] f32.
int gs_segment_rowsum(const float* data, long long P, int F, const int* bounds,
                      long long E, float* out, cudaStream_t stream) {
  if (E == 0 || F == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((E + kThreads - 1) / kThreads), (unsigned)F);
  segment_rowsum_kernel<<<grid, kThreads, 0, stream>>>(data, P, bounds, E, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
