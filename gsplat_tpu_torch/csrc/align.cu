// Row gather into the sorted order (K9) for Hopper.
//
// Replaces gsplat_tpu/ops/gather_pallas.py:_align_kernel (:274, wrapper
// align_rows :316): out[f, a] = rows[f, src[a]], and 0 where src[a] < 0,
// copied bit for bit.  On the 2DGS path src is the (tile, depth) sort's
// permutation of the emission slots and out is the sorted field table the
// composite reads; the TPU's per-tile chunk padding, windowed DMA and
// one-hot selection on the matrix unit are not needed, since a thread reads
// any address directly.
//
// One thread per (output column, block of kRows rows): it reads src[a] once
// and copies kRows elements.  Writes are coalesced (neighbouring threads,
// neighbouring columns); reads follow the permutation.  Bound by
// device-memory bytes: each of F rows is read and written once, plus src.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;

__global__ void align_rows_kernel(const float* __restrict__ rows, long long P,
                                  const int* __restrict__ src, long long A, int F,
                                  float* __restrict__ out) {
  const long long a = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (a >= A) return;
  const int s = src[a];
  const int f0 = blockIdx.y * kRows;
  const int f1 = min(f0 + kRows, F);
  for (int f = f0; f < f1; ++f)
    out[(long long)f * A + a] = s >= 0 ? rows[(long long)f * P + s] : 0.0f;
}

}  // namespace

extern "C" {

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// rows [F, P] f32, src [A] i32 (-1: padding, else < P) -> out [F, A] f32.
int gs_align_rows(const float* rows, long long P, const int* src, long long A, int F,
                  float* out, cudaStream_t stream) {
  if (A > 0 && F > 0) {
    dim3 grid((unsigned int)((A + kThreads - 1) / kThreads), (unsigned int)((F + kRows - 1) / kRows));
    align_rows_kernel<<<grid, kThreads, 0, stream>>>(rows, P, src, A, F, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
