// The gather into the sorted order (K9) for Hopper.
//
// Replaces gsplat_tpu/ops/gather_pallas.py:_align_kernel (:274, wrapper
// align_rows :316).  On the 2DGS and eval3d paths the TPU expands every
// gaussian's fields into an emission-ordered table (K8) and gathers its
// columns into the (tile, depth) order; the TPU's per-tile chunk padding,
// windowed DMA and one-hot selection on the matrix unit are not needed, since
// a thread reads any address directly.  Two entries, each a copy, bit for bit:
//
// gs_gather_records, the path's: out[f, a] = records[flat[order[a]], f] for
// a below n_live = bounds[T] (the sorted positions of live slots), and 0 at
// and past it (the sentinel tail), which reads nothing.  records is the
// callers' gaussian-major [E, R] table (row stride S >= R floats), flat K8's
// gaussian id of each emission slot and order the sort's int64 permutation,
// read as it is.  The emission-ordered [R, cap] table is never made: a live
// slot's R fields sit in one record (76 bytes, three 32-byte sectors, at
// R = 19), and the tiles that share a gaussian share its record in L2, where
// the field-major route read one sector per field and slot.  A CTA takes
// kCols sorted positions: its threads read order and flat once per
// position, load the positions' records into shared memory (16-byte loads
// where S is a multiple of 4 and the table 16-byte aligned), then write out
// field-major, neighbouring threads on neighbouring positions, which is the
// layout K6a, K6b, K7a and K7b read.  Bound by device-memory bytes: out,
// order and flat once each, and every record that a live slot names once.
//
// gs_align_rows, the JAX-shaped interface: out[f, a] = rows[f, src[a]], and
// 0 where src[a] < 0, from a field-major [F, P] table.  One thread per
// (output column, block of kRows rows) reads src[a] once and copies kRows
// elements; writes are coalesced, reads follow the permutation.

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

constexpr int kCols = 256;  // sorted positions a CTA gathers

// records [E, S] (R of each row's S floats used), flat [cap] i32, order [A]
// i64, n_live [1] i32 -> out [R, A].  VEC: S % 4 == 0 and records 16-byte
// aligned, so that a record is loaded as S/4 float4s.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
gather_records_kernel(const float* __restrict__ records, int S, int R,
                      const int* __restrict__ flat, const long long* __restrict__ order,
                      const int* __restrict__ n_live_p, long long A, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int stride = S + 1;  // a staged record, padded: the field-major reads miss no bank
  float* rec = smem;                          // [kCols][stride]
  int* gid = (int*)(smem + kCols * stride);   // [kCols] each position's gaussian, -1: none
  const long long a0 = (long long)blockIdx.x * kCols;
  const int tr = threadIdx.x;
  const long long n_live = *n_live_p;
  const int n = (int)min((long long)kCols, A - a0);
  const int n_rec = (int)max(0LL, min((long long)n, n_live - a0));  // positions with a record

  for (int j = tr; j < kCols; j += kThreads)
    gid[j] = j < n_rec ? flat[order[a0 + j]] : -1;
  __syncthreads();

  if (VEC) {
    const int Q = S / 4;
    const float4* rec4 = reinterpret_cast<const float4*>(records);
    for (int o = tr; o < n_rec * Q; o += kThreads) {
      const int j = o / Q;
      const int q = o - j * Q;
      const float4 v = rec4[(long long)gid[j] * Q + q];
      float* dst = rec + j * stride + 4 * q;
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
  } else {
    for (int o = tr; o < n_rec * R; o += kThreads) {
      const int j = o / R;
      const int f = o - j * R;
      rec[j * stride + f] = records[(long long)gid[j] * S + f];
    }
  }
  __syncthreads();

  for (int o = tr; o < R * kCols; o += kThreads) {
    const int f = o / kCols;
    const int j = o - f * kCols;
    if (j < n) out[(long long)f * A + a0 + j] = j < n_rec ? rec[j * stride + f] : 0.0f;
  }
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

// records [E, S] f32 (row stride S >= R), flat [cap] i32 gaussian ids in
// emission order, order [A] i64 the emission slot at each sorted position,
// n_live [1] i32 (device) the sorted positions before the sentinel tail ->
// out [R, A] f32.
int gs_gather_records(const float* records, int S, int R, const int* flat,
                      const long long* order, const int* n_live, long long A, float* out,
                      cudaStream_t stream) {
  if (A > 0 && R > 0) {
    const unsigned int blocks = (unsigned int)((A + kCols - 1) / kCols);
    const size_t smem = sizeof(float) * kCols * (S + 1) + sizeof(int) * kCols;
    const bool vec = S % 4 == 0 && ((uintptr_t)records & 15) == 0;
    auto kernel = vec ? &gather_records_kernel<true> : &gather_records_kernel<false>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<blocks, kThreads, smem, stream>>>(records, S, R, flat, order, n_live, A, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
