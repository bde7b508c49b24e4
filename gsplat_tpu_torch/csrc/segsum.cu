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
// What bounds it on the H100: bytes.  Each live element of data is read once
// and each output written once, 4*(F*n_live + F*E + E) bytes, with one add
// per element.
//
// Design.  One thread per (segment, row): the thread adds its run serially,
// in slot order, from 0, as the plain version does, so the two agree bit
// for bit and nothing is accumulated with atomics.  A warp takes 32
// neighbouring segments of one row, whose runs are neighbouring addresses,
// and its lanes walk them side by side; with one load in flight a lane, in
// nearly every step some lane enters a new cache line and the warp waits on
// it.  So a lane issues every load of a typical run at once: the few floats
// before the first 16-byte boundary, the first kBlock 16-byte blocks and the
// few floats after the last boundary, then adds them in order; a longer run
// loads its next kBlock blocks while it adds these.  Elements at or past
// bounds[E] are never read.
//
// Staging a CTA's or a warp's contiguous span into shared memory with
// cp.async was measured too and was slower: with runs of ~20 slots the
// serial sums, and a chunk's longest run at each barrier, set the pace, not
// the copy (PERF.md, Findings).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 4;  // 16-byte loads in flight a lane, beyond the run's ends

__global__ void __launch_bounds__(kThreads)
segment_rowsum_kernel(const float* __restrict__ data, long long P,
                      const int* __restrict__ bounds, long long E, float* __restrict__ out) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= E) return;
  const int f = blockIdx.y;
  const int lo = bounds[g];
  const int n = bounds[g + 1] - lo;
  const float* p = data + (long long)f * P + lo;
  // the run: head floats, body 16-byte blocks, tail floats
  const int head = min(n, (int)((4 - (((uintptr_t)p >> 2) & 3)) & 3));
  const int body = (n - head) >> 2;
  const int tail = n - head - 4 * body;
  const float4* q = reinterpret_cast<const float4*>(p + head);
  const float* t = p + head + 4 * body;
  float h[3], tl[3];
  float4 v[kBlock];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    h[i] = i < head ? p[i] : 0.0f;
    tl[i] = i < tail ? t[i] : 0.0f;
  }
#pragma unroll
  for (int u = 0; u < kBlock; ++u)
    if (u < body) v[u] = q[u];

  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    if (i < head) sum += h[i];
  for (int b = 0; b < body; b += kBlock) {
    float4 next[kBlock];
#pragma unroll
    for (int u = 0; u < kBlock; ++u)
      if (b + kBlock + u < body) next[u] = q[b + kBlock + u];
#pragma unroll
    for (int u = 0; u < kBlock; ++u) {
      if (b + u < body) {
        sum += v[u].x;
        sum += v[u].y;
        sum += v[u].z;
        sum += v[u].w;
      }
    }
#pragma unroll
    for (int u = 0; u < kBlock; ++u) v[u] = next[u];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    if (i < tail) sum += tl[i];
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
