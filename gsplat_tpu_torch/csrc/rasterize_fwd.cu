// 3DGS forward composite (K1) for Hopper.
//
// Replaces gsplat_tpu/ops/rasterize_pallas.py:_fwd_kernel (:330, wrapper
// _fwd_call :818).  One CTA per tile, one thread per pixel (tile 8, 16 or
// 32: 64, 256 or 1024 threads).  The CTA walks its tile's span of the
// depth-sorted slot stream in batches of one slot per thread: each thread
// stages one slot's 6+D fields into shared memory, then every thread
// composites the batch serially, front to back, for its own pixel.  The
// CTA stops early once every pixel is done (__syncthreads_count), the
// shape of upstream gsplat's RasterizeToPixels3DGSFwd.cu.
//
// Numeric contract: csrc/composite.cuh holds the per-(pixel, slot) sigma,
// alpha, gate and stop code, shared with the backward kernel
// (rasterize_bwd.cu), which must replay these decisions bit for bit.  (The
// JAX Pallas kernel can resume a stopped pixel in a later 256-slot chunk;
// this kernel follows the oracle, rasterize_ref.py:32-47.)  Pixel centres
// sit at +0.5; pixels past the image edge start with T = 0 and are never
// written.  The alpha gate and the stop rule are discontinuous: one ulp of
// sigma or T can drop or keep a gaussian whose weight is up to 1/255 (the
// gate) or ~1e-2 (the excluded saturating one).  So sigma rounds each
// operation on its own and T is the serial product T *= 1 - alpha, exactly
// as the plain version computes them; only the colour sums differ in order.
//
// Inputs are the sorted field rows [6+D, P] (x, y, a, b, c, op, colors),
// materialized by one gather after the sort, so each batch load is a
// coalesced row read (thread i reads element start+i of every row); reading
// through the sort permutation instead would make every load a scattered
// one.  Outputs are written straight to the image layout [I, H, W, D] and
// T [I, H, W]; the JAX package's tiled layout is not needed.
//
// What bounds it on the H100: the (pixel, slot) pairs it evaluates, ~20 f32
// operations and one exp each, against the fields it reads once per tile;
// it is bound by operations, not bytes.  The design keeps the per-pair work
// in registers and shared-memory broadcasts, and the CTA-wide early exit
// skips the batches behind saturated pixels.
//
// COUNT instantiates the per-tile count of contributing pairs (the check
// that the backward's live pairs equal them); without it the kernel carries
// no counter.

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite.cuh"

namespace {

constexpr int kMaxThreads = 1024;

template <int D, bool COUNT>
__global__ void __launch_bounds__(kMaxThreads)
rasterize_fwd_kernel(const float* __restrict__ fields, long long P,
                     const int* __restrict__ bounds, int tile, int tiles_w,
                     int tiles_per_image, int width, int height,
                     float* __restrict__ out_color, float* __restrict__ out_t,
                     int* __restrict__ pair_counts) {
  extern __shared__ float smem[];  // [6 + D][B] staged slot fields
  constexpr int F = 6 + D;
  const int B = blockDim.x;
  const int t = blockIdx.x;
  const int tr = threadIdx.x;

  const int im = t / tiles_per_image;
  const int tl = t - im * tiles_per_image;
  const int ty = tl / tiles_w;
  const int tx = tl - ty * tiles_w;
  const int x = tx * tile + tr % tile;
  const int y = ty * tile + tr / tile;
  const float px = (float)x + 0.5f;
  const float py = (float)y + 0.5f;
  const bool inside = x < width && y < height;

  bool done = !inside;
  float T = inside ? 1.0f : 0.0f;
  int kept = 0;  // pairs that contributed to this pixel
  float acc[D];
#pragma unroll
  for (int k = 0; k < D; ++k) acc[k] = 0.0f;

  const int start = bounds[t];
  const int end = bounds[t + 1];
  const int n_batches = (end - start + B - 1) / B;
  for (int batch = 0; batch < n_batches; ++batch) {
    if (__syncthreads_count(done) == B) break;
    const int base = start + batch * B;
    const int idx = base + tr;
    if (idx < end) {
#pragma unroll
      for (int f = 0; f < F; ++f) smem[f * B + tr] = fields[f * P + idx];
    }
    __syncthreads();
    const int n = min(B, end - base);
    for (int j = 0; j < n && !done; ++j) {
      if (gs::composite_pair(
          px, py, smem[0 * B + j], smem[1 * B + j], smem[2 * B + j], smem[3 * B + j],
          smem[4 * B + j], smem[5 * B + j], T,
          [&](const gs::Pair& p, float next_T) {
            const float vis = p.alpha * T;
#pragma unroll
            for (int k = 0; k < D; ++k) acc[k] += smem[(6 + k) * B + j] * vis;
            T = next_T;
            if (COUNT) ++kept;
          })) {
        done = true;
        break;
      }
    }
    __syncthreads();
  }

  if (inside) {
    const long long pix = ((long long)im * height + y) * width + x;
#pragma unroll
    for (int k = 0; k < D; ++k) out_color[pix * D + k] = acc[k];
    out_t[pix] = T;
  }
  if (COUNT) {
    // __syncthreads_count sums a predicate; the per-pixel counts go bit by bit
    int total = 0;
    for (int bit = 0; bit < 31; ++bit) {
      const int n = __syncthreads_count((kept >> bit) & 1);
      total += n << bit;
      if (__syncthreads_or(kept >> (bit + 1)) == 0) break;
    }
    if (tr == 0) pair_counts[t] = total;
  }
}

template <int D, bool COUNT>
int launch(const float* fields, long long P, const int* bounds, int tile,
           int tiles_w, int tiles_per_image, int width, int height, int n_tiles,
           float* out_color, float* out_t, int* pair_counts, cudaStream_t stream) {
  const int threads = tile * tile;
  const size_t smem = sizeof(float) * (6 + D) * threads;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rasterize_fwd_kernel<D, COUNT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rasterize_fwd_kernel<D, COUNT><<<n_tiles, threads, smem, stream>>>(
      fields, P, bounds, tile, tiles_w, tiles_per_image, width, height,
      out_color, out_t, pair_counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// fields [6+D, P] f32 sorted slot rows, bounds [n_tiles+1] i32 tile spans ->
// out_color [I, H, W, D] f32, out_t [I, H, W] f32 and, unless null,
// pair_counts [n_tiles] i32: the (pixel, slot) pairs that contributed in each
// tile (the backward's live pairs).  D in [1, 32].
int gs_rasterize_fwd(const float* fields, long long P, const int* bounds,
                     int D, int tile, int tiles_w, int tiles_per_image,
                     int width, int height, int n_tiles, float* out_color,
                     float* out_t, int* pair_counts, cudaStream_t stream) {
  if (n_tiles == 0) return (int)cudaGetLastError();
  switch (D) {
#define GS_CASE(d) \
  case d:          \
    return pair_counts != nullptr \
        ? launch<d, true>(fields, P, bounds, tile, tiles_w, tiles_per_image, width, height, n_tiles, out_color, out_t, pair_counts, stream) \
        : launch<d, false>(fields, P, bounds, tile, tiles_w, tiles_per_image, width, height, n_tiles, out_color, out_t, pair_counts, stream);
    GS_CASE(1) GS_CASE(2) GS_CASE(3) GS_CASE(4) GS_CASE(5) GS_CASE(6) GS_CASE(7) GS_CASE(8)
    GS_CASE(9) GS_CASE(10) GS_CASE(11) GS_CASE(12) GS_CASE(13) GS_CASE(14) GS_CASE(15) GS_CASE(16)
    GS_CASE(17) GS_CASE(18) GS_CASE(19) GS_CASE(20) GS_CASE(21) GS_CASE(22) GS_CASE(23) GS_CASE(24)
    GS_CASE(25) GS_CASE(26) GS_CASE(27) GS_CASE(28) GS_CASE(29) GS_CASE(30) GS_CASE(31) GS_CASE(32)
#undef GS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
