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
// Numeric contract (as the JAX oracle rasterize_ref.py:32-47 and upstream):
//   sigma = 0.5*(a*dx^2 + c*dy^2) + b*dx*dy in the direct form; sigma >=
//   -2e-3 is clamped to >= 0 (the JAX gate, rasterize_pallas.py:94, :316);
//   alpha = min(0.99, op*exp(-sigma)), kept only if sigma >= 0 and alpha >=
//   1/255; a pixel stops for good at the first gaussian that would take T
//   to <= 1e-4, and that gaussian is excluded.  (The JAX Pallas kernel can
//   resume a stopped pixel in a later 256-slot chunk; this kernel follows
//   the oracle.)  Pixel centres sit at +0.5; pixels past the image edge
//   start with T = 0 and are never written.
//   The alpha gate and the stop rule are discontinuous: one ulp of sigma or
//   T can drop or keep a gaussian whose weight is up to 1/255 (the gate) or
//   ~1e-2 (the excluded saturating one).  So sigma rounds each operation
//   on its own and T is the serial product T *= 1 - alpha, exactly as the
//   plain version computes them; only the colour sums differ in order.
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kAlphaThreshold = (float)(1.0 / 255.0);
constexpr float kMaxAlpha = 0.99f;
constexpr float kTransmittanceThreshold = 1e-4f;
constexpr float kSigmaEpsNeg = -2e-3f;
constexpr int kMaxThreads = 1024;

template <int D>
__global__ void __launch_bounds__(kMaxThreads)
rasterize_fwd_kernel(const float* __restrict__ fields, long long P,
                     const int* __restrict__ bounds, int tile, int tiles_w,
                     int tiles_per_image, int width, int height,
                     float* __restrict__ out_color, float* __restrict__ out_t) {
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
      const float dx = px - smem[0 * B + j];
      const float dy = py - smem[1 * B + j];
      const float a = smem[2 * B + j];
      const float b = smem[3 * B + j];
      const float c = smem[4 * B + j];
      // Each operation rounded on its own (no fused multiply-add), as the
      // plain version's elementwise ops round: alpha and T then agree bit
      // for bit, so the alpha gate and the stop rule, both discontinuous,
      // decide alike (see the numeric contract above).
      const float sxx = __fmul_rn(__fmul_rn(a, dx), dx);
      const float syy = __fmul_rn(__fmul_rn(c, dy), dy);
      const float sxy = __fmul_rn(__fmul_rn(b, dx), dy);
      float sigma = __fadd_rn(__fmul_rn(0.5f, __fadd_rn(sxx, syy)), sxy);
      if (sigma >= kSigmaEpsNeg) sigma = fmaxf(sigma, 0.0f);
      if (sigma < 0.0f) continue;
      const float alpha = fminf(kMaxAlpha, smem[5 * B + j] * expf(-sigma));
      if (alpha < kAlphaThreshold) continue;
      const float next_T = T * (1.0f - alpha);
      if (next_T <= kTransmittanceThreshold) {
        done = true;
        break;
      }
      const float vis = alpha * T;
#pragma unroll
      for (int k = 0; k < D; ++k) acc[k] += smem[(6 + k) * B + j] * vis;
      T = next_T;
    }
    __syncthreads();
  }

  if (inside) {
    const long long pix = ((long long)im * height + y) * width + x;
#pragma unroll
    for (int k = 0; k < D; ++k) out_color[pix * D + k] = acc[k];
    out_t[pix] = T;
  }
}

template <int D>
int launch(const float* fields, long long P, const int* bounds, int tile,
           int tiles_w, int tiles_per_image, int width, int height, int n_tiles,
           float* out_color, float* out_t, cudaStream_t stream) {
  const int threads = tile * tile;
  const size_t smem = sizeof(float) * (6 + D) * threads;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rasterize_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rasterize_fwd_kernel<D><<<n_tiles, threads, smem, stream>>>(
      fields, P, bounds, tile, tiles_w, tiles_per_image, width, height,
      out_color, out_t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// fields [6+D, P] f32 sorted slot rows, bounds [n_tiles+1] i32 tile spans ->
// out_color [I, H, W, D] f32, out_t [I, H, W] f32.  D in [1, 32].
int gs_rasterize_fwd(const float* fields, long long P, const int* bounds,
                     int D, int tile, int tiles_w, int tiles_per_image,
                     int width, int height, int n_tiles, float* out_color,
                     float* out_t, cudaStream_t stream) {
  if (n_tiles == 0) return (int)cudaGetLastError();
  switch (D) {
#define GS_CASE(d) \
  case d:          \
    return launch<d>(fields, P, bounds, tile, tiles_w, tiles_per_image, width, height, n_tiles, out_color, out_t, stream);
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
