// 2DGS surfel forward composite (K6a) for Hopper.
//
// Replaces gsplat_tpu/ops/rasterize2d_pallas.py:_fwd_kernel (:92, wrapper
// _fwd_call_2dgs :476).  One CTA per 16x16 tile, one thread per pixel.  The
// CTA walks its tile's span of the (tile, depth)-sorted slot stream in
// batches of 256 slots: each thread stages one slot's 15+D fields into
// shared memory, then every thread composites the batch serially, front to
// back, for its own pixel; the CTA leaves once every pixel has stopped
// (__syncthreads_count).  The shape of K1 (rasterize_fwd.cu) and of
// upstream gsplat's RasterizeToPixels2DGSFwd.cu.
//
// Per pixel it writes out[I, H, W, D+5] = (D colour channels with depth
// last, 3 normal components, distortion, median depth), T_final [I, H, W]
// and the median slot [I, H, W] as an int32 sorted position (-1: none).
// The JAX kernel keeps that slot in float32, which rounds above 2^24
// positions; an integer cannot.  Distortion is 2*sum_i w_i (m_i A_i - B_i)
// with m the depth channel and A_i, B_i the exclusive running sums of w and
// w*m (the oracle's cumsum(w) - w, rasterize2d_ref.py:120); the median is
// m at the last contributing surfel whose entry T is above 0.5.
//
// Numeric contract: csrc/surfel.cuh decides gate and stop, shared with the
// backward (rasterize2d_bwd.cu).  Every sum here is a serial float32 sum in
// slot order with each product and add rounded on its own, as the plain
// version (ops/rasterize2d_kernel.py:rasterize2d_fwd_plain) computes it, so
// the two agree bit for bit.  The pixel stops for good (the oracle's rule);
// the JAX Pallas kernel can resume it in a later 128-slot chunk.
//
// What bounds it on the H100: operations.  Each evaluated (pixel, slot)
// pair costs ~45 f32 operations (two 3-vectors, a cross product, two
// divisions, the filter, an exp), a live pair 2(D+3) + 9 more, against
// 15+D floats per slot read once per tile.  The design keeps the per-pair
// state in registers, reads the batch from shared memory as broadcasts, and
// leaves early with the last pixel.
//
// COUNT instantiates the per-tile counts of contributing pairs (the
// backward's live pairs must equal them) and of evaluated pairs (the work
// behind the bound); without it the kernel carries no counter.

#include <cuda_runtime.h>
#include <stdint.h>

#include "surfel.cuh"

namespace {

constexpr int kThreads = gs2d::kTile * gs2d::kTile;

template <int D, bool COUNT>
__global__ void __launch_bounds__(kThreads)
rasterize2d_fwd_kernel(const float* __restrict__ fields, long long P,
                       const int* __restrict__ bounds, int tiles_w, int tiles_per_image,
                       int width, int height, float* __restrict__ out,
                       float* __restrict__ out_t, int* __restrict__ med_slot_out,
                       int* __restrict__ pair_counts, int* __restrict__ eval_counts) {
  extern __shared__ float smem[];  // [15 + D][kThreads] staged slot fields
  constexpr int F = 15 + D;
  constexpr int kTile = gs2d::kTile;
  const int t = blockIdx.x;
  const int tr = threadIdx.x;

  const int im = t / tiles_per_image;
  const int tl = t - im * tiles_per_image;
  const int ty = tl / tiles_w;
  const int tx = tl - ty * tiles_w;
  const int x = tx * kTile + tr % kTile;
  const int y = ty * kTile + tr / kTile;
  const float px = (float)x + 0.5f;
  const float py = (float)y + 0.5f;
  const bool inside = x < width && y < height;

  bool done = !inside;
  float T = inside ? 1.0f : 0.0f;
  float acc[D + 3];  // colours, then normals
#pragma unroll
  for (int k = 0; k < D + 3; ++k) acc[k] = 0.0f;
  float dist = 0.0f, A = 0.0f, B = 0.0f, med = 0.0f;
  int med_slot = -1;
  int kept = 0, evaluated = 0;  // contributing and evaluated pairs (COUNT only)

  const int start = bounds[t];
  const int end = bounds[t + 1];
  const int n_batches = (end - start + kThreads - 1) / kThreads;
  for (int batch = 0; batch < n_batches; ++batch) {
    if (__syncthreads_count(done) == kThreads) break;
    const int base = start + batch * kThreads;
    const int idx = base + tr;
    if (idx < end) {
#pragma unroll
      for (int f = 0; f < F; ++f) smem[f * kThreads + tr] = fields[f * P + idx];
    }
    __syncthreads();
    const int n = min(kThreads, end - base);
    for (int j = 0; j < n && !done; ++j) {
      if (COUNT) ++evaluated;
      if (gs2d::composite_surfel(
              px, py, smem + j, kThreads, T, [&](const gs2d::Surfel& s, float next_T) {
                const float w = __fmul_rn(s.alpha, T);
#pragma unroll
                for (int k = 0; k < D + 3; ++k)
                  acc[k] = __fadd_rn(acc[k], __fmul_rn(w, smem[(gs2d::kRowColor + k) * kThreads + j]));
                const float m = smem[(gs2d::kRowColor + D - 1) * kThreads + j];
                dist = __fadd_rn(dist, __fmul_rn(__fmul_rn(2.0f, w),
                                                 __fsub_rn(__fmul_rn(m, A), B)));
                A = __fadd_rn(A, w);
                B = __fadd_rn(B, __fmul_rn(w, m));
                if (T > 0.5f) {
                  med = m;
                  med_slot = base + j;
                }
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
    float* o = out + pix * (D + 5);
#pragma unroll
    for (int k = 0; k < D + 3; ++k) o[k] = acc[k];
    o[D + 3] = dist;
    o[D + 4] = med;
    out_t[pix] = T;
    med_slot_out[pix] = med_slot;
  }
  if (COUNT) {
    const int total = gs2d::cta_count(kept);
    const int total_eval = gs2d::cta_count(evaluated);
    if (tr == 0) {
      pair_counts[t] = total;
      eval_counts[t] = total_eval;
    }
  }
}

template <int D, bool COUNT>
int launch(const float* fields, long long P, const int* bounds, int tiles_w,
           int tiles_per_image, int width, int height, int n_tiles, float* out, float* out_t,
           int* med_slot, int* pair_counts, int* eval_counts, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (15 + D) * kThreads;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rasterize2d_fwd_kernel<D, COUNT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rasterize2d_fwd_kernel<D, COUNT><<<n_tiles, kThreads, smem, stream>>>(
      fields, P, bounds, tiles_w, tiles_per_image, width, height, out, out_t, med_slot,
      pair_counts, eval_counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// fields [15+D, P] f32 sorted slot rows, bounds [n_tiles+1] i32 tile spans ->
// out [I, H, W, D+5] f32, out_t [I, H, W] f32, med_slot [I, H, W] i32 and,
// unless null, pair_counts and eval_counts [n_tiles] i32: the contributing
// and the evaluated (pixel, slot) pairs of each tile.  Tile 16; D in [1, 32].
int gs_rasterize2d_fwd(const float* fields, long long P, const int* bounds, int D,
                       int tiles_w, int tiles_per_image, int width, int height, int n_tiles,
                       float* out, float* out_t, int* med_slot, int* pair_counts,
                       int* eval_counts, cudaStream_t stream) {
  if (n_tiles == 0) return (int)cudaGetLastError();
  switch (D) {
#define GS_CASE(d) \
  case d:          \
    return pair_counts != nullptr \
        ? launch<d, true>(fields, P, bounds, tiles_w, tiles_per_image, width, height, n_tiles, out, out_t, med_slot, pair_counts, eval_counts, stream) \
        : launch<d, false>(fields, P, bounds, tiles_w, tiles_per_image, width, height, n_tiles, out, out_t, med_slot, pair_counts, eval_counts, stream);
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
