// eval3d forward composite (K7a) for Hopper: the response of each gaussian
// evaluated in 3D along each pixel's world-space ray.
//
// Replaces gsplat_tpu/ops/rasterize_eval3d_pallas.py:_fwd_kernel (:122,
// wrapper _fwd_call_eval3d :526).  One CTA per 16x16 tile, one thread per
// pixel, holding its ray (six floats, read from the [I, H, W, 6] image
// layout) in registers.  The CTA walks its tile's span of the (tile,
// depth)-sorted slot stream in batches of 256 slots: each thread stages one
// slot's F fields into shared memory, then every thread composites the batch
// serially, front to back, for its own pixel; the CTA leaves once every
// pixel has stopped (__syncthreads_count).  The shape of K6a
// (rasterize2d_fwd.cu).  None of the TPU kernel's machinery carries over:
// its 128-lane chunks, lane cumprod, colour matmul and double-buffered DMA.
//
// Slot fields (rasterize_eval3d_pallas.py:_field_layout :53): x (3), M
// (9), opacity, [scale (3) when `hit`], D colour channels (the last one
// replaced by the hit distance when `hit`), [3 normal components when
// `normals`].  Per pixel it writes out[I, H, W, D + 3*normals]: the D
// channels, then the normals flipped toward the ray (n . d > 0 flips), and
// T_final [I, H, W].
//
// Numeric contract: csrc/ray3d.cuh decides gate and stop, shared with the
// backward.  Every sum here is a serial float32 sum in slot order with each
// product and add rounded on its own, as the plain version
// (ops/rasterize_eval3d_kernel.py:rasterize_eval3d_fwd_plain) computes it,
// so the two agree bit for bit.  A pixel stops for good (the oracle's rule;
// the JAX Pallas kernel can resume it in a later 128-slot chunk).  A ray
// with |d|^2 <= 1e-12 starts at T = 0, as in the JAX kernel.
//
// What bounds it on the H100: operations.  Each evaluated (pixel, slot)
// pair costs ~70 f32 operations (three 3x3 products, a normalization with
// a square root and a division, a cross product, an exp), a live pair
// 2 D + 12 more, against F floats per slot read once per tile.  The design
// keeps the pair's state in registers, reads the staged batch from shared
// memory as broadcasts, and leaves early with the last pixel.
//
// COUNT instantiates the per-tile counts of contributing pairs (the
// backward's live pairs must equal them) and of evaluated pairs (the work
// behind the bound); without it the kernel carries no counter.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray3d.cuh"

namespace {

constexpr int kThreads = gs3d::kTile * gs3d::kTile;

template <int D, bool COUNT>
__global__ void __launch_bounds__(kThreads)
rasterize_eval3d_fwd_kernel(const float* __restrict__ fields, long long P,
                            const int* __restrict__ bounds, const float* __restrict__ rays,
                            bool hit, bool normals, int tiles_w, int tiles_per_image, int width,
                            int height, float* __restrict__ out, float* __restrict__ out_t,
                            int* __restrict__ pair_counts, int* __restrict__ eval_counts) {
  extern __shared__ float smem[];  // [F][kThreads] staged slot fields
  constexpr int kTile = gs3d::kTile;
  const int color0 = hit ? gs3d::kRowScale + 3 : gs3d::kRowScale;
  const int normal0 = color0 + D;
  const int F = normal0 + (normals ? 3 : 0);
  const int D_mat = hit ? D - 1 : D;  // channels read from the colour rows
  const int t = blockIdx.x;
  const int tr = threadIdx.x;

  const int im = t / tiles_per_image;
  const int tl = t - im * tiles_per_image;
  const int ty = tl / tiles_w;
  const int tx = tl - ty * tiles_w;
  const int x = tx * kTile + tr % kTile;
  const int y = ty * kTile + tr / kTile;
  const bool inside = x < width && y < height;
  const long long pix = ((long long)im * height + y) * width + x;

  gs3d::Ray r = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  if (inside) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      r.o[k] = rays[pix * 6 + k];
      r.d[k] = rays[pix * 6 + 3 + k];
    }
  }
  bool done = !(inside && gs3d::dir_norm2(r) > 1e-12f);
  float T = done ? 0.0f : 1.0f;
  float acc[D + 3];  // channels, then normals
#pragma unroll
  for (int k = 0; k < D + 3; ++k) acc[k] = 0.0f;
  int kept = 0, evaluated = 0;  // contributing and evaluated pairs (COUNT only)

  const int start = bounds[t];
  const int end = bounds[t + 1];
  const int n_batches = (end - start + kThreads - 1) / kThreads;
  for (int batch = 0; batch < n_batches; ++batch) {
    if (__syncthreads_count(done) == kThreads) break;
    const int base = start + batch * kThreads;
    const int idx = base + tr;
    if (idx < end) {
      for (int f = 0; f < F; ++f) smem[f * kThreads + tr] = fields[f * P + idx];
    }
    __syncthreads();
    const int n = min(kThreads, end - base);
    for (int j = 0; j < n && !done; ++j) {
      if (COUNT) ++evaluated;
      if (gs3d::composite_ray(r, smem + j, kThreads, hit, T,
                              [&](const gs3d::Response& s, float next_T) {
                                const float w = __fmul_rn(s.alpha, T);
#pragma unroll
                                for (int k = 0; k < D; ++k) {
                                  if (k < D_mat)
                                    acc[k] = __fadd_rn(
                                        acc[k], __fmul_rn(w, smem[(color0 + k) * kThreads + j]));
                                }
                                if (hit) acc[D - 1] = __fadd_rn(acc[D - 1], __fmul_rn(w, s.hd));
                                if (normals) {
                                  const float* nr = smem + normal0 * kThreads + j;
                                  const float nd = gs3d::dot3(nr[0], nr[kThreads], nr[2 * kThreads],
                                                              r.d[0], r.d[1], r.d[2]);
                                  const float ws = nd > 0.0f ? -w : w;
#pragma unroll
                                  for (int k = 0; k < 3; ++k)
                                    acc[D + k] = __fadd_rn(acc[D + k], __fmul_rn(ws, nr[k * kThreads]));
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
    const int D_out = D + (normals ? 3 : 0);
    float* o = out + pix * D_out;
#pragma unroll
    for (int k = 0; k < D; ++k) o[k] = acc[k];
    if (normals) {
#pragma unroll
      for (int k = 0; k < 3; ++k) o[D + k] = acc[D + k];
    }
    out_t[pix] = T;
  }
  if (COUNT) {
    const int total = gs3d::cta_count(kept);
    const int total_eval = gs3d::cta_count(evaluated);
    if (tr == 0) {
      pair_counts[t] = total;
      eval_counts[t] = total_eval;
    }
  }
}

template <int D, bool COUNT>
int launch(const float* fields, long long P, const int* bounds, const float* rays, bool hit,
           bool normals, int tiles_w, int tiles_per_image, int width, int height, int n_tiles,
           float* out, float* out_t, int* pair_counts, int* eval_counts, cudaStream_t stream) {
  const int F = gs3d::kRowScale + (hit ? 3 : 0) + D + (normals ? 3 : 0);
  const size_t smem = sizeof(float) * F * kThreads;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rasterize_eval3d_fwd_kernel<D, COUNT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rasterize_eval3d_fwd_kernel<D, COUNT><<<n_tiles, kThreads, smem, stream>>>(
      fields, P, bounds, rays, hit, normals, tiles_w, tiles_per_image, width, height, out,
      out_t, pair_counts, eval_counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// fields [F, P] f32 sorted slot rows, bounds [n_tiles+1] i32 tile spans,
// rays [I, H, W, 6] f32 world-space (origin, direction) -> out [I, H, W,
// D + 3*normals] f32, out_t [I, H, W] f32 and, unless null, pair_counts and
// eval_counts [n_tiles] i32: the contributing and the evaluated (pixel,
// slot) pairs of each tile.  F = 13 + 3*hit + D + 3*normals; tile 16; D in
// [1, 32] (at least 2 with the hit channel beside colours, 1 for it alone).
int gs_rasterize_eval3d_fwd(const float* fields, long long P, const int* bounds,
                            const float* rays, int D, int hit, int normals, int tiles_w,
                            int tiles_per_image, int width, int height, int n_tiles, float* out,
                            float* out_t, int* pair_counts, int* eval_counts,
                            cudaStream_t stream) {
  if (n_tiles == 0) return (int)cudaGetLastError();
  const bool h = hit != 0, nr = normals != 0;
  switch (D) {
#define GS_CASE(d) \
  case d:          \
    return pair_counts != nullptr \
        ? launch<d, true>(fields, P, bounds, rays, h, nr, tiles_w, tiles_per_image, width, height, n_tiles, out, out_t, pair_counts, eval_counts, stream) \
        : launch<d, false>(fields, P, bounds, rays, h, nr, tiles_w, tiles_per_image, width, height, n_tiles, out, out_t, pair_counts, eval_counts, stream);
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
