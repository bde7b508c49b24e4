// eval3d composite backward (K7b) for Hopper.
//
// Replaces gsplat_tpu/ops/rasterize_eval3d_pallas.py:_bwd_kernel (:232,
// wrapper _bwd_call_eval3d :570).  What it computes, per pixel p and live
// slot i of p's tile, front to back, with w_i = alpha_i T_i, the channel
// cotangents v_ch, d_i = v_ch . value_i (colours, the hit distance, the
// flipped normals), Dtot = v_ch . out_p and E_i = sum_{j<=i} w_j d_j
// (:356-364):
//   v_alpha = d_i T_i - (Dtot - E_i)/(1-alpha_i) - v_T T_final/(1-alpha_i),
// then v_sigma = -alpha v_alpha and v_op = exp(-sigma) v_alpha where alpha
// was not clamped; v_c = v_sigma c; through c = u^ x g, v_u^ = g x v_c and
// v_g = v_c x u^; the hit distance hd = hit_t |s u^| adds v_hd = w v_hit
// (:391-403); hit_t = -(u^ . g) and the normalization of u give v_u (:405-
// 414).  Per slot, summed over the tile's pixels: S = sum v_g, then
// v_x = -M^T S and v_M[k][j] = sum (v_u_k d_j + v_g_k (o_j - x_j)), v_op,
// the colour rows sum v_ch_k w (the input hit channel's row is exactly 0,
// :441-445), the scale rows sum v_b u^ and the normal rows sum v_n w sgn.
// Per pixel, summed over its live slots, the ray gradients v_o = M^T v_g
// and v_d = M^T v_u.  A slot behind a pixel's stop gets nothing from it.
//
// Shape (K6b, rasterize2d_bwd.cu): one CTA per 16x16 tile, one thread per
// pixel, batches of 32 slots staged in shared memory, each thread replaying
// its own pixel forward through csrc/ray3d.cuh so that it decides gate and
// stop as the forward did.  The prefix E runs with the replay; Dtot comes
// from the forward's outputs (the telescoped suffix of :274-277, :359-364).
// For each slot the per-pixel terms are reduced in a fixed order: a shuffle
// tree inside each warp, the warps' partials to shared memory, one pass
// adding the warps in index order, then one pass forming v_x from the sums
// and writing the batch's rows, coalesced.  Every slot belongs to
// one tile and every pixel to one thread, so nothing is accumulated with
// atomics: each thread writes its pixel's six ray gradients once at the end.
// v_M sums v_g_k (o_j - x_j) per pair, where the JAX kernel sums v_g_k o_j
// and subtracts x_j S_k after (:423-428): the same value, without the
// cancellation of two large sums when the ray's origin is far from x.
// Dead warps skip; once every pixel has stopped the CTA leaves, and the rest
// of its span keeps the wrapper's zeros.  The result is bit-identical from
// run to run.
//
// What bounds it on the H100: operations.  Each evaluated pair costs the
// forward's ~70 operations again; a live pair ~120 + 2 D more for its
// gradient terms and one add into each of its F per-slot sums.  The shuffle
// tree (5 shuffle-adds per value and lane) is the kernel's own cost.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray3d.cuh"

namespace {

constexpr int kThreads = gs3d::kTile * gs3d::kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 32;  // staged slots per batch: one live bit each
constexpr unsigned kFullMask = 0xffffffffu;

// Every operation of a pair's gradient chain is rounded alone (no fused
// multiply-add), in the order of the plain version, so that the two give the
// same per-pair terms and, summed serially, the same ray gradients.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// out = a x b
__device__ __forceinline__ void cross(const float* a, const float* b, float* out) {
  out[0] = sub(mul(a[1], b[2]), mul(a[2], b[1]));
  out[1] = sub(mul(a[2], b[0]), mul(a[0], b[2]));
  out[2] = sub(mul(a[0], b[1]), mul(a[1], b[0]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFullMask, v, off);
  return v;  // lane 0 holds the sum
}

template <int D>
__global__ void __launch_bounds__(kThreads)
rasterize_eval3d_bwd_kernel(const float* __restrict__ fields, long long P,
                            const int* __restrict__ bounds, const float* __restrict__ rays,
                            bool hit, bool normals, int tiles_w, int tiles_per_image, int width,
                            int height, const float* __restrict__ v_pix,
                            const float* __restrict__ v_t, const float* __restrict__ pix_out,
                            const float* __restrict__ t_final, float* __restrict__ v_slot,
                            float* __restrict__ v_rays, int* __restrict__ live_counts) {
  constexpr int kTile = gs3d::kTile;
  const int color0 = hit ? gs3d::kRowScale + 3 : gs3d::kRowScale;
  const int normal0 = color0 + D;
  const int F = normal0 + (normals ? 3 : 0);
  const int D_mat = hit ? D - 1 : D;
  const int D_out = D + (normals ? 3 : 0);
  extern __shared__ float smem[];
  float* stage = smem;                              // [F][kBatch]
  float* partial = stage + F * kBatch;              // [kWarps][F][kBatch]
  float* sums = partial + kWarps * F * kBatch;      // [F][kBatch]
  unsigned* live_bits = (unsigned*)(sums + F * kBatch);  // [kWarps]

  const int t = blockIdx.x;
  const int tr = threadIdx.x;
  const int lane = tr & 31;
  const int warp = tr >> 5;

  const int im = t / tiles_per_image;
  const int tl = t - im * tiles_per_image;
  const int ty = tl / tiles_w;
  const int tx = tl - ty * tiles_w;
  const int x = tx * kTile + tr % kTile;
  const int y = ty * kTile + tr / kTile;
  const bool inside = x < width && y < height;
  const long long pix = ((long long)im * height + y) * width + x;

  gs3d::Ray r = {{0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f}};
  float vch[D + 3];
#pragma unroll
  for (int k = 0; k < D + 3; ++k) vch[k] = 0.0f;
  float dtot = 0.0f, vt_term = 0.0f;
  if (inside) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      r.o[k] = rays[pix * 6 + k];
      r.d[k] = rays[pix * 6 + 3 + k];
    }
    const float* vp = v_pix + pix * D_out;
    const float* po = pix_out + pix * D_out;
#pragma unroll
    for (int k = 0; k < D + 3; ++k) {
      if (k < D_out) {
        vch[k] = vp[k];
        dtot = add(dtot, mul(vch[k], po[k]));
      }
    }
    vt_term = mul(v_t[pix], t_final[pix]);
  }
  bool done = !(inside && gs3d::dir_norm2(r) > 1e-12f);
  float T = done ? 0.0f : 1.0f;
  float E = 0.0f;  // prefix sum of w d
  float v_ray[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int n_live = 0;

  const int start = bounds[t];
  const int end = bounds[t + 1];
  const int n_batches = (end - start + kBatch - 1) / kBatch;
  for (int batch = 0; batch < n_batches; ++batch) {
    // also the barrier that frees the shared buffers of the batch before
    if (__syncthreads_count(done) == kThreads) break;
    const int base = start + batch * kBatch;
    const int n = min(kBatch, end - base);
    for (int o = tr; o < F * kBatch; o += kThreads) {
      const int f = o / kBatch;
      const int j = o - f * kBatch;
      if (j < n) stage[o] = fields[f * P + base + j];
    }
    __syncthreads();

    unsigned warp_live = 0;
    for (int j = 0; j < n; ++j) {
      bool live = false;
      // the pair's terms of the per-slot sums: S (v_g), v_M (v_u d + v_g (o - x)),
      // v_op, the colour weight w, the signed normal weight, v_b u^
      float sg[3] = {0.0f, 0.0f, 0.0f};
      float au[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float v_op = 0.0f, w = 0.0f, ws = 0.0f;
      float vbs[3] = {0.0f, 0.0f, 0.0f};
      if (!done) {
        const float* sl = stage + j;
        done = gs3d::composite_ray(r, sl, kBatch, hit, T, [&](const gs3d::Response& s, float next_T) {
          live = true;
          ++n_live;
          w = mul(s.alpha, T);
          float d = 0.0f;
#pragma unroll
          for (int k = 0; k < D; ++k) {
            if (k < D_mat) d = add(d, mul(vch[k], sl[(color0 + k) * kBatch]));
          }
          if (hit) d = add(d, mul(vch[D - 1], s.hd));
          float sgn = 1.0f;
          if (normals) {
            const float* nr = sl + normal0 * kBatch;
            const float nd = gs3d::dot3(nr[0], nr[kBatch], nr[2 * kBatch], r.d[0], r.d[1], r.d[2]);
            sgn = nd > 0.0f ? -1.0f : 1.0f;
#pragma unroll
            for (int k = 0; k < 3; ++k) d = add(d, mul(vch[D + k], mul(sgn, nr[k * kBatch])));
          }
          ws = mul(w, sgn);
          E = add(E, mul(w, d));
          const float ra = __fdiv_rn(1.0f, sub(1.0f, s.alpha));  // alpha <= 0.99
          const float v_alpha = sub(sub(mul(d, T), mul(sub(dtot, E), ra)), mul(vt_term, ra));
          const float v_sigma = s.clamped ? 0.0f : mul(-s.alpha, v_alpha);
          v_op = s.clamped ? 0.0f : mul(s.vis, v_alpha);
          const float vc[3] = {mul(v_sigma, s.c[0]), mul(v_sigma, s.c[1]), mul(v_sigma, s.c[2])};
          // c = u^ x g: v_u^ = g x v_c, v_g = v_c x u^
          float vuh[3], vg[3];
          cross(s.g, vc, vuh);
          cross(vc, s.uh, vg);
          float v_hit = 0.0f;
          if (hit) {
            // hd = hit_t q, q = |s u^|
            const float v_hd = mul(w, vch[D - 1]);
            v_hit = mul(v_hd, s.q);
            const float v_q = mul(v_hd, s.hit_t);
            const float inv_q = __fdiv_rn(1.0f, s.q);
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              const float sk = sl[(gs3d::kRowScale + k) * kBatch];
              const float v_b = mul(mul(v_q, mul(sk, s.uh[k])), inv_q);
              vuh[k] = add(vuh[k], mul(v_b, sk));
              vbs[k] = mul(v_b, s.uh[k]);
            }
          }
          // hit_t = -(u^ . g)
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            vuh[k] = sub(vuh[k], mul(s.g[k], v_hit));
            vg[k] = sub(vg[k], mul(s.uh[k], v_hit));
          }
          // u^ = u / |u|
          const float udotv = gs3d::dot3(s.uh[0], s.uh[1], s.uh[2], vuh[0], vuh[1], vuh[2]);
          float vu[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) vu[k] = mul(s.inv_un, sub(vuh[k], mul(s.uh[k], udotv)));
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            sg[k] = vg[k];
#pragma unroll
            for (int jj = 0; jj < 3; ++jj)
              au[3 * k + jj] = add(mul(vu[k], r.d[jj]),
                                   mul(vg[k], sub(r.o[jj], sl[(gs3d::kRowX + jj) * kBatch])));
          }
          // the pixel's ray gradients: v_o = M^T v_g, v_d = M^T v_u
          const float* m = sl + gs3d::kRowM * kBatch;
#pragma unroll
          for (int jj = 0; jj < 3; ++jj) {
            const float m0 = m[jj * kBatch], m1 = m[(3 + jj) * kBatch], m2 = m[(6 + jj) * kBatch];
            v_ray[jj] = add(v_ray[jj], gs3d::dot3(m0, m1, m2, vg[0], vg[1], vg[2]));
            v_ray[3 + jj] = add(v_ray[3 + jj], gs3d::dot3(m0, m1, m2, vu[0], vu[1], vu[2]));
          }
          T = next_T;
        });
      }
      if (__ballot_sync(kFullMask, live) == 0) continue;
      warp_live |= 1u << j;
      float* out = partial + (size_t)warp * F * kBatch + j;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float v = warp_sum(sg[k]);
        if (lane == 0) out[(gs3d::kRowX + k) * kBatch] = v;
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const float v = warp_sum(au[k]);
        if (lane == 0) out[(gs3d::kRowM + k) * kBatch] = v;
      }
      const float sop = warp_sum(v_op);
      if (lane == 0) out[gs3d::kRowOp * kBatch] = sop;
      if (hit) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float v = warp_sum(vbs[k]);
          if (lane == 0) out[(gs3d::kRowScale + k) * kBatch] = v;
        }
      }
#pragma unroll
      for (int k = 0; k < D; ++k) {
        if (k < D_mat) {
          const float v = warp_sum(vch[k] * w);
          if (lane == 0) out[(color0 + k) * kBatch] = v;
        }
      }
      if (normals) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float v = warp_sum(vch[D + k] * ws);
          if (lane == 0) out[(normal0 + k) * kBatch] = v;
        }
      }
    }
    if (lane == 0) live_bits[warp] = warp_live;
    __syncthreads();

    // the warps' partials, added in warp order, one element a thread
    for (int o = tr; o < F * kBatch; o += kThreads) {
      const int f = o / kBatch;
      const int j = o - f * kBatch;
      float sum = 0.0f;
      if (j < n && !(hit && f == color0 + D - 1)) {
        for (int wi = 0; wi < kWarps; ++wi) {
          if ((live_bits[wi] >> j) & 1u) sum += partial[((size_t)wi * F + f) * kBatch + j];
        }
      }
      sums[o] = sum;
    }
    __syncthreads();
    // v_x = -M^T S from the sums; the rest as summed
    for (int o = tr; o < F * kBatch; o += kThreads) {
      const int f = o / kBatch;
      const int j = o - f * kBatch;
      if (j >= n) continue;
      float v = sums[o];
      if (f < gs3d::kRowM) {
        const float* S = sums + gs3d::kRowX * kBatch + j;
        const float* m = stage + gs3d::kRowM * kBatch + j;
        v = -gs3d::dot3(m[f * kBatch], m[(3 + f) * kBatch], m[(6 + f) * kBatch], S[0],
                        S[kBatch], S[2 * kBatch]);
      }
      v_slot[f * P + base + j] = v;
    }
  }

  if (inside) {
#pragma unroll
    for (int k = 0; k < 6; ++k) v_rays[pix * 6 + k] = v_ray[k];
  }
  if (live_counts != nullptr) {
    const int total = gs3d::cta_count(n_live);
    if (tr == 0) live_counts[t] = total;
  }
}

template <int D>
int launch(const float* fields, long long P, const int* bounds, const float* rays, bool hit,
           bool normals, int tiles_w, int tiles_per_image, int width, int height, int n_tiles,
           const float* v_pix, const float* v_t, const float* pix_out, const float* t_final,
           float* v_slot, float* v_rays, int* live_counts, cudaStream_t stream) {
  const int F = gs3d::kRowScale + (hit ? 3 : 0) + D + (normals ? 3 : 0);
  const size_t smem = sizeof(float) * F * kBatch * (2 + kWarps) + sizeof(unsigned) * kWarps;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rasterize_eval3d_bwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rasterize_eval3d_bwd_kernel<D><<<n_tiles, kThreads, smem, stream>>>(
      fields, P, bounds, rays, hit, normals, tiles_w, tiles_per_image, width, height, v_pix,
      v_t, pix_out, t_final, v_slot, v_rays, live_counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// fields [F, P] f32 sorted slot rows, bounds [n_tiles+1] i32 tile spans,
// rays [I, H, W, 6] f32, v_pix and pix_out [I, H, W, D + 3*normals] f32,
// v_t and t_final [I, H, W] f32 -> v_slot [F, P] f32 (zeroed by the caller;
// slots no CTA reaches stay zero), v_rays [I, H, W, 6] f32 (every pixel
// written) and, unless null, live_counts [n_tiles] i32: the live (pixel,
// slot) pairs of each tile.  F = 13 + 3*hit + D + 3*normals; tile 16; D in
// [1, 32].
int gs_rasterize_eval3d_bwd(const float* fields, long long P, const int* bounds,
                            const float* rays, int D, int hit, int normals, int tiles_w,
                            int tiles_per_image, int width, int height, int n_tiles,
                            const float* v_pix, const float* v_t, const float* pix_out,
                            const float* t_final, float* v_slot, float* v_rays,
                            int* live_counts, cudaStream_t stream) {
  if (n_tiles == 0) return (int)cudaGetLastError();
  const bool h = hit != 0, nr = normals != 0;
  switch (D) {
#define GS_CASE(d) \
  case d:          \
    return launch<d>(fields, P, bounds, rays, h, nr, tiles_w, tiles_per_image, width, height, n_tiles, v_pix, v_t, pix_out, t_final, v_slot, v_rays, live_counts, stream);
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
