// The per-(pixel, slot) ray response and compositing decision shared by the
// eval3d forward composite (rasterize_eval3d_fwd.cu, K7a) and its backward
// (rasterize_eval3d_bwd.cu, K7b).
//
// The backward replays the forward front to back and must decide "gated",
// "stops the pixel" and "contributes" exactly as the forward did: the gate
// and the stop are discontinuous, so one ulp would give a pair a whole
// gradient in one kernel and none in the other.  Both kernels call this one
// function, every operation in it is an explicitly rounded intrinsic (no
// fused multiply-add, IEEE division and square root), in the order of the
// plain PyTorch version (ops/rasterize_eval3d_kernel.py:_ray_batch), which
// the forward equals bit for bit.
//
// Numeric contract (the JAX oracle gsplat_tpu/ops/rasterize_eval3d_ref.py
// and rasterize_eval3d_pallas.py:_eval3d_alpha :68-119), with the slot's
// world-to-whitened transform M = diag(1/s) R^T (row-major), its centre x
// and the pixel's ray (o, d):
//   u = M d,  g = M o - M x,  u^ = u / sqrt(max(|u|^2, 1e-24)),
//   c = u^ x g,  gray = |c|^2,  hit_t = -(u^ . g),
//   alpha = min(0.99, op * exp(-0.5 gray)),
// kept only if hit_t >= 0 and alpha >= 1/255; a pixel stops for good at the
// first gaussian that would take T to <= 1e-4, which is excluded (the
// oracle's rule).  The hit distance is hit_t * sqrt(max(|s * u^|^2, 1e-24)).

#pragma once

#include <cuda_runtime.h>

namespace gs3d {

constexpr float kAlphaThreshold = (float)(1.0 / 255.0);
constexpr float kMaxAlpha = 0.99f;
constexpr float kTransmittanceThreshold = 1e-4f;
constexpr int kTile = 16;  // the eval3d path's only tile size (rasterize_eval3d.py:199)

// Field rows of a slot: x (3), M row-major (9), opacity, [scale (3) with the
// hit distance], D colour channels (the hit channel last with it), [3 normal
// components].
enum { kRowX = 0, kRowM = 3, kRowOp = 12, kRowScale = 13 };

struct Ray {
  float o[3], d[3];
};

struct Response {
  float u[3], g[3];  // M d, M o - M x
  float uh[3];       // u normalized
  float c[3];        // u^ x g
  float inv_un;      // 1 / |u|
  float hit_t;       // -(u^ . g)
  float vis;         // exp(-0.5 gray)
  float alpha;       // min(0.99, op * vis)
  bool clamped;      // op * vis reached the 0.99 clamp
  float q, hd;       // |s * u^| and the hit distance (with the hit channel only)
};

// |d|^2 of the pixel's ray direction: a ray with |d|^2 <= 1e-12 starts at
// T = 0 and renders nothing (rasterize_eval3d_pallas.py:145-150).
__device__ __forceinline__ float dir_norm2(const Ray& r) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r.d[0], r.d[0]), __fmul_rn(r.d[1], r.d[1])),
                   __fmul_rn(r.d[2], r.d[2]));
}

// a0*b0 + a1*b1 + a2*b2, each operation rounded alone, left to right
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0, float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

// Evaluate the slot whose field f is `field(f)` on the ray `r` with
// transmittance T.  Returns true if the pair would take T to <= 1e-4: the
// pixel stops for good and this gaussian is excluded.  Otherwise returns
// false, after calling `on_live(response, next_T)` if the pair contributes
// and nothing if it is gated (the shape of surfel.cuh).  `field` is called
// with constants once unrolled, so the fields may sit in shared memory or in
// the caller's registers: the operations are the same either way.
template <class Field, class OnLive>
__device__ __forceinline__ bool composite_ray_fields(const Ray& r, Field&& field, bool hit,
                                                     float T, OnLive&& on_live) {
  Response s;
  const float x0 = field(kRowX + 0);
  const float x1 = field(kRowX + 1);
  const float x2 = field(kRowX + 2);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float m0 = field(kRowM + 3 * k + 0);
    const float m1 = field(kRowM + 3 * k + 1);
    const float m2 = field(kRowM + 3 * k + 2);
    s.u[k] = dot3(m0, m1, m2, r.d[0], r.d[1], r.d[2]);
    s.g[k] = __fsub_rn(dot3(m0, m1, m2, r.o[0], r.o[1], r.o[2]), dot3(m0, m1, m2, x0, x1, x2));
  }
  const float un2 = dot3(s.u[0], s.u[1], s.u[2], s.u[0], s.u[1], s.u[2]);
  s.inv_un = __fdiv_rn(1.0f, __fsqrt_rn(un2 < 1e-24f ? 1e-24f : un2));
#pragma unroll
  for (int k = 0; k < 3; ++k) s.uh[k] = __fmul_rn(s.u[k], s.inv_un);
  s.c[0] = __fsub_rn(__fmul_rn(s.uh[1], s.g[2]), __fmul_rn(s.uh[2], s.g[1]));
  s.c[1] = __fsub_rn(__fmul_rn(s.uh[2], s.g[0]), __fmul_rn(s.uh[0], s.g[2]));
  s.c[2] = __fsub_rn(__fmul_rn(s.uh[0], s.g[1]), __fmul_rn(s.uh[1], s.g[0]));
  const float gray = dot3(s.c[0], s.c[1], s.c[2], s.c[0], s.c[1], s.c[2]);
  s.hit_t = -dot3(s.uh[0], s.uh[1], s.uh[2], s.g[0], s.g[1], s.g[2]);
  s.vis = expf(__fmul_rn(-0.5f, gray));
  const float raw = __fmul_rn(field(kRowOp), s.vis);
  s.clamped = !(raw < kMaxAlpha);
  s.alpha = raw > kMaxAlpha ? kMaxAlpha : raw;  // a NaN stays NaN and is gated
  if (!(s.hit_t >= 0.0f)) return false;              // behind the ray's origin: gated
  if (!(s.alpha >= kAlphaThreshold)) return false;   // gated
  const float next_T = __fmul_rn(T, __fsub_rn(1.0f, s.alpha));
  if (next_T <= kTransmittanceThreshold) return true;
  s.q = 0.0f;
  s.hd = 0.0f;
  if (hit) {
    const float b0 = __fmul_rn(field(kRowScale + 0), s.uh[0]);
    const float b1 = __fmul_rn(field(kRowScale + 1), s.uh[1]);
    const float b2 = __fmul_rn(field(kRowScale + 2), s.uh[2]);
    const float bb = dot3(b0, b1, b2, b0, b1, b2);
    s.q = __fsqrt_rn(bb < 1e-24f ? 1e-24f : bb);
    s.hd = __fmul_rn(s.hit_t, s.q);
  }
  on_live(s, next_T);
  return false;
}

// The same, for the slot whose field f sits at slot[f * stride].
template <class OnLive>
__device__ __forceinline__ bool composite_ray(const Ray& r, const float* slot, int stride,
                                              bool hit, float T, OnLive&& on_live) {
  return composite_ray_fields(
      r, [&](int f) { return slot[f * stride]; }, hit, T, static_cast<OnLive&&>(on_live));
}

// The sum over a CTA of a per-thread count, through __syncthreads_count,
// bit by bit; every thread of the CTA must call it.
__device__ __forceinline__ int cta_count(int n) {
  int total = 0;
  for (int bit = 0; bit < 31; ++bit) {
    total += __syncthreads_count((n >> bit) & 1) << bit;
    if (__syncthreads_or(n >> (bit + 1)) == 0) break;
  }
  return total;
}

}  // namespace gs3d
