// The per-(pixel, slot) surfel response and compositing decision shared by
// the 2DGS forward composite (rasterize2d_fwd.cu, K6a) and its backward
// (rasterize2d_bwd.cu, K6b).
//
// The backward replays the forward front to back and must decide "gated",
// "stops the pixel" and "contributes" exactly as the forward did: the alpha
// gate and the stop rule are discontinuous, so one ulp would give a pair a
// whole gradient in one kernel and none in the other.  Both kernels call
// this one function, and every operation in it that feeds a decision is an
// explicitly rounded intrinsic (no fused multiply-add, IEEE division), in
// the order of the plain PyTorch version (ops/rasterize2d_kernel.py), which
// the forward equals bit for bit.
//
// Numeric contract (the JAX oracle gsplat_tpu/ops/rasterize2d_ref.py:85-112
// and rasterize2d_pallas.py:57-89): with the slot's ray transform rows
// u, v, w and the pixel centre (px, py),
//   h_u = px*w - u,  h_v = py*w - v,  c = h_u x h_v,
//   sigma3 = (c_x/c_z)^2 + (c_y/c_z)^2,  sigma2 = 2*|mean - pix|^2,
//   sigma = 0.5 * (sigma2 < sigma3 ? sigma2 : sigma3),
//   alpha = min(0.99, op*exp(-sigma)),
// kept only if c_z != 0, sigma >= 0 and alpha >= 1/255; a pixel stops for
// good at the first surfel that would take T to <= 1e-4, which is excluded.

#pragma once

#include <cuda_runtime.h>

namespace gs2d {

constexpr float kAlphaThreshold = (float)(1.0 / 255.0);
constexpr float kMaxAlpha = 0.99f;
constexpr float kTransmittanceThreshold = 1e-4f;
constexpr int kTile = 16;  // the 2DGS path's only tile size (rasterize2d.py:178)

// Field rows of a slot: x, y, u (3), v (3), w (3), opacity, D colour
// channels (depth last), 3 normal components.
enum { kRowX = 0, kRowY = 1, kRowU = 2, kRowV = 5, kRowW = 8, kRowOp = 11, kRowColor = 12 };

struct Surfel {
  float hu[3], hv[3];  // h_u, h_v
  float cx, cy, cz;    // h_u x h_v
  float sigma3;        // the 3D response (c_x^2 + c_y^2) / c_z^2
  float dx, dy;        // mean minus pixel centre
  bool use2d;          // the 2D screen filter is the smaller response
  float vis;           // exp(-sigma)
  float alpha;         // min(0.99, op * vis)
  bool clamped;        // op * vis reached the 0.99 clamp
};

// Evaluate the slot whose field f sits at slot[f * stride] at the pixel
// (px, py) with transmittance T.  Returns true if the pair would take T to
// <= 1e-4: the pixel stops for good and this surfel is excluded.  Otherwise
// returns false, after calling `on_live(surfel, next_T)` if the pair
// contributes and nothing if it is gated (the shape of composite.cuh).
template <class OnLive>
__device__ __forceinline__ bool composite_surfel(float px, float py, const float* slot,
                                                 int stride, float T, OnLive&& on_live) {
  Surfel s;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float w = slot[(kRowW + k) * stride];
    s.hu[k] = __fsub_rn(__fmul_rn(px, w), slot[(kRowU + k) * stride]);
    s.hv[k] = __fsub_rn(__fmul_rn(py, w), slot[(kRowV + k) * stride]);
  }
  s.cx = __fsub_rn(__fmul_rn(s.hu[1], s.hv[2]), __fmul_rn(s.hu[2], s.hv[1]));
  s.cy = __fsub_rn(__fmul_rn(s.hu[2], s.hv[0]), __fmul_rn(s.hu[0], s.hv[2]));
  s.cz = __fsub_rn(__fmul_rn(s.hu[0], s.hv[1]), __fmul_rn(s.hu[1], s.hv[0]));
  if (!(s.cz != 0.0f)) return false;  // gated
  const float su = __fdiv_rn(s.cx, s.cz);
  const float sv = __fdiv_rn(s.cy, s.cz);
  s.sigma3 = __fadd_rn(__fmul_rn(su, su), __fmul_rn(sv, sv));
  s.dx = __fsub_rn(slot[kRowX * stride], px);
  s.dy = __fsub_rn(slot[kRowY * stride], py);
  const float sigma2 =
      __fmul_rn(2.0f, __fadd_rn(__fmul_rn(s.dx, s.dx), __fmul_rn(s.dy, s.dy)));
  s.use2d = sigma2 < s.sigma3;
  const float sigma = __fmul_rn(0.5f, s.use2d ? sigma2 : s.sigma3);
  if (!(sigma >= 0.0f)) return false;  // NaN: gated
  s.vis = expf(-sigma);
  const float raw = __fmul_rn(slot[kRowOp * stride], s.vis);
  s.clamped = !(raw < kMaxAlpha);
  s.alpha = raw > kMaxAlpha ? kMaxAlpha : raw;  // a NaN stays NaN and is gated
  if (!(s.alpha >= kAlphaThreshold)) return false;  // gated
  const float next_T = __fmul_rn(T, __fsub_rn(1.0f, s.alpha));
  if (next_T <= kTransmittanceThreshold) return true;
  on_live(s, next_T);
  return false;
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

}  // namespace gs2d
