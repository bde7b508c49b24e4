// The per-(pixel, slot) compositing decision shared by the forward composite
// (rasterize_fwd.cu, K1) and its backward (rasterize_bwd.cu, K2).
//
// The backward replays the forward front to back and must decide "gated",
// "stops the pixel" and "contributes" exactly as the forward did: the alpha
// gate and the stop rule are discontinuous, so one ulp of sigma, alpha or T
// would give a pair a whole gradient in one kernel and none in the other.
// Both kernels therefore call this one function, and every operation in it
// that feeds a decision is an explicitly rounded intrinsic (no fused
// multiply-add, whatever the compiler's contraction setting).
//
// Numeric contract (the JAX oracle gsplat_tpu/ops/rasterize_ref.py:32-47 and
// upstream gsplat): sigma = 0.5*(a*dx^2 + c*dy^2) + b*dx*dy with
// dx = px - mx; sigma >= -2e-3 is clamped to >= 0 (the JAX gate,
// rasterize_pallas.py:94, :316); alpha = min(0.99, op*exp(-sigma)), kept only
// if sigma >= 0 and alpha >= 1/255; a pixel stops for good at the first
// gaussian that would take T to <= 1e-4, and that gaussian is excluded.

#pragma once

#include <cuda_runtime.h>

namespace gs {

constexpr float kAlphaThreshold = (float)(1.0 / 255.0);
constexpr float kMaxAlpha = 0.99f;
constexpr float kTransmittanceThreshold = 1e-4f;
constexpr float kSigmaEpsNeg = -2e-3f;

struct Pair {
  float dx, dy;   // pixel centre minus the gaussian's mean
  float vis;      // exp(-sigma)
  float alpha;    // min(0.99, op * vis)
  bool clamped;   // op * vis reached the 0.99 clamp
};

// Evaluate one gaussian at one pixel whose transmittance so far is T.
// Returns true if the pair would take T to <= 1e-4: the pixel stops for good
// and this gaussian is excluded.  Otherwise returns false, after calling
// `on_live(pair, next_T)` if the pair contributes and nothing if it is gated.
// The live outcome is a callback and the stop a plain bool that the caller
// turns into `break`: inlined, each becomes a direct branch of the caller's
// loop.  (A returned three-way state is materialised in a register and tested
// again behind extra convergence barriers, and a stop callback that sets a
// flag for the loop condition costs 7 to 15% of K1's time.)
template <class OnLive>
__device__ __forceinline__ bool composite_pair(float px, float py, float mx,
                                               float my, float a, float b,
                                               float c, float op, float T,
                                               OnLive&& on_live) {
  Pair p;
  p.dx = __fsub_rn(px, mx);
  p.dy = __fsub_rn(py, my);
  const float sxx = __fmul_rn(__fmul_rn(a, p.dx), p.dx);
  const float syy = __fmul_rn(__fmul_rn(c, p.dy), p.dy);
  const float sxy = __fmul_rn(__fmul_rn(b, p.dx), p.dy);
  float sigma = __fadd_rn(__fmul_rn(0.5f, __fadd_rn(sxx, syy)), sxy);
  if (sigma >= kSigmaEpsNeg) sigma = fmaxf(sigma, 0.0f);
  if (!(sigma >= 0.0f)) return false;  // negative or NaN: gated
  p.vis = expf(-sigma);
  const float raw = __fmul_rn(op, p.vis);
  p.clamped = !(raw < kMaxAlpha);
  p.alpha = fminf(kMaxAlpha, raw);
  if (p.alpha < kAlphaThreshold) return false;  // gated
  const float next_T = __fmul_rn(T, __fsub_rn(1.0f, p.alpha));
  if (next_T <= kTransmittanceThreshold) return true;
  on_live(p, next_T);
  return false;
}

}  // namespace gs
