// The per-(pixel, slot) ray response and compositing decision shared by the
// eval3d forward composite (rasterize_eval3d_fwd.cu, K7a) and its backward
// (rasterize_eval3d_bwd.cu, K7b).
//
// The backward replays the forward front to back and must decide "gated",
// "stops the pixel" and "contributes" exactly as the forward did: the gate
// and the stop are discontinuous, so one ulp would give a pair a whole
// gradient in one kernel and none in the other.  Both kernels call the same
// functions (ray_respond, ray_decide), every operation in them an
// explicitly rounded intrinsic (no fused multiply-add, IEEE division and
// square root), in the order of the plain PyTorch version
// (ops/rasterize_eval3d_kernel.py:_ray_batch), which the forward equals bit
// for bit.
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
//
// Hoisting (K7a).  g = M o - M x is computed as rn(dot3(M_k, o) -
// dot3(M_k, x)): the forward stages dot3(M_k, x) once per slot, and where
// every active ray of a tile has the same origin bit for bit (a global
// shutter, a lidar that does not move) the whole of g once per slot.  The
// same operations on the same operands give the same bits.
//
// Early reject (K7a).  Most evaluated pairs are gated (82% of the 1.85 G
// pairs of the 3DGUT view at 3840x2160), and the exact path spends a square
// root, a division and an exp to say so.  A warp composites one 8x4 block of
// a tile's pixels at a time, so where the forward stages a slot it also
// computes, once for the tile, a mask of the 8 blocks in which the exact
// path certainly gates every active pixel (ray_block_gated), and a pair in a
// masked block is gated without the rest of the function.  Every other pair
// takes the exact path, so every decision keeps its bits.  The mask reads
// one gate term per slot (ray_gate, as surfel.cuh:surfel_gate):
//   g = 2 (theta + delta)(1 + s),  theta = ln(255 op),  delta = 2^-6,  s = 2^-10,
// -inf for a slot with op < (1 - 2^-16)/255 (gated at every pixel: every
// block masked), +inf for a slot with a NaN or an infinity among x, M and
// op (no block masked).
//
// 1. A pair whose exact gray > g (1 - 2^-20) is gated.  The exact path's
//    sigma = rn(-0.5 gray) is exactly -gray/2, so surfel.cuh's steps 2 to 4
//    hold word for word with sigma = gray/2: sigma > (theta_c + delta)(1 +
//    2^-11) after g's roundings (theta_c = logf(rn(255 op)) >= theta - 2^-16;
//    CUDA's documented bounds: logf within 1 ulp, expf within 2), vis =
//    expf(-sigma) <= exp(-sigma)(1 + 2^-22), raw = rn(op vis) < (1 -
//    2^-7)/255 < kAlphaThreshold.  Below the cut gray >= 0 (or NaN, gated),
//    vis <= 1 + 2^-22 and raw < kAlphaThreshold.
// 2. The block's bundle (ray_block_bundle, once per CTA), over its active
//    rays i (inside the image, |d|^2 > 1e-12) at lane offsets (ox_i, oy_i)
//    from their centroid: the least-squares affine model d_i = dc + ox_i ax +
//    oy_i ay + r_i, |r_i| <= fit (the largest computed residual times 1 +
//    2^-16, plus 2^-20 max |d_i| for the model's own roundings), |ox_i| <=
//    ex, |oy_i| <= ey; |o_i - oc| <= ro with oc the first active ray's origin
//    (ro = 0 where every origin equals oc bit for bit).  Any ray works: a
//    distorted pinhole's rays, which do not form a pyramid, only leave a
//    larger fit.  A block with a NaN or an infinity among its active rays, or
//    with a bound that is not finite, is never masked.
// 3. The bound, in exact arithmetic on the float operands.  At pixel i the
//    ray's line is whitened to {g_i + t u_i}, u_i = M d_i, g_i = M(o_i - x):
//    dist_i = |u_i x g_i| / |u_i| is the whitened distance of the centre
//    from it (the exact path's sqrt(gray)) and hit_i = -(u_i . g_i) / |u_i|
//    (its hit_t).  With g = M(oc - x), uc = M dc, ua = M ax, ub = M ay and
//    sigma >= sigma_max(M) (Gershgorin on M M^T, ray_sigma_max):
//    - u_i x g = uc x g + ox_i (ua x g) + oy_i (ub x g) + (M r_i) x g, each
//      component within ex |ua x g| + ey |ub x g| + sigma fit |g| of uc x g's:
//      |u_i x g| >= N- = |(max(|(uc x g)_k| - that, 0))_k|;
//    - U- <= |u_i| <= U+, U+- = |uc| +- (ex |ua| + ey |ub| + sigma fit);
//    - |u_i x g_i - u_i x g| <= |u_i| sigma ro;
//    so dist_i >= N-/U+ - sigma ro, and u_i . g_i >= (uc . g) - (ex |ua . g|
//    + ey |ub . g| + sigma fit |g|) - U+ sigma ro, whose being above zero
//    puts hit_i below zero.
// 4. Roundings (u = 2^-24).  The exact path's c and hit_t are within
//    e_i = u [(12 k_i + 8) G + 6 |M|_F (|o_i| + |x|)] of their exact values,
//    k_i = |M|_F |d_i| / |u_i| <= sqrt(3) sigma D+ / U-, G = |g| + sigma ro
//    >= |g_i|, D+ = |dc| + ex |ax| + ey |ay| + fit >= |d_i|: g's two dot
//    products and its difference err by 5u |M|_F (|o| + |x|), u by 3u |M|_F
//    |d|, so u^ by 2 (3u |M|_F |d|) / |u| + 4u and c by that times G, plus 3u
//    G for the cross product.  The mask's own arithmetic errs by no more.
//    The mask takes env = 2^-16 [(sigma D+ / U- + 1) G + sigma (|oc| + ro +
//    |x|)] + 2^-100, six times the sum of the two, and asks
//      U- >= 2^-16 (|u_i|^2 stays far above the exact path's 1e-24 clamp), and
//      lb = N-/U+ - sigma ro - env > 0 with lb^2 > g (1 + s): the exact
//        gray > g (1 - 2^-20) at every active pixel of the block (1.), or
//      (u . g)- > U+ env: the exact hit_t < 0 at each.
// A NaN fails every comparison; an overflow in the mask gives an infinite
// or NaN env or U-, which masks nothing; an overflow in the exact path gives
// NaN or an infinite gray, which it gates.  A pair near the margin takes the
// exact path: it costs only the time every pair took before the reject.

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

// The reject's constants (see the top of this file).
constexpr float kGateMargin = 0x1p-6f;         // delta
constexpr float kGateSlack = 1.0f + 0x1p-10f;  // 1 + s
constexpr float kOpDead = kAlphaThreshold * (1.0f - 0x1p-16f);  // gated at every pixel
constexpr float kFloatMax = 3.40282347e38f;
constexpr float kUnMin = 0x1p-16f;        // the least U- the mask reads
constexpr float kEnvelope = 0x1p-16f;     // env's factor
constexpr float kEnvelopeFloor = 0x1p-100f;
constexpr float kNormSlack = 1.0f + 0x1p-16f;   // a computed norm's inflation
constexpr float kFitFloor = 0x1p-20f;           // the affine model's roundings, of max |d|
constexpr float kSigmaSlack = 1.0f + 0x1p-19f;  // the Gershgorin bound's roundings
constexpr int kBlocks = 8;  // the 8x4 pixel blocks of a tile: two across, four down

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

// The exact path's response of the slot with M's rows m[9] (row-major),
// g = M o - M x and opacity op on the ray r, every operation rounded alone
// in the plain version's order; returns whether the pair passes the gate
// (hit_t >= 0 and alpha >= 1/255).  s.q and s.hd are left to ray_decide.
__device__ __forceinline__ bool ray_respond(const Ray& r, const float* m, const float* g,
                                            float op, Response& s) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.u[k] = dot3(m[3 * k], m[3 * k + 1], m[3 * k + 2], r.d[0], r.d[1], r.d[2]);
    s.g[k] = g[k];
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
  const float raw = __fmul_rn(op, s.vis);
  s.clamped = !(raw < kMaxAlpha);
  s.alpha = raw > kMaxAlpha ? kMaxAlpha : raw;  // a NaN stays NaN and is gated
  return (s.hit_t >= 0.0f) && (s.alpha >= kAlphaThreshold);
}

// The decision after ray_respond, at transmittance T: returns true if the
// pair would take T to <= 1e-4 (the pixel stops for good and this gaussian
// is excluded); otherwise false, after calling `on_live(response, next_T)`
// if the pair passed the gate, with the hit distance from `scale(k)` (the
// slot's scale rows) when `hit`.
template <class Scale, class OnLive>
__device__ __forceinline__ bool ray_decide(Response& s, bool passes, Scale&& scale, bool hit,
                                           float T, OnLive&& on_live) {
  if (!passes) return false;  // gated
  const float next_T = __fmul_rn(T, __fsub_rn(1.0f, s.alpha));
  if (next_T <= kTransmittanceThreshold) return true;
  s.q = 0.0f;
  s.hd = 0.0f;
  if (hit) {
    const float b0 = __fmul_rn(scale(0), s.uh[0]);
    const float b1 = __fmul_rn(scale(1), s.uh[1]);
    const float b2 = __fmul_rn(scale(2), s.uh[2]);
    const float bb = dot3(b0, b1, b2, b0, b1, b2);
    s.q = __fsqrt_rn(bb < 1e-24f ? 1e-24f : bb);
    s.hd = __fmul_rn(s.hit_t, s.q);
  }
  on_live(static_cast<const Response&>(s), next_T);
  return false;
}

// Evaluate the slot whose field f is `field(f)` on the ray `r` with
// transmittance T by the exact path: g = M o - M x per pair, then
// ray_respond and ray_decide.  `field` is called with constants once
// unrolled, so the fields may sit in shared memory or in the caller's
// registers: the operations are the same either way.
template <class Field, class OnLive>
__device__ __forceinline__ bool composite_ray_fields(const Ray& r, Field&& field, bool hit,
                                                     float T, OnLive&& on_live) {
  float m[9], g[3];
  const float x0 = field(kRowX + 0);
  const float x1 = field(kRowX + 1);
  const float x2 = field(kRowX + 2);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
#pragma unroll
    for (int i = 0; i < 3; ++i) m[3 * k + i] = field(kRowM + 3 * k + i);
    g[k] = __fsub_rn(dot3(m[3 * k], m[3 * k + 1], m[3 * k + 2], r.o[0], r.o[1], r.o[2]),
                     dot3(m[3 * k], m[3 * k + 1], m[3 * k + 2], x0, x1, x2));
  }
  Response s;
  const bool passes = ray_respond(r, m, g, field(kRowOp), s);
  return ray_decide(s, passes, [&](int k) { return field(kRowScale + k); }, hit, T,
                    static_cast<OnLive&&>(on_live));
}

// The slot's gate term g from its x, M (row-major) and opacity.
__device__ __forceinline__ float ray_gate(const float* x, const float* m, float op) {
  bool finite = fabsf(op) <= kFloatMax;
#pragma unroll
  for (int k = 0; k < 3; ++k) finite = finite && fabsf(x[k]) <= kFloatMax;
#pragma unroll
  for (int k = 0; k < 9; ++k) finite = finite && fabsf(m[k]) <= kFloatMax;
  if (!finite) return INFINITY;        // the exact path decides every pair
  if (op < kOpDead) return -INFINITY;  // gated at every pixel
  const float theta = logf(__fmul_rn(255.0f, op));
  return __fmul_rn(__fmul_rn(2.0f, __fadd_rn(theta, kGateMargin)), kGateSlack);
}

__device__ __forceinline__ float norm3(float a0, float a1, float a2) {
  return sqrtf(a0 * a0 + a1 * a1 + a2 * a2);
}

// An upper bound on M's largest singular value: Gershgorin on M M^T.
__device__ __forceinline__ float ray_sigma_max(const float* m) {
  float gram[3][3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int k = 0; k < 3; ++k)
      gram[j][k] = m[3 * j] * m[3 * k] + m[3 * j + 1] * m[3 * k + 1] + m[3 * j + 2] * m[3 * k + 2];
  float lam = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    lam = fmaxf(lam, gram[k][k] + fabsf(gram[k][(k + 1) % 3]) + fabsf(gram[k][(k + 2) % 3]));
  return sqrtf(lam) * kSigmaSlack;
}

// A block's bundle of rays (step 2 at the top of this file).
struct RayBundle {
  float dc[3], ax[3], ay[3];
  float ex, ey, fit, d_hi;  // d_hi = D+
  float oc[3], ro, on;      // on = |oc|
  int usable;
};

__device__ __forceinline__ float warp_sum(float v) {  // lane 0's sum, given to every lane
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return __shfl_sync(0xffffffffu, v, 0);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The bundle of the block whose pixel (lane & 7, lane >> 3) is this lane's,
// with ray r, active or not; every lane of the warp calls it, lane 0 writes
// *out.
__device__ __forceinline__ void ray_block_bundle(bool active, const Ray& r, int lane,
                                                 RayBundle* out) {
  const unsigned act = __ballot_sync(0xffffffffu, active);
  const int n = __popc(act);
  const int lx = lane & 7, ly = lane >> 3;
  const float nf = n > 0 ? (float)n : 1.0f;
  const float mx = (float)__reduce_add_sync(0xffffffffu, active ? lx : 0) / nf;
  const float my = (float)__reduce_add_sync(0xffffffffu, active ? ly : 0) / nf;
  const float ox = active ? (float)lx - mx : 0.0f;
  const float oy = active ? (float)ly - my : 0.0f;
  const float sxx = fmaxf(warp_sum(ox * ox), 1.0f);
  const float syy = fmaxf(warp_sum(oy * oy), 1.0f);
  float dc[3], ax[3], ay[3], oc[3];
  const int first = n > 0 ? __ffs(act) - 1 : 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float dk = active ? r.d[k] : 0.0f;
    dc[k] = warp_sum(dk) / nf;
    ax[k] = warp_sum(ox * dk) / sxx;
    ay[k] = warp_sum(oy * dk) / syy;
    oc[k] = __shfl_sync(0xffffffffu, r.o[k], first);
  }
  float res = 0.0f, dev_o = 0.0f, dn = 0.0f;
  bool ok = true;
  if (active) {
    float e[3], q[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      e[k] = r.d[k] - (dc[k] + ox * ax[k] + oy * ay[k]);
      q[k] = r.o[k] - oc[k];
      ok = ok && fabsf(r.o[k]) <= kFloatMax && fabsf(r.d[k]) <= kFloatMax;
    }
    res = norm3(e[0], e[1], e[2]);
    dev_o = norm3(q[0], q[1], q[2]);
    dn = norm3(r.d[0], r.d[1], r.d[2]);
    ok = ok && res <= kFloatMax && dev_o <= kFloatMax;
  }
  const bool all_ok = __all_sync(0xffffffffu, ok);
  res = warp_max(res);
  dev_o = warp_max(dev_o);
  dn = warp_max(dn);
  const float ex = warp_max(fabsf(ox)), ey = warp_max(fabsf(oy));
  if (lane == 0) {
    RayBundle b;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      b.dc[k] = dc[k];
      b.ax[k] = ax[k];
      b.ay[k] = ay[k];
      b.oc[k] = oc[k];
    }
    b.ex = ex;
    b.ey = ey;
    b.fit = res * kNormSlack + kFitFloor * dn;
    b.ro = dev_o * kNormSlack;
    b.on = norm3(oc[0], oc[1], oc[2]);
    b.d_hi = norm3(dc[0], dc[1], dc[2]) + ex * norm3(ax[0], ax[1], ax[2]) +
             ey * norm3(ay[0], ay[1], ay[2]) + b.fit;
    b.usable = n > 0 && all_ok && b.fit <= kFloatMax && b.ro <= kFloatMax && b.d_hi <= kFloatMax;
    *out = b;
  }
}

// Whether the exact path certainly gates the slot (M's rows m, g = M(oc - x)
// for the bundle's oc, |x|, sigma = ray_sigma_max(m), gate = ray_gate(...))
// at every active pixel of the block with bundle b (step 3 and 4 at the top
// of this file).
__device__ __forceinline__ bool ray_block_gated(const float* m, const float* g, float x_norm,
                                                float sigma, float gate, const RayBundle& b) {
  if (gate == -INFINITY) return true;
  if (!b.usable || !(gate < INFINITY)) return false;
  float uc[3], ua[3], ub[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    uc[k] = m[3 * k] * b.dc[0] + m[3 * k + 1] * b.dc[1] + m[3 * k + 2] * b.dc[2];
    ua[k] = m[3 * k] * b.ax[0] + m[3 * k + 1] * b.ax[1] + m[3 * k + 2] * b.ax[2];
    ub[k] = m[3 * k] * b.ay[0] + m[3 * k + 1] * b.ay[1] + m[3 * k + 2] * b.ay[2];
  }
  const float gn = norm3(g[0], g[1], g[2]);
  const float sr = sigma * b.fit;
  float lo[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int k1 = (k + 1) % 3, k2 = (k + 2) % 3;
    const float nc = uc[k1] * g[k2] - uc[k2] * g[k1];
    const float na = ua[k1] * g[k2] - ua[k2] * g[k1];
    const float nb = ub[k1] * g[k2] - ub[k2] * g[k1];
    lo[k] = fmaxf(fabsf(nc) - ((b.ex * fabsf(na) + b.ey * fabsf(nb)) + sr * gn), 0.0f);
  }
  const float n_lo = norm3(lo[0], lo[1], lo[2]);
  const float spread =
      b.ex * norm3(ua[0], ua[1], ua[2]) + b.ey * norm3(ub[0], ub[1], ub[2]) + sr;
  const float ucn = norm3(uc[0], uc[1], uc[2]);
  const float u_hi = ucn + spread, u_lo = ucn - spread;
  if (!(u_lo >= kUnMin)) return false;
  const float gm = gn + sigma * b.ro;
  const float env = kEnvelope * ((sigma * b.d_hi / u_lo + 1.0f) * gm +
                                 sigma * (b.on + b.ro + x_norm)) + kEnvelopeFloor;
  const float far = sigma * b.ro + env;
  const float lb = n_lo / u_hi - far;
  const float hc = uc[0] * g[0] + uc[1] * g[1] + uc[2] * g[2];
  const float ha = ua[0] * g[0] + ua[1] * g[1] + ua[2] * g[2];
  const float hb = ub[0] * g[0] + ub[1] * g[1] + ub[2] * g[2];
  const float h_lo = hc - ((b.ex * fabsf(ha) + b.ey * fabsf(hb)) + sr * gn) - u_hi * far;
  return (h_lo > 0.0f) || ((lb > 0.0f) && (lb * lb > gate * kGateSlack));
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
