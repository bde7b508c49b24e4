// The per-row arithmetic of the projection and its SH colours, shared by the
// projection pass (projection_fwd.cu), which both routes of a pinhole render
// take forward, and the training route's backward (projection_bwd.cu), which
// replays it.
//
// Numeric contract: the plain PyTorch route, operation for operation, as
// PyTorch runs it on the card (ops/projection_kernel.py:sanitize, then
// ops/math.py:normalize and quat_to_rotmat, sym_mmT, and
// ops/projection.py:_world_to_cam, _persp_proj and fully_fused_projection).
// PyTorch rounds every elementwise operation on its own, so every
// multiply, add, divide and square root here is an explicitly rounded
// intrinsic (no fused multiply-add, whatever the compiler's contraction
// setting).  The culls and the radii are discontinuous (a ceil and five
// comparisons), so one ulp anywhere upstream of them could move a radius or
// drop a gaussian: the radii, means2d, depths, conics and opacities equal
// the plain route's bit for bit.  Where PyTorch's own rules pick the
// operation, this code picks the same one:
//   * a Python float divided by a tensor is the tensor's reciprocal times
//     the float (Tensor.__rtruediv__), and on the card a tensor divided by
//     a Python float is a multiply by the float's reciprocal, taken in
//     double and then rounded (x / (1/255) is x * 255.0f);
//   * torch.maximum, torch.minimum and clamp pass a NaN through;
//   * a float scalar enters an operation on float32 as its float32 value;
//   * the squared norm of a quaternion, torch.sum over its 4 entries, is
//     PyTorch's reduction of a contiguous row of 4 across 4 lanes, whose
//     shuffles add lanes 2 apart first: (w^2 + y^2) + (x^2 + z^2);
//   * torch.rsqrt is rsqrtf, not a rounded 1 / sqrt.
// The SH colours carry no gate, so their sums are held to a tolerance only;
// they still follow PyTorch's order where it is known (sh_color).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gs {
namespace proj {

constexpr float kAlphaThreshold = (float)(1.0 / 255.0);
// clamp(op, 1/255) / (1/255) on the card: times the reciprocal, rounded
constexpr float kInvAlphaThreshold = (float)(1.0 / (1.0 / 255.0));
constexpr float kGaussianExtend = 3.33f;
constexpr float kMinCompensationSq = (float)(0.005 * 0.005);
constexpr float kTzEps = 1e-6f;
constexpr float kQuatEpsSq = (float)(1e-12 * 1e-12);  // normalize()'s clamp
constexpr float kQuatZero = 1e-24f;  // the sanitisation's zero quaternion

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float rcp(float a) { return __frcp_rn(a); }

// torch.maximum / torch.minimum / clamp: a NaN operand is the result
__device__ __forceinline__ float nan_max(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

// One camera's constants: the rotation and translation of its view matrix,
// the pinhole intrinsics, _persp_proj's frustum limits and the centre that
// the SH directions start from (ops/projection_kernel.py:campos_from_viewmats).
struct Camera {
  float R[3][3], t[3];
  float fx, fy, cx, cy;
  float lim_x_pos, lim_x_neg, lim_y_pos, lim_y_neg;
  float campos[3];
};

// viewmat [4, 4] and K [3, 3], row-major float32
__device__ __forceinline__ Camera load_camera(const float* vm, const float* K, int width,
                                              int height) {
  Camera c;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) c.R[i][j] = vm[i * 4 + j];
    c.t[i] = vm[i * 4 + 3];
  }
  c.fx = K[0];
  c.fy = K[4];
  c.cx = K[2];
  c.cy = K[5];
  const float W = (float)width, H = (float)height;
  // tan_fovx = 0.5 * width / fx: reciprocal(fx) * (0.5 * width)
  const float tan_fovx = mul(rcp(c.fx), 0.5f * W);
  const float tan_fovy = mul(rcp(c.fy), 0.5f * H);
  c.lim_x_pos = add(div(sub(W, c.cx), c.fx), mul(0.3f, tan_fovx));
  c.lim_x_neg = add(div(c.cx, c.fx), mul(0.3f, tan_fovx));
  c.lim_y_pos = add(div(sub(H, c.cy), c.fy), mul(0.3f, tan_fovy));
  c.lim_y_neg = add(div(c.cy, c.fy), mul(0.3f, tan_fovy));
  // -(R * t[:, None]).sum(rows): each column's three products in row order
#pragma unroll
  for (int j = 0; j < 3; ++j)
    c.campos[j] = -add(add(mul(c.R[0][j], c.t[0]), mul(c.R[1][j], c.t[1])),
                       mul(c.R[2][j], c.t[2]));
  return c;
}

// torch.sum(q * q, dim=-1) over a contiguous row of 4
__device__ __forceinline__ float quat_sqnorm(const float q[4]) {
  return add(add(mul(q[0], q[0]), mul(q[2], q[2])), add(mul(q[1], q[1]), mul(q[3], q[3])));
}

// One gaussian as the projection reads it, after the sanitisation: a row
// with a non-finite entry or a zero quaternion becomes the unit gaussian at
// the origin with opacity 0, which the alpha cull removes (`ok` false).
struct Gaussian {
  float m[3], q[4], s[3], op;
  bool ok;
};

__device__ __forceinline__ Gaussian sanitize(const float m[3], const float q[4],
                                             const float s[3], float op) {
  bool ok = isfinite(m[0]) && isfinite(m[1]) && isfinite(m[2]);
  ok = ok && isfinite(q[0]) && isfinite(q[1]) && isfinite(q[2]) && isfinite(q[3]);
  ok = ok && quat_sqnorm(q) > kQuatZero;
  ok = ok && isfinite(s[0]) && isfinite(s[1]) && isfinite(s[2]) && isfinite(op);
  Gaussian g;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    g.m[i] = ok ? m[i] : 0.0f;
    g.s[i] = ok ? s[i] : 1.0f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) g.q[i] = ok ? q[i] : (i == 0 ? 1.0f : 0.0f);
  g.op = ok ? op : 0.0f;
  g.ok = ok;
  return g;
}

// The world covariance (ops/math.py): the normalised quaternion
// q * rsqrt(clamp(sum(q * q), 1e-24)), its rotation Q, M = Q diag(s) and
// S = sym_mmT(M).  The same for every camera.
struct Covar {
  float rs, w, x, y, z;
  float Q[3][3], M[3][3], S[3][3];
};

__device__ __forceinline__ Covar world_covar(const Gaussian& g) {
  Covar v;
  v.rs = rsqrtf(nan_max(quat_sqnorm(g.q), kQuatEpsSq));
  const float w = mul(g.q[0], v.rs), x = mul(g.q[1], v.rs), y = mul(g.q[2], v.rs),
              z = mul(g.q[3], v.rs);
  v.w = w;
  v.x = x;
  v.y = y;
  v.z = z;
  const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
  const float xy = mul(x, y), xz = mul(x, z), yz = mul(y, z);
  const float wx = mul(w, x), wy = mul(w, y), wz = mul(w, z);
  const float Q[3][3] = {
      {sub(1.0f, mul(2.0f, add(yy, zz))), mul(2.0f, sub(xy, wz)), mul(2.0f, add(xz, wy))},
      {mul(2.0f, add(xy, wz)), sub(1.0f, mul(2.0f, add(xx, zz))), mul(2.0f, sub(yz, wx))},
      {mul(2.0f, sub(xz, wy)), mul(2.0f, add(yz, wx)), sub(1.0f, mul(2.0f, add(xx, yy)))}};
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      v.Q[i][j] = Q[i][j];
      v.M[i][j] = mul(Q[i][j], g.s[j]);
    }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = i; j < 3; ++j) {
      v.S[i][j] = add(add(mul(v.M[i][0], v.M[j][0]), mul(v.M[i][1], v.M[j][1])),
                      mul(v.M[i][2], v.M[j][2]));
      v.S[j][i] = v.S[i][j];
    }
  return v;
}

// _world_to_cam and _persp_proj of one gaussian in one camera, with what
// the backward replays: the camera-frame mean t and covariance s (s00, s01,
// s02, s11, s12, s22), the depth used (tz, or 1 on the camera plane), the
// frustum-clamped tx / tzp and ty / tzp before (ux, uy) and after (uxc,
// uyc) the clamp, the Jacobian and the 2D covariance (c00, c01, c11).
struct Persp {
  float t[3];
  float s[6];
  float tzp;
  bool plane;  // |tz| < 1e-6: tzp = 1, which no gradient reaches
  float ux, uy, uxc, uyc, txc, tyc, rz, rz2;
  float j00, j02, j11, j12;
  float c00, c01, c11;
};

__device__ __forceinline__ Persp persp(const Camera& cam, const float m[3], const float S[3][3]) {
  Persp p;
  const float(&R)[3][3] = cam.R;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    p.t[i] = add(add(add(mul(R[i][0], m[0]), mul(R[i][1], m[1])), mul(R[i][2], m[2])),
                 cam.t[i]);
  float B[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      B[i][j] = add(add(mul(R[i][0], S[0][j]), mul(R[i][1], S[1][j])), mul(R[i][2], S[2][j]));
  auto sym = [&](int i, int l) {
    return add(add(mul(B[i][0], R[l][0]), mul(B[i][1], R[l][1])), mul(B[i][2], R[l][2]));
  };
  p.s[0] = sym(0, 0);
  p.s[1] = sym(0, 1);
  p.s[2] = sym(0, 2);
  p.s[3] = sym(1, 1);
  p.s[4] = sym(1, 2);
  p.s[5] = sym(2, 2);
  const float s00 = p.s[0], s01 = p.s[1], s02 = p.s[2], s11 = p.s[3], s12 = p.s[4],
              s22 = p.s[5];

  // a mean on the camera plane projects with tz = 1
  p.plane = fabsf(p.t[2]) < kTzEps;
  p.tzp = p.plane ? 1.0f : p.t[2];
  p.ux = div(p.t[0], p.tzp);
  p.uy = div(p.t[1], p.tzp);
  p.uxc = nan_min(nan_max(p.ux, -cam.lim_x_neg), cam.lim_x_pos);
  p.uyc = nan_min(nan_max(p.uy, -cam.lim_y_neg), cam.lim_y_pos);
  p.txc = mul(p.tzp, p.uxc);
  p.tyc = mul(p.tzp, p.uyc);
  p.rz = rcp(p.tzp);
  p.rz2 = mul(p.rz, p.rz);
  const float fx = cam.fx, fy = cam.fy;
  p.j00 = mul(fx, p.rz);
  p.j02 = mul(mul(-fx, p.txc), p.rz2);
  p.j11 = mul(fy, p.rz);
  p.j12 = mul(mul(-fy, p.tyc), p.rz2);
  const float j00 = p.j00, j02 = p.j02, j11 = p.j11, j12 = p.j12;
  p.c00 = add(mul(j00, add(mul(j00, s00), mul(j02, s02))),
              mul(j02, add(mul(j00, s02), mul(j02, s22))));
  p.c01 = add(mul(j00, add(mul(j11, s01), mul(j12, s02))),
              mul(j02, add(mul(j11, s12), mul(j12, s22))));
  p.c11 = add(mul(j11, add(mul(j11, s11), mul(j12, s12))),
              mul(j12, add(mul(j11, s12), mul(j12, s22))));
  return p;
}

// fully_fused_projection's blur, conic and compensation of a 2D covariance:
// b = c + eps2d on the diagonal, det = clamp(b00 b11 - c01^2, 1e-10), the
// conic (b11, -c01, b00) / det and, antialiased, comp = sqrt(clamp(det_orig
// / det, 0.005^2)) with det_orig = c00 c11 - c01^2.
struct Conic {
  float det_orig, b00, b11, det_raw, det, ratio, comp, inv_det;
  float ca, cb, cc;
};

__device__ __forceinline__ Conic blur(const Persp& p, float eps2d, bool antialiased) {
  Conic k;
  k.det_orig = sub(mul(p.c00, p.c11), mul(p.c01, p.c01));
  k.b00 = add(p.c00, eps2d);
  k.b11 = add(p.c11, eps2d);
  k.det_raw = sub(mul(k.b00, k.b11), mul(p.c01, p.c01));
  k.det = nan_max(k.det_raw, 1e-10f);
  k.ratio = k.comp = 1.0f;
  if (antialiased) {
    k.ratio = div(k.det_orig, k.det);
    k.comp = __fsqrt_rn(nan_max(k.ratio, kMinCompensationSq));
  }
  k.inv_det = rcp(k.det);
  k.ca = mul(k.b11, k.inv_det);
  k.cb = mul(-p.c01, k.inv_det);
  k.cc = mul(k.b00, k.inv_det);
  return k;
}

// What the composite takes for one (camera, gaussian): integer radii (0 =
// culled), the mean in pixels, the depth, the conic (a, b, c) and the
// opacity (times the compensation when antialiased).
struct Projected {
  int rx, ry;
  float m2x, m2y, depth;
  float ca, cb, cc;
  float op;
};

__device__ __forceinline__ Projected project(const Camera& cam, const Gaussian& g, float eps2d,
                                             float near_plane, float far_plane,
                                             float radius_clip, bool antialiased, int width,
                                             int height) {
  const Covar cv = world_covar(g);
  const Persp pp = persp(cam, g.m, cv.S);
  const Conic k = blur(pp, eps2d, antialiased);
  const float tz = pp.t[2];

  Projected p;
  p.m2x = add(mul(mul(cam.fx, pp.t[0]), pp.rz), cam.cx);
  p.m2y = add(mul(mul(cam.fy, pp.t[1]), pp.rz), cam.cy);
  p.depth = tz;
  const float op = antialiased ? mul(g.op, k.comp) : g.op;
  p.op = op;
  p.ca = k.ca;
  p.cb = k.cb;
  p.cc = k.cc;

  // fully_fused_projection's culls and radii
  bool valid = (tz >= near_plane) && (tz <= far_plane) && (op >= kAlphaThreshold);
  const float extend = nan_min(
      __fsqrt_rn(mul(2.0f, logf(mul(nan_max(op, kAlphaThreshold), kInvAlphaThreshold)))),
      kGaussianExtend);
  const float rxf = ceilf(mul(extend, __fsqrt_rn(nan_max(k.b00, 0.0f))));
  const float ryf = ceilf(mul(extend, __fsqrt_rn(nan_max(k.b11, 0.0f))));
  valid = valid && !((rxf <= radius_clip) && (ryf <= radius_clip));
  valid = valid && !((add(p.m2x, rxf) <= 0.0f) || (sub(p.m2x, rxf) >= (float)width) ||
                     (add(p.m2y, ryf) <= 0.0f) || (sub(p.m2y, ryf) >= (float)height));
  p.rx = valid ? (int)rxf : 0;
  p.ry = valid ? (int)ryf : 0;
  return p;
}

// Real SH bases (ops/sh.py:eval_sh_bases, Sloan's fast bases) of degree DEG
// at the unit direction (x, y, z), each product and sum rounded alone.
template <int DEG>
__device__ __forceinline__ void sh_bases(float x, float y, float z, float* b) {
  b[0] = 0.2820947917738781f;
  if (DEG < 1) return;
  const float fTmpA = -0.48860251190292f;
  b[1] = mul(fTmpA, y);
  b[2] = mul(-fTmpA, z);
  b[3] = mul(fTmpA, x);
  if (DEG < 2) return;
  const float z2 = mul(z, z);
  const float fTmpB = mul(-1.092548430592079f, z);
  const float fTmpA2 = 0.5462742152960395f;
  const float fC1 = sub(mul(x, x), mul(y, y));
  const float fS1 = mul(mul(2.0f, x), y);
  b[4] = mul(fTmpA2, fS1);
  b[5] = mul(fTmpB, y);
  b[6] = sub(mul(0.9461746957575601f, z2), 0.3153915652525201f);
  b[7] = mul(fTmpB, x);
  b[8] = mul(fTmpA2, fC1);
  if (DEG < 3) return;
  const float fTmpC = add(mul(-2.285228997322329f, z2), 0.4570457994644658f);
  const float fTmpB3 = mul(1.445305721320277f, z);
  const float fTmpA3 = -0.5900435899266435f;
  const float fC2 = sub(mul(x, fC1), mul(y, fS1));
  const float fS2 = add(mul(x, fS1), mul(y, fC1));
  b[9] = mul(fTmpA3, fS2);
  b[10] = mul(fTmpB3, fS1);
  b[11] = mul(fTmpC, y);
  b[12] = mul(z, sub(mul(1.865881662950577f, z2), 1.119528997770346f));
  b[13] = mul(fTmpC, x);
  b[14] = mul(fTmpB3, fC1);
  b[15] = mul(fTmpA3, fC2);
  if (DEG < 4) return;
  const float fTmpD = mul(z, add(mul(-4.683325804901025f, z2), 2.007139630671868f));
  const float fTmpC4 = sub(mul(3.31161143515146f, z2), 0.47308734787878f);
  const float fTmpB4 = mul(-1.770130769779931f, z);
  const float fTmpA4 = 0.6258357354491763f;
  const float fC3 = sub(mul(x, fC2), mul(y, fS2));
  const float fS3 = add(mul(x, fS2), mul(y, fC2));
  b[16] = mul(fTmpA4, fS3);
  b[17] = mul(fTmpB4, fS2);
  b[18] = mul(fTmpC4, fS1);
  b[19] = mul(fTmpD, y);
  b[20] = add(mul(mul(1.984313483298443f, z2),
                  sub(mul(1.865881662950577f, z2), 1.119528997770346f)),
              mul(-1.006230589874905f, sub(mul(0.9461746957575601f, z2), 0.3153915652525201f)));
  b[21] = mul(fTmpD, x);
  b[22] = mul(fTmpC4, fC1);
  b[23] = mul(fTmpB4, fC2);
  b[24] = mul(fTmpA4, fC3);
}

// The view direction of a gaussian from a camera (ops/sh.py): d, the mean
// minus the camera centre; its norm, summed as torch.linalg.vector_norm sums
// a row of 3 on the card, (x^2 + z^2) + y^2; len, the norm clamped at 1e-12;
// and dn = d / len.
struct ShDir {
  float d[3], norm, len, dn[3];
};

__device__ __forceinline__ ShDir sh_dir(const Camera& cam, const float m[3]) {
  ShDir v;
#pragma unroll
  for (int i = 0; i < 3; ++i) v.d[i] = sub(m[i], cam.campos[i]);
  v.norm = __fsqrt_rn(add(add(mul(v.d[0], v.d[0]), mul(v.d[2], v.d[2])), mul(v.d[1], v.d[1])));
  v.len = nan_max(v.norm, 1e-12f);
#pragma unroll
  for (int i = 0; i < 3; ++i) v.dn[i] = div(v.d[i], v.len);
  return v;
}

// Each channel's sum over the bases of coeffs c[k * 3 + ch], in the order of
// PyTorch's reduction over that strided axis: four partial sums of the bases
// k = i (mod 4), each in k order, then ((s0 + s1) + s2) + s3.
template <int DEG>
__device__ __forceinline__ void sh_sum(const float* b, const float* c, float out[3]) {
  constexpr int NB = (DEG + 1) * (DEG + 1);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < NB; ++k) s[k % 4] = add(s[k % 4], mul(b[k], c[k * 3 + ch]));
    out[ch] = add(add(add(s[0], s[1]), s[2]), s[3]);
  }
}

// The SH colour of one visible gaussian, before the +0.5 and the clamp:
// coeffs c[k * 3 + ch] for the first (DEG + 1)^2 bases k at the direction
// from the camera.
template <int DEG>
__device__ __forceinline__ void sh_color(const Camera& cam, const float m[3], const float* c,
                                         float out[3]) {
  const ShDir v = sh_dir(cam, m);
  float b[(DEG + 1) * (DEG + 1)];
  sh_bases<DEG>(v.dn[0], v.dn[1], v.dn[2], b);
  sh_sum<DEG>(b, c, out);
}

// ---------------------------------------------------------------------------
// The backward of the training route (projection_bwd.cu): the
// vector-Jacobian product of sanitise, project and shade, as PyTorch's
// autograd takes it through the plain route.  Each gaussian's forward is
// replayed from its inputs by the functions above, so that every clamp,
// where and mask decides as the forward did.  PyTorch's conventions: clamp
// passes the gradient where its input is at or above the floor (NaN is
// not), torch.maximum and torch.minimum pass half of it to each side at a
// tie, a mean on the camera plane (tz replaced by 1) gets none through the
// replaced depth, a sanitised row gets none at all, and a culled row's
// colour none.  No gate reads a gradient, so these sums are plain float
// arithmetic, which the compiler may contract.

// Cotangents of one (camera, gaussian)'s outputs.
struct ProjectedGrad {
  float m2x, m2y, depth, ca, cb, cc, op;
};

// d/du of min(max(u, lo), hi), as torch.maximum and then torch.minimum
// take it: the whole where the clamp passes u (NaN too), half at a tie.
__device__ __forceinline__ float clamp_vjp(float u, float lo, float hi, float v) {
  const float mx = nan_max(u, lo);
  const float v_mx = mx > hi ? 0.0f : (mx == hi ? 0.5f * v : v);
  return u < lo ? 0.0f : (u == lo ? 0.5f * v_mx : v_mx);
}

// One camera's projection of one gaussian backward: from the outputs'
// cotangents to the camera-frame mean's (v_t) and covariance's (v_s: s00,
// s01, s02, s11, s12, s22); the sanitised opacity's is added to v_opac.
__device__ __forceinline__ void project_vjp(const Camera& cam, const Persp& p, const Conic& k,
                                            float opac, bool antialiased,
                                            const ProjectedGrad& v, float v_t[3], float v_s[6],
                                            float& v_opac) {
  // op = opacity (times comp); comp = sqrt(clamp(ratio, 0.005^2)),
  // ratio = det_orig / det
  float v_det = 0.0f, v_det_orig = 0.0f;
  if (antialiased) {
    v_opac += v.op * k.comp;
    const float v_comp = v.op * opac;
    const float v_ratio = k.ratio >= kMinCompensationSq ? v_comp * 0.5f / k.comp : 0.0f;
    v_det_orig = v_ratio / k.det;
    v_det = -v_ratio * k.ratio / k.det;
  } else {
    v_opac += v.op;
  }
  // conic = (b11, -c01, b00) * inv_det, inv_det = 1 / det
  const float v_inv = v.ca * k.b11 - v.cb * p.c01 + v.cc * k.b00;
  float v_b00 = v.cc * k.inv_det, v_b11 = v.ca * k.inv_det, v_c01 = -v.cb * k.inv_det;
  v_det -= v_inv * k.inv_det * k.inv_det;
  // det = clamp(b00 b11 - c01^2, 1e-10)
  if (k.det_raw >= 1e-10f) {
    v_b00 += v_det * k.b11;
    v_b11 += v_det * k.b00;
    v_c01 -= 2.0f * p.c01 * v_det;
  }
  // b = c + eps2d on the diagonal; det_orig = c00 c11 - c01^2
  const float v_c00 = v_b00 + v_det_orig * p.c11;
  const float v_c11 = v_b11 + v_det_orig * p.c00;
  v_c01 -= 2.0f * p.c01 * v_det_orig;
  // c = J s J^T with J = [[j00, 0, j02], [0, j11, j12]]
  const float s00 = p.s[0], s01 = p.s[1], s02 = p.s[2], s11 = p.s[3], s12 = p.s[4],
              s22 = p.s[5];
  const float j00 = p.j00, j02 = p.j02, j11 = p.j11, j12 = p.j12;
  v_s[0] = v_c00 * j00 * j00;
  v_s[1] = v_c01 * j00 * j11;
  v_s[2] = 2.0f * v_c00 * j00 * j02 + v_c01 * j00 * j12;
  v_s[3] = v_c11 * j11 * j11;
  v_s[4] = v_c01 * j02 * j11 + 2.0f * v_c11 * j11 * j12;
  v_s[5] = v_c00 * j02 * j02 + v_c01 * j02 * j12 + v_c11 * j12 * j12;
  const float v_j00 = 2.0f * v_c00 * (j00 * s00 + j02 * s02) + v_c01 * (j11 * s01 + j12 * s02);
  const float v_j02 = 2.0f * v_c00 * (j00 * s02 + j02 * s22) + v_c01 * (j11 * s12 + j12 * s22);
  const float v_j11 = 2.0f * v_c11 * (j11 * s11 + j12 * s12) + v_c01 * (j00 * s01 + j02 * s12);
  const float v_j12 = 2.0f * v_c11 * (j11 * s12 + j12 * s22) + v_c01 * (j00 * s02 + j02 * s22);
  // j00 = fx rz, j02 = -fx txc rz^2 (y alike), rz = 1 / tzp, means2d = f t rz + c
  const float fx = cam.fx, fy = cam.fy;
  const float v_rz2 = -fx * p.txc * v_j02 - fy * p.tyc * v_j12;
  const float v_rz = fx * v_j00 + fy * v_j11 + fx * p.t[0] * v.m2x + fy * p.t[1] * v.m2y +
                     2.0f * p.rz * v_rz2;
  float v_tzp = -v_rz * p.rz * p.rz;
  const float v_txc = -fx * p.rz2 * v_j02, v_tyc = -fy * p.rz2 * v_j12;
  // txc = tzp * clamp(tx / tzp) (ty alike)
  v_tzp += p.uxc * v_txc + p.uyc * v_tyc;
  const float v_ux = clamp_vjp(p.ux, -cam.lim_x_neg, cam.lim_x_pos, p.tzp * v_txc);
  const float v_uy = clamp_vjp(p.uy, -cam.lim_y_neg, cam.lim_y_pos, p.tzp * v_tyc);
  v_t[0] = fx * p.rz * v.m2x + v_ux / p.tzp;
  v_t[1] = fy * p.rz * v.m2y + v_uy / p.tzp;
  v_tzp -= (v_ux * p.ux + v_uy * p.uy) / p.tzp;
  v_t[2] = v.depth + (p.plane ? 0.0f : v_tzp);
}

// Adds one camera's v_t and v_s to the gaussian's: v_m += R^T v_t, and
// H += R^T W R with W the symmetric matrix of v_s whose diagonal is doubled.
// H (h00, h01, h02, h11, h12, h22) is then the world covariance's gradient
// plus its transpose, which sym_mmT's backward takes: v_M = H M.
__device__ __forceinline__ void to_world(const Camera& cam, const float v_t[3],
                                         const float v_s[6], float v_m[3], float H[6]) {
  const float(&R)[3][3] = cam.R;
#pragma unroll
  for (int j = 0; j < 3; ++j) v_m[j] += R[0][j] * v_t[0] + R[1][j] * v_t[1] + R[2][j] * v_t[2];
  const float W[3][3] = {{2.0f * v_s[0], v_s[1], v_s[2]},
                         {v_s[1], 2.0f * v_s[3], v_s[4]},
                         {v_s[2], v_s[4], 2.0f * v_s[5]}};
  float T[3][3];  // W R
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int l = 0; l < 3; ++l) T[i][l] = W[i][0] * R[0][l] + W[i][1] * R[1][l] + W[i][2] * R[2][l];
  int h = 0;
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int l = j; l < 3; ++l) H[h++] += R[0][j] * T[0][l] + R[1][j] * T[1][l] + R[2][j] * T[2][l];
}

// From H (to_world) to the raw quaternion's and the scales' gradients:
// M = Q diag(s), Q the rotation of the normalised quaternion, and the
// normalisation q * rsqrt(clamp(|q|^2, 1e-24)).
__device__ __forceinline__ void covar_vjp(const Gaussian& g, const Covar& cv, const float H[6],
                                          float v_q[4], float v_s[3]) {
  const float Hf[3][3] = {{H[0], H[1], H[2]}, {H[1], H[3], H[4]}, {H[2], H[4], H[5]}};
  float V[3][3];  // v_Q
#pragma unroll
  for (int j = 0; j < 3; ++j) v_s[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float v_M = Hf[i][0] * cv.M[0][j] + Hf[i][1] * cv.M[1][j] + Hf[i][2] * cv.M[2][j];
      V[i][j] = v_M * g.s[j];
      v_s[j] += v_M * cv.Q[i][j];
    }
  const float w = cv.w, x = cv.x, y = cv.y, z = cv.z;
  const float vn[4] = {
      2.0f * (-z * V[0][1] + y * V[0][2] + z * V[1][0] - x * V[1][2] - y * V[2][0] +
              x * V[2][1]),
      2.0f * (y * V[0][1] + z * V[0][2] + y * V[1][0] - 2.0f * x * V[1][1] - w * V[1][2] +
              z * V[2][0] + w * V[2][1] - 2.0f * x * V[2][2]),
      2.0f * (-2.0f * y * V[0][0] + x * V[0][1] + w * V[0][2] + x * V[1][0] + z * V[1][2] -
              w * V[2][0] + z * V[2][1] - 2.0f * y * V[2][2]),
      2.0f * (-2.0f * z * V[0][0] - w * V[0][1] + x * V[0][2] + w * V[1][0] -
              2.0f * z * V[1][1] + y * V[1][2] + x * V[2][0] + y * V[2][1])};
  const float dot = vn[0] * g.q[0] + vn[1] * g.q[1] + vn[2] * g.q[2] + vn[3] * g.q[3];
  const float rs3 = quat_sqnorm(g.q) >= kQuatEpsSq ? cv.rs * cv.rs * cv.rs : 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) v_q[i] = cv.rs * vn[i] - rs3 * dot * g.q[i];
}

// The bases' backward (sh_bases): adds sum_k v_b[k] * grad b_k to v.
template <int DEG>
__device__ __forceinline__ void sh_bases_vjp(float x, float y, float z, const float* v_b,
                                             float v[3]) {
  if (DEG < 1) return;
  const float fTmpA = -0.48860251190292f;
  v[0] += fTmpA * v_b[3];
  v[1] += fTmpA * v_b[1];
  v[2] -= fTmpA * v_b[2];
  if (DEG < 2) return;
  const float z2 = z * z;
  const float fTmpB = -1.092548430592079f * z;
  const float fTmpA2 = 0.5462742152960395f;
  const float fC1 = x * x - y * y;
  const float fS1 = 2.0f * x * y;
  v[0] += fTmpA2 * 2.0f * (y * v_b[4] + x * v_b[8]) + fTmpB * v_b[7];
  v[1] += fTmpA2 * 2.0f * (x * v_b[4] - y * v_b[8]) + fTmpB * v_b[5];
  v[2] += -1.092548430592079f * (y * v_b[5] + x * v_b[7]) +
          2.0f * 0.9461746957575601f * z * v_b[6];
  if (DEG < 3) return;
  const float fTmpC = -2.285228997322329f * z2 + 0.4570457994644658f;
  const float fTmpB3 = 1.445305721320277f * z;
  const float fTmpA3 = -0.5900435899266435f;
  const float fC2 = x * fC1 - y * fS1;
  const float fS2 = x * fS1 + y * fC1;
  // d fC(n)/dx = n fC(n-1), d fS(n)/dx = n fS(n-1), d fC(n)/dy = -n fS(n-1),
  // d fS(n)/dy = n fC(n-1): the real and imaginary parts of (x + iy)^(n+1)
  v[0] += fTmpA3 * 3.0f * (fS1 * v_b[9] + fC1 * v_b[15]) +
          fTmpB3 * 2.0f * (y * v_b[10] + x * v_b[14]) + fTmpC * v_b[13];
  v[1] += fTmpA3 * 3.0f * (fC1 * v_b[9] - fS1 * v_b[15]) +
          fTmpB3 * 2.0f * (x * v_b[10] - y * v_b[14]) + fTmpC * v_b[11];
  v[2] += 1.445305721320277f * (fS1 * v_b[10] + fC1 * v_b[14]) -
          2.0f * 2.285228997322329f * z * (y * v_b[11] + x * v_b[13]) +
          (3.0f * 1.865881662950577f * z2 - 1.119528997770346f) * v_b[12];
  if (DEG < 4) return;
  const float fTmpD = z * (-4.683325804901025f * z2 + 2.007139630671868f);
  const float dTmpD = -3.0f * 4.683325804901025f * z2 + 2.007139630671868f;
  const float fTmpC4 = 3.31161143515146f * z2 - 0.47308734787878f;
  const float fTmpB4 = -1.770130769779931f * z;
  const float fTmpA4 = 0.6258357354491763f;
  v[0] += fTmpA4 * 4.0f * (fS2 * v_b[16] + fC2 * v_b[24]) +
          fTmpB4 * 3.0f * (fS1 * v_b[17] + fC1 * v_b[23]) +
          fTmpC4 * 2.0f * (y * v_b[18] + x * v_b[22]) + fTmpD * v_b[21];
  v[1] += fTmpA4 * 4.0f * (fC2 * v_b[16] - fS2 * v_b[24]) +
          fTmpB4 * 3.0f * (fC1 * v_b[17] - fS1 * v_b[23]) +
          fTmpC4 * 2.0f * (x * v_b[18] - y * v_b[22]) + fTmpD * v_b[19];
  v[2] += -1.770130769779931f * (fS2 * v_b[17] + fC2 * v_b[23]) +
          2.0f * 3.31161143515146f * z * (fS1 * v_b[18] + fC1 * v_b[22]) +
          dTmpD * (y * v_b[19] + x * v_b[21]) +
          (1.984313483298443f * (4.0f * 1.865881662950577f * z2 * z -
                                 2.0f * 1.119528997770346f * z) -
           1.006230589874905f * 2.0f * 0.9461746957575601f * z) *
              v_b[20];
}

// One visible gaussian's SH colour backward through its direction: from
// v_col (the cotangent of the colour before the +0.5) and the bases b to the
// mean's gradient, added to v_m.
template <int DEG>
__device__ __forceinline__ void sh_dir_vjp(const ShDir& sd, const float* c, const float* b,
                                           const float v_col[3], float v_m[3]) {
  if (DEG < 1) return;
  constexpr int NB = (DEG + 1) * (DEG + 1);
  float v_b[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k)
    v_b[k] = c[3 * k] * v_col[0] + c[3 * k + 1] * v_col[1] + c[3 * k + 2] * v_col[2];
  float v_dn[3] = {0.0f, 0.0f, 0.0f};
  sh_bases_vjp<DEG>(sd.dn[0], sd.dn[1], sd.dn[2], v_b, v_dn);
  // dn = d / clamp(|d|, 1e-12); |d|'s gradient is d / |d|
  const float dot = v_dn[0] * sd.d[0] + v_dn[1] * sd.d[1] + v_dn[2] * sd.d[2];
  const float v_norm = sd.norm >= 1e-12f ? -dot / (sd.len * sd.len * sd.norm) : 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) v_m[i] += v_dn[i] / sd.len + v_norm * sd.d[i];
}

}  // namespace proj
}  // namespace gs
