// The per-row arithmetic of the projection and its SH colours, shared by the
// no-grad projection pass (projection_fwd.cu) and, later, its backward.
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
// the origin with opacity 0, which the alpha cull removes.
struct Gaussian {
  float m[3], q[4], s[3], op;
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
  return g;
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
  // normalize(quats): q * rsqrt(clamp(sum(q * q), 1e-24))
  const float rs = rsqrtf(nan_max(quat_sqnorm(g.q), kQuatEpsSq));
  const float w = mul(g.q[0], rs), x = mul(g.q[1], rs), y = mul(g.q[2], rs),
              z = mul(g.q[3], rs);
  const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
  const float xy = mul(x, y), xz = mul(x, z), yz = mul(y, z);
  const float wx = mul(w, x), wy = mul(w, y), wz = mul(w, z);
  const float Q[3][3] = {
      {sub(1.0f, mul(2.0f, add(yy, zz))), mul(2.0f, sub(xy, wz)), mul(2.0f, add(xz, wy))},
      {mul(2.0f, add(xy, wz)), sub(1.0f, mul(2.0f, add(xx, zz))), mul(2.0f, sub(yz, wx))},
      {mul(2.0f, sub(xz, wy)), mul(2.0f, add(yz, wx)), sub(1.0f, mul(2.0f, add(xx, yy)))}};
  // world covariance: sym_mmT(R * scales[None, :])
  float M[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) M[i][j] = mul(Q[i][j], g.s[j]);
  float S[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = i; j < 3; ++j) {
      S[i][j] = add(add(mul(M[i][0], M[j][0]), mul(M[i][1], M[j][1])), mul(M[i][2], M[j][2]));
      S[j][i] = S[i][j];
    }

  // _world_to_cam
  const float(&R)[3][3] = cam.R;
  float tc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    tc[i] = add(add(add(mul(R[i][0], g.m[0]), mul(R[i][1], g.m[1])), mul(R[i][2], g.m[2])),
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
  const float s00 = sym(0, 0), s01 = sym(0, 1), s02 = sym(0, 2), s11 = sym(1, 1),
              s12 = sym(1, 2), s22 = sym(2, 2);
  const float tx = tc[0], ty = tc[1], tz = tc[2];

  // _persp_proj: a mean on the camera plane projects with tz = 1
  const float tzp = fabsf(tz) < kTzEps ? 1.0f : tz;
  const float txc = mul(tzp, nan_min(nan_max(div(tx, tzp), -cam.lim_x_neg), cam.lim_x_pos));
  const float tyc = mul(tzp, nan_min(nan_max(div(ty, tzp), -cam.lim_y_neg), cam.lim_y_pos));
  const float rz = rcp(tzp);
  const float rz2 = mul(rz, rz);
  const float fx = cam.fx, fy = cam.fy;
  const float j00 = mul(fx, rz);
  const float j02 = mul(mul(-fx, txc), rz2);
  const float j11 = mul(fy, rz);
  const float j12 = mul(mul(-fy, tyc), rz2);
  const float c00 = add(mul(j00, add(mul(j00, s00), mul(j02, s02))),
                        mul(j02, add(mul(j00, s02), mul(j02, s22))));
  const float c01 = add(mul(j00, add(mul(j11, s01), mul(j12, s02))),
                        mul(j02, add(mul(j11, s12), mul(j12, s22))));
  const float c11 = add(mul(j11, add(mul(j11, s11), mul(j12, s12))),
                        mul(j12, add(mul(j11, s12), mul(j12, s22))));

  Projected p;
  p.m2x = add(mul(mul(fx, tx), rz), cam.cx);
  p.m2y = add(mul(mul(fy, ty), rz), cam.cy);
  p.depth = tz;

  // fully_fused_projection: blur, conic, compensation, culls, radii
  const float det_orig = sub(mul(c00, c11), mul(c01, c01));
  const float b00 = add(c00, eps2d);
  const float b11 = add(c11, eps2d);
  const float det = nan_max(sub(mul(b00, b11), mul(c01, c01)), 1e-10f);
  float op = g.op;
  if (antialiased) op = mul(op, __fsqrt_rn(nan_max(div(det_orig, det), kMinCompensationSq)));
  p.op = op;
  const float inv_det = rcp(det);
  p.ca = mul(b11, inv_det);
  p.cb = mul(-c01, inv_det);
  p.cc = mul(b00, inv_det);

  bool valid = (tz >= near_plane) && (tz <= far_plane) && (op >= kAlphaThreshold);
  const float extend = nan_min(
      __fsqrt_rn(mul(2.0f, logf(mul(nan_max(op, kAlphaThreshold), kInvAlphaThreshold)))),
      kGaussianExtend);
  const float rxf = ceilf(mul(extend, __fsqrt_rn(nan_max(b00, 0.0f))));
  const float ryf = ceilf(mul(extend, __fsqrt_rn(nan_max(b11, 0.0f))));
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

// The SH colour of one visible gaussian, before the +0.5 and the clamp:
// coeffs c[k * 3 + ch] for the first (DEG + 1)^2 bases k.  The direction is
// the mean minus the camera centre over its norm (ops/sh.py), and each
// channel's sum over the bases follows PyTorch's reduction over that strided
// axis: four partial sums of the bases k = i (mod 4), each in k order, then
// ((s0 + s1) + s2) + s3.
template <int DEG>
__device__ __forceinline__ void sh_color(const Camera& cam, const float m[3], const float* c,
                                         float out[3]) {
  constexpr int NB = (DEG + 1) * (DEG + 1);
  const float dx = sub(m[0], cam.campos[0]);
  const float dy = sub(m[1], cam.campos[1]);
  const float dz = sub(m[2], cam.campos[2]);
  const float norm = __fsqrt_rn(add(add(mul(dx, dx), mul(dz, dz)), mul(dy, dy)));
  const float len = nan_max(norm, 1e-12f);
  float b[NB];
  sh_bases<DEG>(div(dx, len), div(dy, len), div(dz, len), b);
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < NB; ++k) s[k % 4] = add(s[k % 4], mul(b[k], c[k * 3 + ch]));
    out[ch] = add(add(add(s[0], s[1]), s[2]), s[3]);
  }
}

}  // namespace proj
}  // namespace gs
