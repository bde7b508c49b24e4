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
//
// Early reject.  Most evaluated pairs are gated (88% of the 20 G pairs of
// the 2DGS training step at 4k), and the exact path spends two IEEE
// divisions and an exp to say so.  A warp composites one 8x4 block of a
// tile's pixels at a time in both kernels, so where a kernel stages a slot
// it also computes, once for the tile, a mask of the 8 blocks in which the
// exact path certainly gates every pixel (surfel_block_mask), and a pair in
// a masked block is gated without reading the rest of the slot.  Every
// other pair takes the exact path, whose operations are those above, so
// every decision keeps its bits.  The mask reads one term per slot
// (surfel_gate):
//   g = 2 (theta + delta)(1 + s),  theta = ln(255 op),  delta = 2^-6,  s = 2^-10,
// -inf for a slot with op < (1 - 2^-16)/255 (gated at every pixel: every
// block masked), +inf for a slot with a NaN or an infinity among its 12
// rows (no block masked).
//
// Why a pair is gated once, at its pixel p, the exact path's sigma2 > g and
// its c has c_z = 0 or (c_x^2 + c_y^2)/c_z^2 > g (1 - 2^-21) (u = 2^-24, the
// unit roundoff; CUDA's documented bounds: expf within 2 ulp, logf within 1):
// 1. The exact path's sigma3 = rn(rn(su^2) + rn(sv^2)), su = rn(c_x/c_z), is
//    at least that ratio times (1-u)^4, less 2^-147 (an overflow only raises
//    it): sigma3 > g (1 - 2^-20).
// 2. So sigma = 0.5 min(sigma2, sigma3) > (g/2)(1 - 2^-20), and g's own
//    two roundings leave sigma > (theta_c + delta)(1 + 2^-11), where
//    theta_c = logf(rn(255 op)) is theta as computed: theta_c >= theta - e,
//    e = u + 2^-23 |theta| <= 2^-16 for every finite op (|theta| < 95).
// 3. Then vis = expf(-sigma) <= exp(-sigma)(1 + 2^-22) and raw = rn(op vis)
//    <= op vis (1 + u) <= exp(e - delta)(1 + 2^-21)/255 < (1 - 2^-7)/255,
//    below kAlphaThreshold = rn(1/255) >= (1 - u)/255.  raw is finite and
//    below 0.99, so alpha = raw and the pair is gated.
// 4. A slot with op < (1 - 2^-16)/255: sigma >= 0 (or NaN, gated), so vis
//    <= 1 + 2^-22 and raw < kAlphaThreshold (raw <= 0 for op <= 0).
// Steps 1 to 3 need delta above about 2^-13; delta = 2^-6 leaves a factor
// of a hundred, and the relative slack s covers g's roundings with room.
//
// The mask shows both conditions at every pixel centre p of a block with
// centre b (|p - b| <= 3.5 across, 1.5 down) in a tile whose pixel centres
// are at most P across and Q down:
// - sigma2: the exact path's sigma2 at p is at least 2 (dX^2 + dY^2)(1 - 6u),
//   dX = max(|x - b_x| - 3.5, 0), likewise dY; the mask asks
//   2 (dX^2 + dY^2) > g (1 + s), which also covers the roundings of dX, dY.
// - c: c is affine in the pixel, c(p) = p_x (v x w) + p_y (w x u) + u x v
//   in exact arithmetic (A = v x w, B = w x u, C = u x v as computed), so
//   |c(p) - c(b)| <= 3.5 a + 1.5 b per component, with a = |v1 w2| + |v2 w1|
//   and b, k alike bounding |A|, |B|, |C|.  c'(b) = fma(b_x, A, fma(b_y, B,
//   C)) is within 4.03u (P a + Q b + k) of the exact-arithmetic c(b); the
//   exact path's rounded c at p is within 6.1u S of its exact-arithmetic
//   value, S = Hu1 Hv2 + Hu2 Hv1 (and its rotations) with Hu = P|w| + |u|,
//   Hv = Q|w| + |v| bounding |h_u|, |h_v|.  The mask takes the envelope
//   e = 2^-19 (P a + Q b + k + S) per component, three times what those two
//   need, so that the roundings of the bounds below fall inside it too:
//   l_x = max(|c'_x| - (3.5 a_x + 1.5 b_x + e_x), 0) <= |c_x(p)| (1 + u),
//   l_y alike, h_z = |c'_z| + 3.5 a_z + 1.5 b_z + e_z >= |c_z(p)| (1 - u) for
//   the exact path's own c at every p of the block.  Then L = l_x^2 + l_y^2
//   > Q = g h_z^2 >= 2^-100, each product and sum rounded alone (with Q >=
//   2^-100 a subnormal product rounds by at most 2^-150, below 2^-48 of Q),
//   gives (c_x^2 + c_y^2)/c_z^2 > g (1 - 8u) at every p (or c_z = 0 there).
// A NaN fails every comparison; an overflow to infinity in L passes only
// where Q is finite, which bounds c_z.  A pair near the margin of the gate
// takes the exact path: it costs only the time that every pair took before
// the reject.  (A second, per-pair form of the same test on the exact path's
// own c and sigma2, before the divisions, was measured on the 2DGS step and
// saved nothing once the masks gate a block: PERF.md.)

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

// The 8x4 pixel blocks of a tile, two across and four down: block b has
// pixels x in [8 (b & 1), 8 (b & 1) + 8), y in [4 (b >> 1), 4 (b >> 1) + 4).
constexpr int kBlocks = 8;

// The reject's constants (see the top of this file).
constexpr float kGateMargin = 0x1p-6f;          // delta
constexpr float kGateSlack = 1.0f + 0x1p-10f;   // 1 + s
constexpr float kGateFloor = 0x1p-100f;         // the least Q the mask reads
constexpr float kOpDead = kAlphaThreshold * (1.0f - 0x1p-16f);  // gated at every pixel
constexpr float kFloatMax = 3.40282347e38f;
constexpr float kBlockEnvelope = 0x1p-19f;  // e's factor

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

// The slot's gate term g from its 12 response rows at slot[r * stride].
__device__ __forceinline__ float surfel_gate(const float* slot, int stride) {
  bool finite = true;
#pragma unroll
  for (int r = 0; r <= kRowOp; ++r) finite = finite && fabsf(slot[r * stride]) <= kFloatMax;
  const float op = slot[kRowOp * stride];
  if (!finite) return INFINITY;     // the exact path decides every pair
  if (op < kOpDead) return -INFINITY;  // gated at every pixel
  const float theta = logf(__fmul_rn(255.0f, op));
  return __fmul_rn(__fmul_rn(2.0f, __fadd_rn(theta, kGateMargin)), kGateSlack);
}

// The blocks of the tile with top-left pixel (x0, y0) in which the slot
// whose 12 response rows sit at slot[r * stride], with gate term g, is
// certainly gated at every pixel: bit b for block b.
__device__ __forceinline__ unsigned surfel_block_mask(const float* slot, int stride, float g,
                                                      float x0, float y0) {
  if (g == -INFINITY) return (1u << kBlocks) - 1u;
  float u[3], v[3], w[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    u[k] = slot[(kRowU + k) * stride];
    v[k] = slot[(kRowV + k) * stride];
    w[k] = slot[(kRowW + k) * stride];
  }
  const float P = x0 + 15.5f, Q = y0 + 15.5f;  // the tile's far pixel centre
  float A[3], B[3], C[3], reach[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int i1 = (i + 1) % 3, i2 = (i + 2) % 3;
    A[i] = __fsub_rn(__fmul_rn(v[i1], w[i2]), __fmul_rn(v[i2], w[i1]));
    B[i] = __fsub_rn(__fmul_rn(w[i1], u[i2]), __fmul_rn(w[i2], u[i1]));
    C[i] = __fsub_rn(__fmul_rn(u[i1], v[i2]), __fmul_rn(u[i2], v[i1]));
    const float a = fabsf(v[i1] * w[i2]) + fabsf(v[i2] * w[i1]);
    const float b = fabsf(w[i1] * u[i2]) + fabsf(w[i2] * u[i1]);
    const float k = fabsf(u[i1] * v[i2]) + fabsf(u[i2] * v[i1]);
    const float S = (P * fabsf(w[i1]) + fabsf(u[i1])) * (Q * fabsf(w[i2]) + fabsf(v[i2])) +
                    (P * fabsf(w[i2]) + fabsf(u[i2])) * (Q * fabsf(w[i1]) + fabsf(v[i1]));
    const float e = kBlockEnvelope * (P * a + Q * b + k + S);
    reach[i] = __fadd_rn(__fadd_rn(3.5f * a, 1.5f * b), e);
  }
  const float X = slot[kRowX * stride], Y = slot[kRowY * stride];
  const float g2 = g * kGateSlack;
  unsigned mask = 0;
#pragma unroll
  for (int blk = 0; blk < kBlocks; ++blk) {
    const float bx = x0 + (float)(8 * (blk & 1) + 4), by = y0 + (float)(4 * (blk >> 1) + 2);
    float c[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) c[i] = __fmaf_rn(bx, A[i], __fmaf_rn(by, B[i], C[i]));
    const float lx = fmaxf(__fsub_rn(fabsf(c[0]), reach[0]), 0.0f);
    const float ly = fmaxf(__fsub_rn(fabsf(c[1]), reach[1]), 0.0f);
    const float hz = __fadd_rn(fabsf(c[2]), reach[2]);
    const float l = __fadd_rn(__fmul_rn(lx, lx), __fmul_rn(ly, ly));
    const float q = __fmul_rn(g, __fmul_rn(hz, hz));
    const float dX = fmaxf(__fsub_rn(fabsf(__fsub_rn(X, bx)), 3.5f), 0.0f);
    const float dY = fmaxf(__fsub_rn(fabsf(__fsub_rn(Y, by)), 1.5f), 0.0f);
    const float s2 = __fmul_rn(2.0f, __fadd_rn(__fmul_rn(dX, dX), __fmul_rn(dY, dY)));
    if ((s2 > g2) & (q >= kGateFloor) & (l > q)) mask |= 1u << blk;
  }
  return mask;
}

// The exact path: the pair's response at the pixel (px, py) of the slot
// whose row r sits at slot[r * stride], and whether it passes the gate.
__device__ __forceinline__ bool surfel_passes_gate(float px, float py, const float* slot,
                                                   int stride, Surfel& s) {
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
  return s.alpha >= kAlphaThreshold;
}

// Evaluate the slot whose field f sits at slot[f * stride] at the pixel
// (px, py) with transmittance T by the exact path.  Returns true if the
// pair would take T to <= 1e-4: the pixel stops for good and this surfel is
// excluded.  Otherwise returns false, after calling `on_live(surfel,
// next_T)` if the pair contributes and nothing if it is gated (the shape of
// composite.cuh).
template <class OnLive>
__device__ __forceinline__ bool composite_surfel(float px, float py, const float* slot,
                                                 int stride, float T, OnLive&& on_live) {
  Surfel s;
  if (!surfel_passes_gate(px, py, slot, stride, s)) return false;  // gated
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
