// The backward of the training route's projection and SH colours for Hopper:
// one pass replays and differentiates sanitise, project and shade for each
// gaussian over every camera.
//
// Replaces no Pallas kernel: the JAX package differentiates the projection
// and the SH evaluation with XLA's autodiff (gsplat_tpu/rendering.py,
// gsplat_tpu/ops/projection.py, gsplat_tpu/ops/sh.py).  In the port the same
// backward ran as PyTorch's autograd over the differentiable route's ~200
// elementwise operations and stacks, each reading and writing whole [C, N]
// tensors, and kept dozens of [C, N] intermediates from the forward alive
// for it.  This kernel serves rendering.py's training route, whose forward
// is the one projection pass (projection_fwd.cu); the autograd Function
// that joins them is ops/projection_kernel.py:project_shade_grad.
//
// Numeric contract: the gradients that PyTorch's autograd gives through the
// plain route (ops/projection_kernel.py:project_shade_bwd_plain), with
// PyTorch's conventions at clamps, ties, the camera plane, sanitised and
// culled rows (csrc/projection.cuh).  Each gaussian's forward is replayed
// by the same functions as the forward pass, so every mask decides as
// there; the sums are float32 in another order than autograd's, so the
// gradients agree to a relative tolerance, not bit for bit.  Coefficient
// rows past (sh_degree + 1)^2 get zero.
//
// What bounds it on the H100: bytes.  A gaussian's 11 float32 fields and
// each camera's cotangents (10 floats) and radii (2 ints) are read once,
// the (sh_degree + 1)^2 x 3 coefficients once if any camera keeps the
// gaussian, and each gradient is written once: at SH degree 3 and one
// camera, 44 + 48 + 192 x (kept share) bytes read and 44 + 192 written a
// gaussian, 0.39 ms at 3.35 TB/s for 2,794,625 gaussians of which 70% are
// kept.  The arithmetic, ~1,000 operations a (camera, gaussian) with the
// replay, needs a tenth of that time at the card's float32 rate.
//
// Design.  One thread per gaussian loops over the C cameras: every
// gradient of the gaussian is summed in registers (the mean's 3, the world
// covariance's 6, the opacity's) or in its own coefficient row, so each is
// written by one thread, once a camera at most, with no atomics and the
// same order in every run.  Only a (camera, gaussian) that the forward kept
// (radii > 0) replays its SH colour, and reads the cotangent of it; the
// coefficient row is read when the first camera keeps the gaussian, kept in
// registers over the cameras, and its gradient row is written by the first
// camera and added to by the others, as 16-byte vectors where the row
// allows them.  The world covariance and its rotation are made once a
// gaussian, before the camera loop; each camera's constants come from its
// 25 floats, the same for a whole warp, which the L1 cache broadcasts.

#include <cuda_runtime.h>
#include <stdint.h>

#include "projection.cuh"

namespace {

using namespace gs::proj;

constexpr int kThreads = 128;

struct Args {
  const float* means;     // [N, 3]
  const float* quats;     // [N, 4]
  const float* scales;    // [N, 3]
  const float* opac;      // [N]
  const float* coeffs;    // [N, K, 3] SH coefficients, or null
  const float* viewmats;  // [C, 4, 4]
  const float* Ks;        // [C, 3, 3]
  const int* radii;       // [C, N, 2], the forward's
  // the cotangents of the forward's outputs; null reads as zero
  const float* v_means2d;  // [C, N, 2]
  const float* v_depths;   // [C, N]
  const float* v_conics;   // [C, N, 3]
  const float* v_op;       // [C, N]
  const float* v_feats;    // [C, N, 3]
  long long N;
  int C;
  int K;    // coefficient rows a gaussian
  int vec;  // coefficient rows load and store as 16-byte vectors
  int width, height;
  float eps2d;
  int antialiased;
  float* g_means;   // [N, 3]
  float* g_quats;   // [N, 4]
  float* g_scales;  // [N, 3]
  float* g_opac;    // [N]
  float* g_coeffs;  // [N, K, 3], or null
};

__device__ __forceinline__ float cot(const float* p, long long i) { return p ? p[i] : 0.0f; }

// The first NF coefficients of row n.  Vector loads read up to the next
// 16-byte boundary, which the row's length allows.
template <int NF>
__device__ __forceinline__ void load_coeffs(const Args& a, long long n, float* c) {
  const float* row = a.coeffs + n * a.K * 3;
  if (a.vec) {
    const float4* p = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int v = 0; v < (NF + 3) / 4; ++v) {
      const float4 q = p[v];
      const float w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * v + u < NF) c[4 * v + u] = w[u];
    }
  } else {
#pragma unroll
    for (int j = 0; j < NF; ++j) c[j] = row[j];
  }
}

// Writes (the first camera) or adds (a later one) b[k] * v_col[ch] to
// entry (k, ch) of row n of the coefficients' gradient, for the NB bases
// that the degree uses; the first camera writes the rest of the row as
// zeros.  A row that is not `live` adds nothing.
template <int DEG>
__device__ __forceinline__ void store_coeff_grads(const Args& a, long long n, bool first,
                                                  bool live, const float* b,
                                                  const float v_col[3]) {
  constexpr int NF = 3 * (DEG + 1) * (DEG + 1);
  if (!first && !live) return;
  float* row = a.g_coeffs + n * a.K * 3;
  auto val = [&](int j) { return live ? b[j / 3] * v_col[j % 3] : 0.0f; };
  int j0 = 0;
  if (a.vec) {
    float4* p = reinterpret_cast<float4*>(row);
#pragma unroll
    for (int v = 0; v < NF / 4; ++v) {
      float4 w = make_float4(val(4 * v), val(4 * v + 1), val(4 * v + 2), val(4 * v + 3));
      if (!first) {
        const float4 o = p[v];
        w = make_float4(o.x + w.x, o.y + w.y, o.z + w.z, o.w + w.w);
      }
      p[v] = w;
    }
    j0 = NF / 4 * 4;
  }
#pragma unroll
  for (int j = 0; j < NF; ++j)
    if (j >= j0) row[j] = first ? val(j) : row[j] + val(j);
  if (first)
    for (int j = NF; j < 3 * a.K; ++j) row[j] = 0.0f;
}

// The gradients of gaussian n.  DEG: the SH degree of the colours, -1 for
// no colours.
template <int DEG>
__device__ __forceinline__ void project_shade_vjp(const Args& a, long long n) {
  constexpr int NF = DEG >= 0 ? 3 * (DEG + 1) * (DEG + 1) : 1;
  float m[3], q[4], s[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    m[i] = a.means[3 * n + i];
    s[i] = a.scales[3 * n + i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = a.quats[4 * n + i];
  const Gaussian g = sanitize(m, q, s, a.opac[n]);
  float v_m[3] = {0.0f, 0.0f, 0.0f}, v_q[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float v_s[3] = {0.0f, 0.0f, 0.0f}, v_opac = 0.0f;
  if (g.ok) {
    const Covar cv = world_covar(g);
    float c[NF];
    bool loaded = false;  // the coefficients, read when a camera first keeps the row
    float H[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int ci = 0; ci < a.C; ++ci) {
      const Camera cam = load_camera(a.viewmats + 16 * ci, a.Ks + 9 * ci, a.width, a.height);
      const long long o = (long long)ci * a.N + n;
      const Persp pp = persp(cam, g.m, cv.S);
      const Conic k = blur(pp, a.eps2d, a.antialiased);
      ProjectedGrad v;
      v.m2x = cot(a.v_means2d, 2 * o);
      v.m2y = cot(a.v_means2d, 2 * o + 1);
      v.depth = cot(a.v_depths, o);
      v.ca = cot(a.v_conics, 3 * o);
      v.cb = cot(a.v_conics, 3 * o + 1);
      v.cc = cot(a.v_conics, 3 * o + 2);
      v.op = cot(a.v_op, o);
      float v_t[3], v_cs[6];
      project_vjp(cam, pp, k, g.op, a.antialiased, v, v_t, v_cs, v_opac);
      to_world(cam, v_t, v_cs, v_m, H);
      if constexpr (DEG >= 0) {
        // the colour: masked where the forward culled the row, then +0.5
        // clamped at 0, whose gradient passes at and above the floor
        const bool live = a.radii[2 * o] > 0 && a.radii[2 * o + 1] > 0 && a.v_feats;
        constexpr int NB = (DEG + 1) * (DEG + 1);
        float b[NB], v_col[3] = {0.0f, 0.0f, 0.0f};
        if (live) {
          if (!loaded) load_coeffs<NF>(a, n, c);
          loaded = true;
          const ShDir sd = sh_dir(cam, g.m);
          sh_bases<DEG>(sd.dn[0], sd.dn[1], sd.dn[2], b);
          float col[3];
          sh_sum<DEG>(b, c, col);
#pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            v_col[ch] = add(col[ch], 0.5f) >= 0.0f ? a.v_feats[3 * o + ch] : 0.0f;
          sh_dir_vjp<DEG>(sd, c, b, v_col, v_m);
        }
        store_coeff_grads<DEG>(a, n, ci == 0, live, b, v_col);
      }
    }
    covar_vjp(g, cv, H, v_q, v_s);
  } else if constexpr (DEG >= 0) {
    // a sanitised row: no gradient at all
    store_coeff_grads<DEG>(a, n, true, false, nullptr, nullptr);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    a.g_means[3 * n + i] = v_m[i];
    a.g_scales[3 * n + i] = v_s[i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) a.g_quats[4 * n + i] = v_q[i];
  a.g_opac[n] = v_opac;
}

template <int DEG>
__global__ void __launch_bounds__(kThreads) project_shade_bwd_kernel(const Args a) {
  const long long n = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (n < a.N) project_shade_vjp<DEG>(a, n);
}

}  // namespace

extern "C" {

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// means [N, 3], quats [N, 4], scales [N, 3], opacities [N], coeffs [N, K, 3]
// or null, viewmats [C, 4, 4], Ks [C, 3, 3] float32, the forward's radii
// [C, N, 2] int32 and the cotangents of means2d [C, N, 2], depths [C, N],
// conics [C, N, 3], opacities [C, N] and colours [C, N, 3] (each float32, or
// null for zero) -> the gradients of means, quats, scales, opacities and,
// with coeffs, coeffs (rows past (sh_degree + 1)^2 zero).  C > 0.
int gs_project_shade_bwd(const float* means, const float* quats, const float* scales,
                         const float* opac, const float* coeffs, const float* viewmats,
                         const float* Ks, const int* radii, const float* v_means2d,
                         const float* v_depths, const float* v_conics, const float* v_op,
                         const float* v_feats, long long N, int C, int K, int sh_degree, int vec,
                         int width, int height, float eps2d, int antialiased, float* g_means,
                         float* g_quats, float* g_scales, float* g_opac, float* g_coeffs,
                         cudaStream_t stream) {
  if (N == 0) return (int)cudaGetLastError();
  if (C <= 0) return (int)cudaErrorInvalidValue;
  const Args a{means,   quats,     scales,   opac,     coeffs,      viewmats, Ks,
               radii,   v_means2d, v_depths, v_conics, v_op,        v_feats,  N,
               C,       K,         vec,      width,    height,      eps2d,    antialiased,
               g_means, g_quats,   g_scales, g_opac,   g_coeffs};
  const unsigned grid = (unsigned)((N + kThreads - 1) / kThreads);
  switch (coeffs ? sh_degree : -1) {
    case -1: project_shade_bwd_kernel<-1><<<grid, kThreads, 0, stream>>>(a); break;
    case 0: project_shade_bwd_kernel<0><<<grid, kThreads, 0, stream>>>(a); break;
    case 1: project_shade_bwd_kernel<1><<<grid, kThreads, 0, stream>>>(a); break;
    case 2: project_shade_bwd_kernel<2><<<grid, kThreads, 0, stream>>>(a); break;
    case 3: project_shade_bwd_kernel<3><<<grid, kThreads, 0, stream>>>(a); break;
    case 4: project_shade_bwd_kernel<4><<<grid, kThreads, 0, stream>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
