// The projection and SH colours for Hopper: sanitise, project, cull and
// shade every (camera, gaussian) in one pass.
//
// Replaces no Pallas kernel: the JAX package leaves the projection and the
// SH evaluation to XLA, which fuses their elementwise graph.  In the port
// the same graph ran as ~400 PyTorch operations a request, each reading and
// writing whole [C, N] tensors (with the stacks of the rotation, the
// covariance, the conics and the [N, 16, 3] SH products in device memory),
// 50 to 200 times the bytes the function needs.  This kernel serves the
// route that needs no gradient (rendering.py: the serving path, the
// viewer, no-grad evaluation renders and capacity sizing) and the forward
// of the training route, whose backward is projection_bwd.cu.
//
// Numeric contract: csrc/projection.cuh, the plain route operation for
// operation, so the radii, means2d, depths, conics and opacities equal the
// plain version's (ops/projection_kernel.py:project_shade_plain) bit for bit;
// the colours, whose sums follow PyTorch's order too, are held to 1e-5.
//
// What bounds it on the H100: bytes.  Each gaussian's mean (f32), quaternion,
// scales and opacity (f32 or bf16, widened in registers, which is exact) are
// read once per camera, each output written once (radii int32 x 2, means2d,
// depth, conic, colour and opacity: 48 bytes), and the SH coefficients
// (192 bytes at degree 3 in f32) are read only for the rows that survive
// the culls: 28 + 48 + 192 x (visible share) bytes a row.  The arithmetic,
// ~250 rounded operations, a log, a reciprocal square root and a few
// divides and square roots a row, is far below the card's rate.
//
// Design.  One thread per (camera, gaussian): the gaussian's index runs
// along x, the camera along y, so C cameras cost C passes over the
// gaussians with no extra code.  A block's first thread works out its
// camera's constants (the frustum limits, the camera centre) once, in
// shared memory.  Every row is projected (the plain route computes means2d,
// depths and conics for culled rows too); only a visible row reads its
// coefficients, each thread its own row as 16-byte vector loads where the
// row allows them (its length and the base are multiples of 16 bytes),
// scalar loads otherwise.  On an H100 at the serving shape (2,794,625
// gaussians, 64 to 79% visible, 3840x2160) that took 0.210 to 0.235 ms
// against a bytes bound of 0.166 to 0.189 ms, where staging each warp's
// visible rows through shared memory, coalesced, took 0.266 to 0.297 ms
// (PERF.md): a thread's 192 bytes lie in two or three lines that its own
// loads fill in a row, so the staging adds a shared-memory round trip and a
// warp barrier for no fewer sectors.  128 threads a block ran 3% faster
// than 256 (each resident block holds the same 512 threads at the
// degree-3 kernel's 104 registers, in smaller units).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "projection.cuh"

namespace {

using namespace gs::proj;

constexpr int kThreads = 128;

// bits of Args::bf16: which inputs are bfloat16 (the others float32)
constexpr int kMeansBf16 = 1, kQuatsBf16 = 2, kScalesBf16 = 4, kOpacBf16 = 8, kCoeffsBf16 = 16;

struct Args {
  const void* means;   // [N, 3]
  const void* quats;   // [N, 4]
  const void* scales;  // [N, 3]
  const void* opac;    // [N]
  const void* coeffs;  // [N, K, 3] SH coefficients, or null
  const float* viewmats;  // [C, 4, 4]
  const float* Ks;        // [C, 3, 3]
  long long N;
  int K;           // coefficient rows a gaussian
  int bf16;        // k*Bf16 bits
  int vec;         // coefficient rows load as 16-byte vectors
  int width, height;
  float eps2d, near_plane, far_plane, radius_clip;
  int antialiased;
  int* radii;      // [C, N, 2]
  float* means2d;  // [C, N, 2]
  float* depths;   // [C, N]
  float* conics;   // [C, N, 3]
  float* op;       // [C, N]
  float* feats;    // [C, N, 3], or null
};

__device__ __forceinline__ float ld(const void* p, long long i, bool bf16) {
  return bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
              : reinterpret_cast<const float*>(p)[i];
}

// The first NF coefficients of row n, widened to float32.  Vector loads
// read up to the next 16-byte boundary, which the row's length allows.
template <int NF>
__device__ __forceinline__ void load_coeffs(const Args& a, long long n, float* c) {
  const bool bf16 = a.bf16 & kCoeffsBf16;
  const long long base = n * a.K * 3;
  if (a.vec && !bf16) {
    const float4* p =
        reinterpret_cast<const float4*>(reinterpret_cast<const float*>(a.coeffs) + base);
#pragma unroll
    for (int v = 0; v < (NF + 3) / 4; ++v) {
      const float4 q = p[v];
      const float w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (4 * v + u < NF) c[4 * v + u] = w[u];
    }
  } else if (a.vec) {
    const uint4* p = reinterpret_cast<const uint4*>(
        reinterpret_cast<const __nv_bfloat16*>(a.coeffs) + base);
#pragma unroll
    for (int v = 0; v < (NF + 7) / 8; ++v) {
      const uint4 q = p[v];
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (8 * v + u < NF)
          c[8 * v + u] = __uint_as_float(u & 1 ? w[u / 2] & 0xffff0000u : w[u / 2] << 16);
    }
  } else {
#pragma unroll
    for (int j = 0; j < NF; ++j) c[j] = ld(a.coeffs, base + j, bf16);
  }
}

// DEG: the SH degree of the colours, -1 for no colours
template <int DEG>
__global__ void __launch_bounds__(kThreads) project_shade_kernel(const Args a) {
  __shared__ Camera cam;
  const int ci = blockIdx.y;
  if (threadIdx.x == 0)
    cam = load_camera(a.viewmats + 16 * ci, a.Ks + 9 * ci, a.width, a.height);
  __syncthreads();
  const long long n = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (n >= a.N) return;

  float m[3], q[4], s[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    m[i] = ld(a.means, 3 * n + i, a.bf16 & kMeansBf16);
    s[i] = ld(a.scales, 3 * n + i, a.bf16 & kScalesBf16);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = ld(a.quats, 4 * n + i, a.bf16 & kQuatsBf16);
  const Gaussian g = sanitize(m, q, s, ld(a.opac, n, a.bf16 & kOpacBf16));
  const Projected p = project(cam, g, a.eps2d, a.near_plane, a.far_plane, a.radius_clip,
                              a.antialiased, a.width, a.height);

  const long long o = (long long)ci * a.N + n;
  reinterpret_cast<int2*>(a.radii)[o] = make_int2(p.rx, p.ry);
  reinterpret_cast<float2*>(a.means2d)[o] = make_float2(p.m2x, p.m2y);
  a.depths[o] = p.depth;
  a.conics[3 * o] = p.ca;
  a.conics[3 * o + 1] = p.cb;
  a.conics[3 * o + 2] = p.cc;
  a.op[o] = p.op;
  if constexpr (DEG >= 0) {
    // culled rows: zero colour, as the plain route's mask; then +0.5, >= 0
    float col[3] = {0.0f, 0.0f, 0.0f};
    if (p.rx > 0 && p.ry > 0) {
      constexpr int NF = 3 * (DEG + 1) * (DEG + 1);
      float c[NF];
      load_coeffs<NF>(a, n, c);
      sh_color<DEG>(cam, g.m, c, col);
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) a.feats[3 * o + ch] = nan_max(add(col[ch], 0.5f), 0.0f);
  }
}

}  // namespace

extern "C" {

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// means [N, 3], quats [N, 4], scales [N, 3], opacities [N] (float32 or
// bfloat16 each, by the bits of `bf16`), coeffs [N, K, 3] or null,
// viewmats [C, 4, 4] and Ks [C, 3, 3] float32 -> radii [C, N, 2] int32,
// means2d [C, N, 2], depths [C, N], conics [C, N, 3], op [C, N] and, with
// coeffs, feats [C, N, 3] (SH degree `sh_degree` in [0, 4], +0.5, >= 0).
int gs_project_shade(const void* means, const void* quats, const void* scales, const void* opac,
                     const void* coeffs, const float* viewmats, const float* Ks, long long N,
                     int C, int K, int sh_degree, int bf16, int vec, int width, int height,
                     float eps2d, float near_plane, float far_plane, float radius_clip,
                     int antialiased, int* radii, float* means2d, float* depths, float* conics,
                     float* op, float* feats, cudaStream_t stream) {
  if (N == 0 || C == 0) return (int)cudaGetLastError();
  const Args a{means, quats, scales, opac, coeffs, viewmats, Ks, N, K, bf16, vec, width, height,
               eps2d, near_plane, far_plane, radius_clip, antialiased, radii, means2d, depths,
               conics, op, feats};
  const dim3 grid((unsigned)((N + kThreads - 1) / kThreads), (unsigned)C);
  switch (coeffs ? sh_degree : -1) {
    case -1: project_shade_kernel<-1><<<grid, kThreads, 0, stream>>>(a); break;
    case 0: project_shade_kernel<0><<<grid, kThreads, 0, stream>>>(a); break;
    case 1: project_shade_kernel<1><<<grid, kThreads, 0, stream>>>(a); break;
    case 2: project_shade_kernel<2><<<grid, kThreads, 0, stream>>>(a); break;
    case 3: project_shade_kernel<3><<<grid, kThreads, 0, stream>>>(a); break;
    case 4: project_shade_kernel<4><<<grid, kThreads, 0, stream>>>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
