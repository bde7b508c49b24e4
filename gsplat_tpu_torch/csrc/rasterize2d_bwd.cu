// 2DGS surfel composite backward (K6b) for Hopper.
//
// Replaces gsplat_tpu/ops/rasterize2d_pallas.py:_bwd_kernel (:213, wrapper
// _bwd_call_2dgs :521).  What it computes, per pixel p and live slot i of
// p's tile, front to back, with w_i = alpha_i T_i, the channel cotangents
// v_ch (D colours and 3 normals), d_i = v_ch . ch_i, Dtot = v_ch . out_p and
// E_i = sum_{j<=i} w_j d_j:
//   v_alpha = d_i T_i - (Dtot - E_i)/(1-alpha_i) - v_T T_final/(1-alpha_i)
// plus the distortion chain (rasterize2d_pallas.py:324-337): with m the
// depth channel, A_i, B_i the exclusive sums of w and w*m, the suffix sums
// sw_suf = (1 - T_final) - sum_{j<=i} w_j and sm_suf = out_depth -
// sum_{j<=i} w_j m_j telescoped from the forward's outputs,
//   gw_i = 2 v_dist ((m_i A_i - B_i) + sm_suf - m_i sw_suf),
//   v_alpha += gw_i T_i - (2 v_dist distort - sum_{j<=i} gw_j w_j)/(1-alpha_i),
// and the depth channel's own term 2 v_dist w_i (A_i - sw_suf) plus
// v_median on the pixel's median slot (an int32 sorted position).  Then
// v_sigma = -alpha v_alpha and v_op = exp(-sigma) v_alpha where alpha was not
// clamped; the 2D filter branch gives the mean's gradient, the 3D branch the
// ray transform's through the cross-product transposes v_hu = h_v x v_c,
// v_hv = v_c x h_u (:355-395).  Per slot, summed over the tile's pixels, the
// gradients of the 15+D field rows, at the sorted positions: every slot
// belongs to one tile, so no two CTAs write one element and nothing is
// accumulated with atomics.
//
// Shape (K2, rasterize_bwd.cu): one CTA per 16x16 tile, one thread per
// pixel, batches of 32 slots staged in shared memory, each thread replaying
// its own pixel forward through csrc/surfel.cuh so that it decides gate and
// stop as the forward did.  For each slot the per-pixel terms are reduced in
// a fixed order: a shuffle tree inside each warp, the warps' partials to
// shared memory, then one pass adding the warps in index order and writing
// the batch's rows, coalesced.  Dead warps skip; once every pixel has
// stopped the CTA leaves, and the rest of its span keeps the wrapper's
// zeros.  The result is bit-identical from run to run.
//
// What bounds it on the H100: operations.  Each evaluated pair costs the
// forward's ~45 operations again; a live pair ~70 + 3(D+3) more for its
// gradient terms and one add into each of its 15+D per-slot sums.  The
// shuffle tree (5 shuffle-adds per value and lane) is the kernel's own cost.

#include <cuda_runtime.h>
#include <stdint.h>

#include "surfel.cuh"

namespace {

constexpr int kThreads = gs2d::kTile * gs2d::kTile;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 32;  // staged slots per batch: one live bit each
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFullMask, v, off);
  return v;  // lane 0 holds the sum
}

template <int D>
__global__ void __launch_bounds__(kThreads)
rasterize2d_bwd_kernel(const float* __restrict__ fields, long long P,
                       const int* __restrict__ bounds, int tiles_w, int tiles_per_image,
                       int width, int height, const float* __restrict__ v_pix,
                       const float* __restrict__ v_t, const float* __restrict__ pix_out,
                       const float* __restrict__ t_final, const int* __restrict__ med_slot_in,
                       float* __restrict__ v_slot, int* __restrict__ live_counts) {
  constexpr int F = 15 + D;
  constexpr int C = D + 3;  // channels composited like colours: colours, normals
  constexpr int kTile = gs2d::kTile;
  extern __shared__ float smem[];
  float* stage = smem;                                   // [F][kBatch]
  float* partial = smem + F * kBatch;                    // [kWarps][F][kBatch]
  unsigned* live_bits = (unsigned*)(partial + kWarps * F * kBatch);  // [kWarps]

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
  const float px = (float)x + 0.5f;
  const float py = (float)y + 0.5f;
  const bool inside = x < width && y < height;

  bool done = !inside;
  float T = inside ? 1.0f : 0.0f;
  float vch[C];
#pragma unroll
  for (int k = 0; k < C; ++k) vch[k] = 0.0f;
  float dtot = 0.0f, vt_term = 0.0f, v_dist = 0.0f, v_med = 0.0f;
  float sw_tot = 0.0f, sm_tot = 0.0f, gww_tot = 0.0f;
  int med_slot = -1;
  if (inside) {
    const long long pix = ((long long)im * height + y) * width + x;
    const float* vp = v_pix + pix * (D + 5);
    const float* po = pix_out + pix * (D + 5);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      vch[k] = vp[k];
      dtot += vch[k] * po[k];
    }
    v_dist = vp[D + 3];
    v_med = vp[D + 4];
    const float tf = t_final[pix];
    vt_term = v_t[pix] * tf;
    sw_tot = 1.0f - tf;           // total contributing weight
    sm_tot = po[D - 1];           // sum of w * depth
    gww_tot = 2.0f * v_dist * po[D + 3];  // sum_i gw_i w_i = 2 v_dist distort
    med_slot = med_slot_in[pix];
  }
  float E = 0.0f, aw = 0.0f, bw = 0.0f, gww = 0.0f;  // prefix carries
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
      float w = 0.0f, v_m = 0.0f, v_op = 0.0f, v_mx = 0.0f, v_my = 0.0f;
      float v_u[3] = {0.0f, 0.0f, 0.0f}, v_v[3] = {0.0f, 0.0f, 0.0f},
            v_w[3] = {0.0f, 0.0f, 0.0f};
      if (!done) {
        done = gs2d::composite_surfel(
            px, py, stage + j, kBatch, T, [&](const gs2d::Surfel& s, float next_T) {
              live = true;
              ++n_live;
              w = s.alpha * T;
              float d = 0.0f;
#pragma unroll
              for (int k = 0; k < C; ++k) d += vch[k] * stage[(gs2d::kRowColor + k) * kBatch + j];
              E += w * d;
              const float ra = 1.0f / (1.0f - s.alpha);  // alpha <= 0.99
              float v_alpha = d * T - (dtot - E) * ra - vt_term * ra;
              // distortion: m is the depth channel
              const float m = stage[(gs2d::kRowColor + D - 1) * kBatch + j];
              const float A = aw, B = bw;
              aw += w;
              bw += w * m;
              const float sw_suf = sw_tot - aw;
              const float sm_suf = sm_tot - bw;
              const float gw = 2.0f * v_dist * ((m * A - B) + sm_suf - m * sw_suf);
              gww += gw * w;
              v_alpha += gw * T - (gww_tot - gww) * ra;
              v_m = 2.0f * v_dist * w * (A - sw_suf);
              if (base + j == med_slot) v_m += v_med;
              if (!s.clamped) {
                const float v_sigma = -s.alpha * v_alpha;
                v_op = s.vis * v_alpha;
                if (s.use2d) {
                  // sigma = dx^2 + dy^2 with dx = mean - pixel
                  v_mx = 2.0f * v_sigma * s.dx;
                  v_my = 2.0f * v_sigma * s.dy;
                } else {
                  // sigma = 0.5 (cx^2 + cy^2) / cz^2
                  const float inv_cz2 = 1.0f / (s.cz * s.cz);
                  const float v_cx = v_sigma * s.cx * inv_cz2;
                  const float v_cy = v_sigma * s.cy * inv_cz2;
                  const float v_cz = -v_sigma * s.sigma3 / s.cz;
                  const float v_hu[3] = {s.hv[1] * v_cz - s.hv[2] * v_cy,
                                         s.hv[2] * v_cx - s.hv[0] * v_cz,
                                         s.hv[0] * v_cy - s.hv[1] * v_cx};
                  const float v_hv[3] = {v_cy * s.hu[2] - v_cz * s.hu[1],
                                         v_cz * s.hu[0] - v_cx * s.hu[2],
                                         v_cx * s.hu[1] - v_cy * s.hu[0]};
#pragma unroll
                  for (int k = 0; k < 3; ++k) {
                    v_u[k] = -v_hu[k];
                    v_v[k] = -v_hv[k];
                    v_w[k] = px * v_hu[k] + py * v_hv[k];
                  }
                }
              }
              T = next_T;
            });
      }
      if (__ballot_sync(kFullMask, live) == 0) continue;
      warp_live |= 1u << j;
      float* out = partial + (size_t)warp * F * kBatch + j;
      const float r0 = warp_sum(v_mx);
      const float r1 = warp_sum(v_my);
      if (lane == 0) {
        out[gs2d::kRowX * kBatch] = r0;
        out[gs2d::kRowY * kBatch] = r1;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float su = warp_sum(v_u[k]);
        const float sv = warp_sum(v_v[k]);
        const float sw = warp_sum(v_w[k]);
        if (lane == 0) {
          out[(gs2d::kRowU + k) * kBatch] = su;
          out[(gs2d::kRowV + k) * kBatch] = sv;
          out[(gs2d::kRowW + k) * kBatch] = sw;
        }
      }
      const float sop = warp_sum(v_op);
      if (lane == 0) out[gs2d::kRowOp * kBatch] = sop;
#pragma unroll
      for (int k = 0; k < C; ++k) {
        const float v = warp_sum(vch[k] * w + (k == D - 1 ? v_m : 0.0f));
        if (lane == 0) out[(gs2d::kRowColor + k) * kBatch] = v;
      }
    }
    if (lane == 0) live_bits[warp] = warp_live;
    __syncthreads();

    // the warps' partials, added in warp order, one output element a thread
    for (int o = tr; o < F * kBatch; o += kThreads) {
      const int f = o / kBatch;
      const int j = o - f * kBatch;
      if (j >= n) continue;
      float sum = 0.0f;
      for (int wi = 0; wi < kWarps; ++wi) {
        if ((live_bits[wi] >> j) & 1u) sum += partial[((size_t)wi * F + f) * kBatch + j];
      }
      v_slot[f * P + base + j] = sum;
    }
  }

  if (live_counts != nullptr) {
    const int total = gs2d::cta_count(n_live);
    if (tr == 0) live_counts[t] = total;
  }
}

template <int D>
int launch(const float* fields, long long P, const int* bounds, int tiles_w,
           int tiles_per_image, int width, int height, int n_tiles, const float* v_pix,
           const float* v_t, const float* pix_out, const float* t_final, const int* med_slot,
           float* v_slot, int* live_counts, cudaStream_t stream) {
  constexpr int F = 15 + D;
  const size_t smem = sizeof(float) * F * kBatch * (1 + kWarps) + sizeof(unsigned) * kWarps;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rasterize2d_bwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rasterize2d_bwd_kernel<D><<<n_tiles, kThreads, smem, stream>>>(
      fields, P, bounds, tiles_w, tiles_per_image, width, height, v_pix, v_t, pix_out,
      t_final, med_slot, v_slot, live_counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// fields [15+D, P] f32 sorted slot rows, bounds [n_tiles+1] i32 tile spans,
// v_pix and pix_out [I, H, W, D+5] f32, v_t and t_final [I, H, W] f32,
// med_slot [I, H, W] i32 -> v_slot [15+D, P] f32 (zeroed by the caller;
// slots no CTA reaches stay zero) and, unless null, live_counts [n_tiles]
// i32: the live (pixel, slot) pairs of each tile.  Tile 16; D in [1, 32].
int gs_rasterize2d_bwd(const float* fields, long long P, const int* bounds, int D,
                       int tiles_w, int tiles_per_image, int width, int height, int n_tiles,
                       const float* v_pix, const float* v_t, const float* pix_out,
                       const float* t_final, const int* med_slot, float* v_slot,
                       int* live_counts, cudaStream_t stream) {
  if (n_tiles == 0) return (int)cudaGetLastError();
  switch (D) {
#define GS_CASE(d) \
  case d:          \
    return launch<d>(fields, P, bounds, tiles_w, tiles_per_image, width, height, n_tiles, v_pix, v_t, pix_out, t_final, med_slot, v_slot, live_counts, stream);
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
