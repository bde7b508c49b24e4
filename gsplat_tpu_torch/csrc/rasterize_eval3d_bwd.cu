// eval3d composite backward (K7b) for Hopper.
//
// Replaces gsplat_tpu/ops/rasterize_eval3d_pallas.py:_bwd_kernel (:232,
// wrapper _bwd_call_eval3d :570).  What it computes, per pixel p and live
// slot i of p's tile, front to back, with w_i = alpha_i T_i, the channel
// cotangents v_ch, d_i = v_ch . value_i (colours, the hit distance, the
// flipped normals), Dtot = v_ch . out_p and E_i = sum_{j<=i} w_j d_j
// (:356-364):
//   v_alpha = d_i T_i - (Dtot - E_i)/(1-alpha_i) - v_T T_final/(1-alpha_i),
// then v_sigma = -alpha v_alpha and v_op = exp(-sigma) v_alpha where alpha
// was not clamped; v_c = v_sigma c; through c = u^ x g, v_u^ = g x v_c and
// v_g = v_c x u^; the hit distance hd = hit_t |s u^| adds v_hd = w v_hit
// (:391-403); hit_t = -(u^ . g) and the normalization of u give v_u (:405-
// 414).  Per slot, summed over the tile's pixels: S = sum v_g, then
// v_x = -M^T S and v_M[k][j] = sum (v_u_k d_j + v_g_k (o_j - x_j)), v_op,
// the colour rows sum v_ch_k w (the input hit channel's row is exactly 0,
// :441-445), the scale rows sum v_b u^ and the normal rows sum v_n w sgn.
// Per pixel, summed over its live slots, the ray gradients v_o = M^T v_g
// and v_d = M^T v_u.  A slot behind a pixel's stop gets nothing from it.
// v_M sums v_g_k (o_j - x_j) per pair, where the JAX kernel sums v_g_k o_j
// and subtracts x_j S_k after (:423-428): the same value, without the
// cancellation of two large sums when the ray's origin is far from x.
//
// What bounds it on the H100: operations.  Each evaluated pair costs the
// forward's ~70 operations again; a live pair ~120 + 2 D more for its
// gradient terms and one add into each of its F per-slot sums.
//
// Design (K2's and K6b's: csrc/rasterize_bwd.cu, csrc/rasterize2d_bwd.cu).
// One CTA per 16x16 tile; each thread owns kPix pixels, one in each of kPix
// of the tile's eight 8x4 blocks, so a slot's fields are read from shared
// memory once per thread into registers for all its pixels, and much of
// each per-slot sum is taken in registers before any exchange.  The tile's
// span is walked in batches of kBatch slots, staged with cp.async and
// double-buffered: the next batch's rows are in flight while this one is
// replayed.  For each slot a thread replays each of its pixels that has not
// stopped through csrc/ray3d.cuh, exactly as the forward (K7a) decides gate
// and stop, and adds each live pixel's terms into its own partial sums; a
// warp with a live lane then reduces them across its lanes by recursive
// halving (a reduce-scatter: ceil(N/2) + ceil(N/4) + ... shuffles, 23 for
// 3DGUT's 22 sums, where one 5-step tree per sum took 110), which leaves
// each sum on one lane, which writes it to shared memory.  At the batch's
// end one thread per (row, slot) adds the warps' sums in warp order, forms
// v_x from S, and writes the row, coalesced.  Every sum has a fixed order,
// so two runs give the same bits.  The per-pair terms round each operation
// alone, in the plain version's order (see `mul`: K2's approximate
// reciprocal and contracted chain left the ray gradients of saturating
// pixels 1e-5 of their largest entry off).  A warp whose pixels have all
// stopped skips the batch; the CTA leaves once all its pixels have, writing
// zeros over the rest of its span.  The CTAs also write the zeros
// of the slots outside every span, so the wrapper allocates the output
// without clearing it.
//
// The partial sums live in registers, so their count is a template
// constant: colour channels come in buckets (C >= the channels read
// from colour rows), and the hit distance and the normals are template
// flags.  On an H100 at 3DGUT's shape two pixels a thread took 24.5 ms and
// four 26.4 (PERF.md), and holding two to 128 registers, so that an SM
// holds four CTAs (16 warps) where it held three, 22.2 (kMinBlocks).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray3d.cuh"


namespace {

constexpr int kTile = gs3d::kTile;
constexpr int kPix = 2;  // pixels per thread, one in each of kPix 8x4 blocks
// CTAs an SM must hold at up to three colour channels, so at most 128
// registers a thread (more channels need more and would spill)
constexpr int kMinBlocks = 4;
constexpr int kThreads = kTile * kTile / kPix;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 64;            // slots staged per batch: one live bit each
constexpr int kPStride = kBatch + 1;  // a warp-sum row in shared memory, padded
constexpr unsigned kFullMask = 0xffffffffu;
static_assert(kTile == 16 && kWarps * kPix == 8, "eight 8x4 blocks per 16x16 tile");

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Every operation of a pair's gradient terms is rounded alone (no fused
// multiply-add), in the order of the plain version, so that the two give the
// same per-pair terms: v_alpha subtracts the prefix E from Dtot, and where a
// pixel saturates that difference is far smaller than either, so one ulp of
// either would reach the gradients magnified by 1/(1 - alpha).  Each pixel's
// ray gradients, serial sums of those terms in slot order, then equal the
// plain version's.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// out = a x b
__device__ __forceinline__ void cross(const float* a, const float* b, float* out) {
  out[0] = sub(mul(a[1], b[2]), mul(a[2], b[1]));
  out[1] = sub(mul(a[2], b[0]), mul(a[0], b[2]));
  out[2] = sub(mul(a[0], b[1]), mul(a[1], b[0]));
}

// One step of the reduce-scatter over lanes `lane ^ OFF`: of the N values a
// lane holds, the lower half stays with the lane whose OFF bit is 0 and the
// upper half with its partner, each added to the partner's copy.  The lane
// ends with ceil(N/2) values, zeros past its share.
template <int N, int OFF>
struct ReduceScatter {
  static __device__ __forceinline__ void run(float* v, int lane) {
    constexpr int H = (N + 1) / 2;
    const bool up = (lane & OFF) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float lo = v[i];
      const float hi = H + i < N ? v[H + i] : 0.0f;
      const float send = up ? lo : hi;
      v[i] = (up ? hi : lo) + __shfl_xor_sync(kFullMask, send, OFF);
    }
    ReduceScatter<H, OFF / 2>::run(v, lane);
  }
};

template <int N>
struct ReduceScatter<N, 0> {
  static __device__ __forceinline__ void run(float*, int) {}
};

// Values a lane holds after the five steps.
__host__ __device__ constexpr int held(int n) { return n <= 32 ? 1 : (n + 31) / 32; }

// The sums a lane holds after ReduceScatter<N, 16>: its values v[i],
// i < *n, are the warp sums of partial sums *first + i.
template <int N, int OFF>
__device__ __forceinline__ void held_rows(int lane, int* first, int* n) {
  if constexpr (OFF > 0) {
    constexpr int H = (N + 1) / 2;
    if (lane & OFF) {
      *first += H;
      *n = max(0, *n - H);
    } else {
      *n = min(*n, H);
    }
    held_rows<H, OFF / 2>(lane, first, n);
  }
}

// The partial sums of a slot, in registers: S (3), v_M (9), v_op, [v_b u^
// (3) with HIT], C colour sums (those past the channels read from
// colour rows stay 0), [3 normal sums with NRM].  Below kColor they are the
// field rows' own indices.
template <int C, bool HIT, bool NRM>
struct Sums {
  static constexpr int kScale = gs3d::kRowScale;
  static constexpr int kColor = gs3d::kRowScale + (HIT ? 3 : 0);
  static constexpr int kNormal = kColor + C;
  static constexpr int N = kNormal + (NRM ? 3 : 0);
};

template <int C, bool HIT, bool NRM>
__global__ void __launch_bounds__(kThreads, C <= 3 ? kMinBlocks : 1)
rasterize_eval3d_bwd_kernel(const float* __restrict__ fields, long long P,
                            const int* __restrict__ bounds, int n_tiles,
                            const float* __restrict__ rays, int D, int tiles_w,
                            int tiles_per_image, int width, int height,
                            const float* __restrict__ v_pix, const float* __restrict__ v_t,
                            const float* __restrict__ pix_out, const float* __restrict__ t_final,
                            float* __restrict__ v_slot, float* __restrict__ v_rays,
                            int* __restrict__ live_counts) {
  using L = Sums<C, HIT, NRM>;
  constexpr int NA = L::N;
  constexpr int NV = NRM ? 3 : 1;  // normal cotangents held (one unused without normals)
  const int color0 = L::kColor;    // the field rows share the sums' prefix
  const int D_mat = HIT ? D - 1 : D;  // channels read from colour rows (<= C)
  const int normal0 = color0 + D;
  const int F = normal0 + (NRM ? 3 : 0);
  const int D_out = D + (NRM ? 3 : 0);
  extern __shared__ unsigned long long smem_u64[];
  unsigned long long* live_bits = smem_u64;  // [kWarps]
  float* stage = (float*)(smem_u64 + kWarps);  // [2][F][kBatch]
  float* partial = stage + 2 * F * kBatch;     // [kWarps][NA][kPStride]

  const int t = blockIdx.x;
  const int tr = threadIdx.x;
  const int lane = tr & 31;
  const int warp = tr >> 5;
  const int im = t / tiles_per_image;
  const int tl = t - im * tiles_per_image;
  const int ty = tl / tiles_w;
  const int tx = tl - ty * tiles_w;

  // per pixel: the ray, the cotangents, the replay's state, the ray gradients
  gs3d::Ray ray[kPix];
  float vc[kPix][C], vhit[kPix], vn[kPix][NV];
  float dtot[kPix], vt_term[kPix], T[kPix], E[kPix], v_ray[kPix][6];
  bool done[kPix];
  long long pix_of[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    // warp w takes the 8x4 blocks w + kWarps * k (two across), lane l pixel
    // (l % 8, l / 8) of each
    const int block = warp + kWarps * k;
    const int x = tx * kTile + (block & 1) * 8 + (lane & 7);
    const int y = ty * kTile + (block >> 1) * 4 + (lane >> 3);
    const bool inside = x < width && y < height;
    const long long pix = ((long long)im * height + y) * width + x;
    pix_of[k] = inside ? pix : -1;
#pragma unroll
    for (int m = 0; m < 3; ++m) ray[k].o[m] = ray[k].d[m] = 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) vc[k][c] = 0.0f;
#pragma unroll
    for (int m = 0; m < NV; ++m) vn[k][m] = 0.0f;
    vhit[k] = dtot[k] = vt_term[k] = E[k] = 0.0f;
#pragma unroll
    for (int m = 0; m < 6; ++m) v_ray[k][m] = 0.0f;
    if (inside) {
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        ray[k].o[m] = rays[pix * 6 + m];
        ray[k].d[m] = rays[pix * 6 + 3 + m];
      }
      const float* vp = v_pix + pix * D_out;
      const float* po = pix_out + pix * D_out;
      // Dtot over the channels in order: colours, hit distance, normals
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (c < D_mat) {
          vc[k][c] = vp[c];
          dtot[k] = add(dtot[k], mul(vc[k][c], po[c]));
        }
      }
      if constexpr (HIT) {
        vhit[k] = vp[D - 1];
        dtot[k] = add(dtot[k], mul(vhit[k], po[D - 1]));
      }
      if constexpr (NRM) {
#pragma unroll
        for (int m = 0; m < 3; ++m) {
          vn[k][m] = vp[D + m];
          dtot[k] = add(dtot[k], mul(vn[k][m], po[D + m]));
        }
      }
      vt_term[k] = mul(v_t[pix], t_final[pix]);
    }
    done[k] = !(inside && gs3d::dir_norm2(ray[k]) > 1e-12f);
    T[k] = done[k] ? 0.0f : 1.0f;
  }
  int n_live = 0;
  int held_first = 0, held_n = NA;
  held_rows<NA, 16>(lane, &held_first, &held_n);

  const int start = bounds[t];
  const int end = bounds[t + 1];
  const int n_batches = (end - start + kBatch - 1) / kBatch;
  auto stage_batch = [&](int batch) {
    const int base = start + batch * kBatch;
    const int n = min(kBatch, end - base);
    float* dst = stage + (batch & 1) * F * kBatch;
    for (int o = tr; o < F * kBatch; o += kThreads) {
      const int f = o / kBatch;
      const int j = o - f * kBatch;
      if (j < n) cp_async4(dst + o, fields + f * P + base + j);
    }
  };
  if (n_batches > 0) stage_batch(0);
  cp_async_commit();

  int batch = 0;
  for (; batch < n_batches; ++batch) {
    bool mine_done = true;
#pragma unroll
    for (int k = 0; k < kPix; ++k) mine_done = mine_done && done[k];
    // also the barrier after which the batch before's buffers may be reused
    if (__syncthreads_count(mine_done) == kThreads) break;
    if (batch + 1 < n_batches) stage_batch(batch + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of `batch` have landed
    __syncthreads();     // and everyone's

    const int base = start + batch * kBatch;
    const int n = min(kBatch, end - base);
    const float* st = stage + (batch & 1) * F * kBatch;
    unsigned long long warp_live = 0;
    if (!__all_sync(kFullMask, mine_done)) {
      for (int j = 0; j < n; ++j) {
        float acc[NA];
#pragma unroll
        for (int r = 0; r < NA; ++r) acc[r] = 0.0f;
        bool live = false;
        bool need = false;
#pragma unroll
        for (int k = 0; k < kPix; ++k) need = need || !done[k];
        if (need) {
          // the slot's fields, read once for all kPix pixels
          float sf[gs3d::kRowScale + 3];
#pragma unroll
          for (int f = 0; f < gs3d::kRowScale + (HIT ? 3 : 0); ++f) sf[f] = st[f * kBatch + j];
          float col[C], nr[NV];
#pragma unroll
          for (int c = 0; c < C; ++c) col[c] = c < D_mat ? st[(color0 + c) * kBatch + j] : 0.0f;
#pragma unroll
          for (int m = 0; m < NV; ++m) nr[m] = NRM ? st[(normal0 + m) * kBatch + j] : 0.0f;
          auto field = [&](int f) { return sf[f]; };
#pragma unroll
          for (int k = 0; k < kPix; ++k) {
            if (done[k]) continue;
            const gs3d::Ray& r = ray[k];
            const bool stop = gs3d::composite_ray_fields(
                r, field, HIT, T[k], [&](const gs3d::Response& s, float next_T) {
                  live = true;
                  ++n_live;
                  const float Tk = T[k];
                  const float w = mul(s.alpha, Tk);
                  float d = 0.0f;
#pragma unroll
                  for (int c = 0; c < C; ++c) {
                    if (c < D_mat) {
                      d = add(d, mul(vc[k][c], col[c]));
                      acc[L::kColor + c] += mul(vc[k][c], w);
                    }
                  }
                  if constexpr (HIT) d = add(d, mul(vhit[k], s.hd));
                  float ws = w;
                  if constexpr (NRM) {
                    const float nd = gs3d::dot3(nr[0], nr[1], nr[2], r.d[0], r.d[1], r.d[2]);
                    const float sgn = nd > 0.0f ? -1.0f : 1.0f;
#pragma unroll
                    for (int m = 0; m < 3; ++m) d = add(d, mul(vn[k][m], mul(sgn, nr[m])));
                    ws = mul(w, sgn);
#pragma unroll
                    for (int m = 0; m < 3; ++m) acc[L::kNormal + m] += mul(vn[k][m], ws);
                  }
                  E[k] = add(E[k], mul(w, d));
                  const float ra = __fdiv_rn(1.0f, sub(1.0f, s.alpha));  // alpha <= 0.99
                  const float v_alpha =
                      sub(sub(mul(d, Tk), mul(sub(dtot[k], E[k]), ra)), mul(vt_term[k], ra));
                  const float v_sigma = s.clamped ? 0.0f : mul(-s.alpha, v_alpha);
                  acc[gs3d::kRowOp] += s.clamped ? 0.0f : mul(s.vis, v_alpha);
                  const float vcr[3] = {mul(v_sigma, s.c[0]), mul(v_sigma, s.c[1]),
                                        mul(v_sigma, s.c[2])};
                  // c = u^ x g: v_u^ = g x v_c, v_g = v_c x u^
                  float vuh[3], vg[3];
                  cross(s.g, vcr, vuh);
                  cross(vcr, s.uh, vg);
                  float v_hit = 0.0f;
                  if constexpr (HIT) {
                    // hd = hit_t q, q = |s u^|
                    const float v_hd = mul(w, vhit[k]);
                    v_hit = mul(v_hd, s.q);
                    const float v_q = mul(v_hd, s.hit_t);
                    const float inv_q = __fdiv_rn(1.0f, s.q);
#pragma unroll
                    for (int m = 0; m < 3; ++m) {
                      const float sk = sf[gs3d::kRowScale + m];
                      const float v_b = mul(mul(v_q, mul(sk, s.uh[m])), inv_q);
                      vuh[m] = add(vuh[m], mul(v_b, sk));
                      acc[L::kScale + m] += mul(v_b, s.uh[m]);
                    }
                  }
                  // hit_t = -(u^ . g)
#pragma unroll
                  for (int m = 0; m < 3; ++m) {
                    vuh[m] = sub(vuh[m], mul(s.g[m], v_hit));
                    vg[m] = sub(vg[m], mul(s.uh[m], v_hit));
                  }
                  // u^ = u / |u|
                  const float udotv = gs3d::dot3(s.uh[0], s.uh[1], s.uh[2], vuh[0], vuh[1], vuh[2]);
                  float vu[3];
#pragma unroll
                  for (int m = 0; m < 3; ++m) vu[m] = mul(s.inv_un, sub(vuh[m], mul(s.uh[m], udotv)));
#pragma unroll
                  for (int m = 0; m < 3; ++m) {
                    acc[gs3d::kRowX + m] += vg[m];
#pragma unroll
                    for (int jj = 0; jj < 3; ++jj)
                      acc[gs3d::kRowM + 3 * m + jj] += add(
                          mul(vu[m], r.d[jj]), mul(vg[m], sub(r.o[jj], sf[gs3d::kRowX + jj])));
                  }
                  // the pixel's ray gradients: v_o = M^T v_g, v_d = M^T v_u, each
                  // pixel's own serial sum over its live slots
#pragma unroll
                  for (int jj = 0; jj < 3; ++jj) {
                    const float m0 = sf[gs3d::kRowM + jj], m1 = sf[gs3d::kRowM + 3 + jj],
                                m2 = sf[gs3d::kRowM + 6 + jj];
                    v_ray[k][jj] = add(v_ray[k][jj], gs3d::dot3(m0, m1, m2, vg[0], vg[1], vg[2]));
                    v_ray[k][3 + jj] =
                        add(v_ray[k][3 + jj], gs3d::dot3(m0, m1, m2, vu[0], vu[1], vu[2]));
                  }
                  T[k] = next_T;
                });
            done[k] = done[k] || stop;
          }
        }
        if (__ballot_sync(kFullMask, live) == 0) continue;
        warp_live |= 1ull << j;
        ReduceScatter<NA, 16>::run(acc, lane);
        float* out = partial + ((size_t)warp * NA + held_first) * kPStride + j;
#pragma unroll
        for (int i = 0; i < held(NA); ++i)
          if (i < held_n) out[i * kPStride] = acc[i];
      }
    }
    if (lane == 0) live_bits[warp] = warp_live;
    __syncthreads();

    // the warps' sums, added in warp order, one output element a thread
    auto slot_sum = [&](int a, int j) {
      float sum = 0.0f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) {
        if ((live_bits[wi] >> j) & 1ull) sum += partial[((size_t)wi * NA + a) * kPStride + j];
      }
      return sum;
    };
    for (int o = tr; o < F * kBatch; o += kThreads) {
      const int f = o / kBatch;
      const int j = o - f * kBatch;
      if (j >= n) continue;
      float v;
      if (f < gs3d::kRowM) {  // v_x = -M^T S
        const float* m = st + gs3d::kRowM * kBatch + j;
        v = -(m[f * kBatch] * slot_sum(0, j) + m[(3 + f) * kBatch] * slot_sum(1, j) +
              m[(6 + f) * kBatch] * slot_sum(2, j));
      } else if (f < color0 + D_mat) {
        v = slot_sum(f, j);
      } else if (f >= normal0) {
        v = slot_sum(L::kNormal + f - normal0, j);
      } else {
        v = 0.0f;  // the input hit channel's row
      }
      v_slot[f * P + base + j] = v;
    }
  }
  cp_async_wait<0>();  // nothing in flight into this CTA's buffers

  // the rest of the span, which no live pair reaches, reads 0
  const int rest = start + batch * kBatch;
  for (int f = 0; f < F; ++f)
    for (int s = rest + tr; s < end; s += kThreads) v_slot[f * P + s] = 0.0f;
  // this CTA's share of the slots outside every span
  const long long lead = bounds[0];
  const long long outside = lead + (P - bounds[n_tiles]);
  const long long q_lo = outside * t / n_tiles;
  const long long q_hi = outside * (t + 1) / n_tiles;
  for (int f = 0; f < F; ++f)
    for (long long q = q_lo + tr; q < q_hi; q += kThreads)
      v_slot[f * P + (q < lead ? q : bounds[n_tiles] + (q - lead))] = 0.0f;

#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (pix_of[k] >= 0) {
#pragma unroll
      for (int m = 0; m < 6; ++m) v_rays[pix_of[k] * 6 + m] = v_ray[k][m];
    }
  }
  if (live_counts != nullptr) {
    const int total = gs3d::cta_count(n_live);
    if (tr == 0) live_counts[t] = total;
  }
}

template <int C, bool HIT, bool NRM>
int launch(const float* fields, long long P, const int* bounds, const float* rays, int D,
           int tiles_w, int tiles_per_image, int width, int height, int n_tiles,
           const float* v_pix, const float* v_t, const float* pix_out, const float* t_final,
           float* v_slot, float* v_rays, int* live_counts, cudaStream_t stream) {
  using L = Sums<C, HIT, NRM>;
  const int F = L::kColor + D + (NRM ? 3 : 0);
  const size_t smem = sizeof(unsigned long long) * kWarps +
                      sizeof(float) * (2 * F * kBatch + kWarps * L::N * kPStride);
  auto kernel = rasterize_eval3d_bwd_kernel<C, HIT, NRM>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<n_tiles, kThreads, smem, stream>>>(fields, P, bounds, n_tiles, rays, D, tiles_w,
                                              tiles_per_image, width, height, v_pix, v_t,
                                              pix_out, t_final, v_slot, v_rays, live_counts);
  return (int)cudaGetLastError();
}

template <bool HIT, bool NRM>
int launch_colors(int colors, const float* fields, long long P, const int* bounds,
                  const float* rays, int D, int tiles_w, int tiles_per_image, int width,
                  int height, int n_tiles, const float* v_pix, const float* v_t,
                  const float* pix_out, const float* t_final, float* v_slot, float* v_rays,
                  int* live_counts, cudaStream_t stream) {
#define GS_LAUNCH(c)                                                                         \
  launch<c, HIT, NRM>(fields, P, bounds, rays, D, tiles_w, tiles_per_image, width, height,   \
                      n_tiles, v_pix, v_t, pix_out, t_final, v_slot, v_rays, live_counts, \
                      stream)
  if (colors <= 1) return GS_LAUNCH(1);
  if (colors <= 3) return GS_LAUNCH(3);
  if (colors <= 8) return GS_LAUNCH(8);
  if (colors <= 16) return GS_LAUNCH(16);
  return GS_LAUNCH(32);
#undef GS_LAUNCH
}

}  // namespace

extern "C" {

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// fields [F, P] f32 sorted slot rows, bounds [n_tiles+1] i32 tile spans,
// rays [I, H, W, 6] f32, v_pix and pix_out [I, H, W, D + 3*normals] f32,
// v_t and t_final [I, H, W] f32 -> v_slot [F, P] f32 (every element
// written: zeros where no live pair reaches), v_rays [I, H, W, 6] f32
// (every pixel written) and, unless null, live_counts [n_tiles] i32: the
// live (pixel, slot) pairs of each tile.  F = 13 + 3*hit + D + 3*normals;
// tile 16; D in [1, 32].
int gs_rasterize_eval3d_bwd(const float* fields, long long P, const int* bounds,
                            const float* rays, int D, int hit, int normals, int tiles_w,
                            int tiles_per_image, int width, int height, int n_tiles,
                            const float* v_pix, const float* v_t, const float* pix_out,
                            const float* t_final, float* v_slot, float* v_rays,
                            int* live_counts, cudaStream_t stream) {
  if (n_tiles == 0) return (int)cudaGetLastError();
  if (D < 1 || D > 32) return (int)cudaErrorInvalidValue;
  const int colors = hit ? D - 1 : D;  // channels read from colour rows
#define GS_ARGS                                                                              \
  colors, fields, P, bounds, rays, D, tiles_w, tiles_per_image, width, height, n_tiles, v_pix, \
      v_t, pix_out, t_final, v_slot, v_rays, live_counts, stream
  if (hit) return normals ? launch_colors<true, true>(GS_ARGS) : launch_colors<true, false>(GS_ARGS);
  return normals ? launch_colors<false, true>(GS_ARGS) : launch_colors<false, false>(GS_ARGS);
#undef GS_ARGS
}

}  // extern "C"
