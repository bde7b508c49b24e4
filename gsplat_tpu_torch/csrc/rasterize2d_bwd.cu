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
// What bounds it on the H100: operations.  Each evaluated pair costs the
// forward's ~45 operations again (csrc/surfel.cuh: two IEEE divisions and an
// exp among them); a live pair ~70 + 3(D+3) more for its gradient terms and
// one add into each of its 15+D per-slot sums.  Measured on the 2DGS step
// (PERF.md): the replay alone takes what K6a takes, and the gradient chain
// of the live pairs, with ~5 of a warp's 32 lanes live, most of the rest.
//
// Design.  One CTA per 16x16 tile; each thread owns kPix pixels, one in each
// half of the tile, so that part of each per-slot sum is taken in registers,
// and a warp's 32 lanes cover an 8x4 block of pixels in each half, where a
// surfel's edge leaves fewer lanes idle than in a 16x2 strip.  The tile's
// span is walked in batches of kBatch slots, staged into shared memory with
// cp.async and double-buffered: the next batch's rows are in flight while
// this one is evaluated.  For each slot a thread reads the 12 fields of the
// response once, then replays each of its pixels through
// gs2d::composite_surfel, exactly as the forward (rasterize2d_fwd.cu)
// decides gate and stop, and adds each live pixel's terms into its own 15+D
// partial sums.  A warp with a live lane then reduces those 15+D values
// across its lanes by recursive halving (a reduce-scatter: ceil(F/2) +
// ceil(F/4) + ... shuffles, 21 for F = 19, where one shuffle tree per value
// took 5F), which leaves each row's warp sum on one lane; that lane writes
// it to shared memory.  At the batch's end one thread per (row, slot) adds
// the warps' sums in warp order and writes the row, coalesced.  Every sum
// has a fixed order, so the result is the same bits from run to run.
//
// The 3D response's gradient reaches the ray transform's rows u, v, w
// through h_u = px w - u and h_v = py w - v, which are linear in the pixel:
// a pair adds only v_c, lx v_c and ly v_c (lx, ly its pixel's offsets in
// the tile) to three per-slot sums, and the batch's end turns those into the
// rows u, v, w with the slot's own u, v, w, once per slot (see the pass
// there).  The gradient chain, which decides nothing, takes one approximate
// reciprocal 1/(1-alpha) per live pair (one MUFU instruction, about an ulp),
// and one of c_z more on the 3D branch, where the plain version divides
// three times.  The registers are held to what six CTAs of an SM can have,
// at the cost of some spills: with the 141 registers the compiler takes
// unbounded, the kernel runs a fifth slower (PERF.md, Findings).
//
// A warp whose pixels have all stopped skips the batch; the CTA leaves once
// all its pixels have, writing zeros over the rest of its span.  The CTAs
// also write the zeros of the slots outside every span, so the wrapper
// allocates the output without clearing it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "surfel.cuh"

namespace {

constexpr int kPix = 2;  // pixels per thread, one in each half of the tile
constexpr int kThreads = gs2d::kTile * gs2d::kTile / kPix;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 64;           // slots staged per batch: one live bit each
constexpr int kPStride = kBatch + 1;  // a warp-sum row in shared memory, padded
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kGeo = gs2d::kRowColor;  // the response's fields: x, y, u, v, w, opacity

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 1/x to about an ulp, one MUFU instruction: the gradient chain's
// reciprocals (decisions never read them)
__device__ __forceinline__ float fast_rcp(float x) {
  float r;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
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

// The rows a lane holds after ReduceScatter<N, 16>: its values v[i], i < *n,
// are the warp sums of rows *first + i.
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

template <int D>
__global__ void __launch_bounds__(kThreads, 6)
rasterize2d_bwd_kernel(const float* __restrict__ fields, long long P,
                       const int* __restrict__ bounds, int n_tiles, int tiles_w,
                       int tiles_per_image, int width, int height,
                       const float* __restrict__ v_pix, const float* __restrict__ v_t,
                       const float* __restrict__ pix_out, const float* __restrict__ t_final,
                       const int* __restrict__ med_slot_in, float* __restrict__ v_slot,
                       int* __restrict__ live_counts) {
  constexpr int F = 15 + D;
  constexpr int C = D + 3;  // channels composited like colours: colours, normals
  constexpr int kTile = gs2d::kTile;
  extern __shared__ float smem[];
  float* stage = smem;                                 // [2][F][kBatch]
  float* partial = stage + 2 * F * kBatch;             // [kWarps][F][kPStride]
  unsigned long long* live_bits = (unsigned long long*)(partial + kWarps * F * kPStride);
  float* tot = (float*)(live_bits + kWarps);            // [9][kBatch]: S1, Sx, Sy

  const int t = blockIdx.x;
  const int tr = threadIdx.x;
  const int lane = tr & 31;
  const int warp = tr >> 5;

  const int im = t / tiles_per_image;
  const int tl = t - im * tiles_per_image;
  const int ty = tl / tiles_w;
  const int tx = tl - ty * tiles_w;
  // warp w takes the 8x4 pixel blocks w + kWarps * k of the tile (blocks
  // two across, four down), lane l pixel (l % 8, l / 8) of each
  const int lane_x = lane & 7, lane_y = lane >> 3;

  // per pixel: the replay's state, the cotangents and the forward's outputs
  bool done[kPix];
  float T[kPix], px[kPix], py[kPix], lx[kPix], ly[kPix], vch[kPix][C];
  float dtot[kPix], vt_term[kPix], v_dist[kPix], v_med[kPix];
  float sw_tot[kPix], sm_tot[kPix], gww_tot[kPix];
  float E[kPix], aw[kPix], bw[kPix], gww[kPix];  // prefix carries
  int med_slot[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int block = warp + kWarps * k;
    const int x = tx * kTile + (block & 1) * 8 + lane_x;
    const int y = ty * kTile + (block >> 1) * 4 + lane_y;
    const bool inside = x < width && y < height;
    px[k] = (float)x + 0.5f;
    py[k] = (float)y + 0.5f;
    lx[k] = (float)(x - tx * kTile);
    ly[k] = (float)(y - ty * kTile);
    T[k] = inside ? 1.0f : 0.0f;
    dtot[k] = vt_term[k] = v_dist[k] = v_med[k] = 0.0f;
    sw_tot[k] = sm_tot[k] = gww_tot[k] = 0.0f;
    E[k] = aw[k] = bw[k] = gww[k] = 0.0f;
    med_slot[k] = -1;
#pragma unroll
    for (int c = 0; c < C; ++c) vch[k][c] = 0.0f;
    if (inside) {
      const long long pix = ((long long)im * height + y) * width + x;
      const float* vp = v_pix + pix * (D + 5);
      const float* po = pix_out + pix * (D + 5);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        vch[k][c] = vp[c];
        dtot[k] += vch[k][c] * po[c];
      }
      v_dist[k] = vp[D + 3];
      v_med[k] = vp[D + 4];
      const float tf = t_final[pix];
      vt_term[k] = v_t[pix] * tf;
      sw_tot[k] = 1.0f - tf;                    // total contributing weight
      sm_tot[k] = po[D - 1];                    // sum of w * depth
      gww_tot[k] = 2.0f * v_dist[k] * po[D + 3];  // sum_i gw_i w_i = 2 v_dist distort
      med_slot[k] = med_slot_in[pix];
    }
    done[k] = !inside;
  }
  int n_live = 0;
  int held_first = 0, held_n = F;
  held_rows<F, 16>(lane, &held_first, &held_n);

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
        float geo[kGeo];  // the response's fields, read once for all kPix pixels
#pragma unroll
        for (int r = 0; r < kGeo; ++r) geo[r] = st[r * kBatch + j];
        float acc[F];
#pragma unroll
        for (int r = 0; r < F; ++r) acc[r] = 0.0f;
        bool live = false;
#pragma unroll
        for (int k = 0; k < kPix; ++k) {
          if (done[k]) continue;
          const bool stop = gs2d::composite_surfel(
              px[k], py[k], geo, 1, T[k], [&](const gs2d::Surfel& s, float next_T) {
                live = true;
                ++n_live;
                const float Tk = T[k];
                const float w = s.alpha * Tk;
                float ch[C];
                float d = 0.0f;
#pragma unroll
                for (int c = 0; c < C; ++c) {
                  ch[c] = st[(gs2d::kRowColor + c) * kBatch + j];
                  d += vch[k][c] * ch[c];
                }
                E[k] += w * d;
                const float ra = fast_rcp(1.0f - s.alpha);  // alpha <= 0.99
                float v_alpha = d * Tk - (dtot[k] - E[k]) * ra - vt_term[k] * ra;
                // distortion: m is the depth channel
                const float m = ch[D - 1];
                const float A = aw[k], B = bw[k];
                aw[k] += w;
                bw[k] += w * m;
                const float sw_suf = sw_tot[k] - aw[k];
                const float sm_suf = sm_tot[k] - bw[k];
                const float gw = 2.0f * v_dist[k] * ((m * A - B) + sm_suf - m * sw_suf);
                gww[k] += gw * w;
                v_alpha += gw * Tk - (gww_tot[k] - gww[k]) * ra;
                float v_m = 2.0f * v_dist[k] * w * (A - sw_suf);
                if (base + j == med_slot[k]) v_m += v_med[k];
#pragma unroll
                for (int c = 0; c < C; ++c) acc[gs2d::kRowColor + c] += vch[k][c] * w;
                acc[gs2d::kRowColor + D - 1] += v_m;
                if (!s.clamped) {
                  const float v_sigma = -s.alpha * v_alpha;
                  acc[gs2d::kRowOp] += s.vis * v_alpha;
                  if (s.use2d) {
                    // sigma = dx^2 + dy^2 with dx = mean - pixel
                    acc[gs2d::kRowX] += 2.0f * v_sigma * s.dx;
                    acc[gs2d::kRowY] += 2.0f * v_sigma * s.dy;
                  } else {
                    // sigma = 0.5 (cx^2 + cy^2) / cz^2
                    const float rz = fast_rcp(s.cz);
                    const float v_cx = v_sigma * (s.cx * rz) * rz;
                    const float v_cy = v_sigma * (s.cy * rz) * rz;
                    const float v_cz = -v_sigma * s.sigma3 * rz;
                    // rows u, v, w hold S1, Sx, Sy until the batch's end
                    const float v_c[3] = {v_cx, v_cy, v_cz};
#pragma unroll
                    for (int i = 0; i < 3; ++i) {
                      acc[gs2d::kRowU + i] += v_c[i];
                      acc[gs2d::kRowV + i] += lx[k] * v_c[i];
                      acc[gs2d::kRowW + i] += ly[k] * v_c[i];
                    }
                  }
                }
                T[k] = next_T;
              });
          done[k] = done[k] || stop;
        }
        if (__ballot_sync(kFullMask, live) == 0) continue;
        warp_live |= 1ull << j;
        ReduceScatter<F, 16>::run(acc, lane);
        float* out = partial + ((size_t)warp * F + held_first) * kPStride + j;
#pragma unroll
        for (int i = 0; i < held(F); ++i)
          if (i < held_n) out[i * kPStride] = acc[i];
      }
    }
    if (lane == 0) live_bits[warp] = warp_live;
    __syncthreads();

    // the warps' sums, added in warp order, one output element a thread;
    // the 3D response's sums S1, Sx, Sy kept for the pass below
    for (int o = tr; o < F * kBatch; o += kThreads) {
      const int f = o / kBatch;
      const int j = o - f * kBatch;
      if (j >= n) continue;
      float sum = 0.0f;
#pragma unroll
      for (int wi = 0; wi < kWarps; ++wi) {
        if ((live_bits[wi] >> j) & 1ull) sum += partial[((size_t)wi * F + f) * kPStride + j];
      }
      if (f >= gs2d::kRowU && f < gs2d::kRowOp) tot[(f - gs2d::kRowU) * kBatch + j] = sum;
      else v_slot[f * P + base + j] = sum;
    }
    __syncthreads();
    // rows u, v, w of each slot from S1 = sum v_c, Sx = sum lx v_c, Sy = sum ly v_c
    // over the pixels (px = x0 + lx, py = y0 + ly): with hu0 = x0 w - u and
    // hv0 = y0 w - v, sum v_hu = hv0 x S1 + w x Sy, sum v_hv = S1 x hu0 + Sx x w,
    // sum v_w = x0 sum v_hu + y0 sum v_hv + hv0 x Sx + Sy x hu0
    for (int j = tr; j < n; j += kThreads) {
      const float x0 = (float)(tx * kTile) + 0.5f, y0 = (float)(ty * kTile) + 0.5f;
      float u[3], v[3], w[3], S1[3], Sx[3], Sy[3], hu0[3], hv0[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        u[i] = st[(gs2d::kRowU + i) * kBatch + j];
        v[i] = st[(gs2d::kRowV + i) * kBatch + j];
        w[i] = st[(gs2d::kRowW + i) * kBatch + j];
        S1[i] = tot[i * kBatch + j];
        Sx[i] = tot[(3 + i) * kBatch + j];
        Sy[i] = tot[(6 + i) * kBatch + j];
        hu0[i] = x0 * w[i] - u[i];
        hv0[i] = y0 * w[i] - v[i];
      }
      auto cross = [](const float* a, const float* b, int i) {
        const int i1 = (i + 1) % 3, i2 = (i + 2) % 3;
        return a[i1] * b[i2] - a[i2] * b[i1];
      };
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float vhu = cross(hv0, S1, i) + cross(w, Sy, i);
        const float vhv = cross(S1, hu0, i) + cross(Sx, w, i);
        const float vw = x0 * vhu + y0 * vhv + cross(hv0, Sx, i) + cross(Sy, hu0, i);
        v_slot[(gs2d::kRowU + i) * P + base + j] = -vhu;
        v_slot[(gs2d::kRowV + i) * P + base + j] = -vhv;
        v_slot[(gs2d::kRowW + i) * P + base + j] = vw;
      }
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
  const size_t smem = sizeof(float) * F * (2 * kBatch + kWarps * kPStride) +
                      sizeof(unsigned long long) * kWarps + sizeof(float) * 9 * kBatch;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rasterize2d_bwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rasterize2d_bwd_kernel<D><<<n_tiles, kThreads, smem, stream>>>(
      fields, P, bounds, n_tiles, tiles_w, tiles_per_image, width, height, v_pix, v_t,
      pix_out, t_final, med_slot, v_slot, live_counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// fields [15+D, P] f32 sorted slot rows, bounds [n_tiles+1] i32 tile spans,
// v_pix and pix_out [I, H, W, D+5] f32, v_t and t_final [I, H, W] f32,
// med_slot [I, H, W] i32 -> v_slot [15+D, P] f32 (every element written:
// zeros where no live pair reaches) and, unless null, live_counts [n_tiles]
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
