// 2DGS surfel forward composite (K6a) for Hopper.
//
// Replaces gsplat_tpu/ops/rasterize2d_pallas.py:_fwd_kernel (:92, wrapper
// _fwd_call_2dgs :476).  One CTA of 128 threads per 16x16 tile, two pixels a
// thread (one in each half of the tile), each warp's 32 lanes on an 8x4
// block of pixels as in the backward (rasterize2d_bwd.cu).  The CTA walks its
// tile's span of the (tile, depth)-sorted slot stream in batches of 256
// slots: the threads stage the batch into shared memory, then every thread
// composites it serially, front to back, for each of its pixels; the CTA
// leaves once every pixel has stopped (__syncthreads_count).
//
// Per pixel it writes out[I, H, W, D+5] = (D colour channels with depth
// last, 3 normal components, distortion, median depth), T_final [I, H, W]
// and the median slot [I, H, W] as an int32 sorted position (-1: none).
// The JAX kernel keeps that slot in float32, which rounds above 2^24
// positions; an integer cannot.  Distortion is 2*sum_i w_i (m_i A_i - B_i)
// with m the depth channel and A_i, B_i the exclusive running sums of w and
// w*m (the oracle's cumsum(w) - w, rasterize2d_ref.py:120); the median is
// m at the last contributing surfel whose entry T is above 0.5.
//
// Numeric contract: csrc/surfel.cuh decides gate and stop, shared with the
// backward.  Every sum here is a serial float32 sum in slot order with each
// product and add rounded on its own, as the plain version
// (ops/rasterize2d_kernel.py:rasterize2d_fwd_plain) computes it, so the two
// agree bit for bit.  The pixel stops for good (the oracle's rule); the JAX
// Pallas kernel can resume it in a later 128-slot chunk.
//
// What bounds it on the H100: operations.  Each evaluated (pixel, slot)
// pair costs ~45 f32 operations on the exact path (two 3-vectors, a cross
// product, two divisions, the filter, an exp), a live pair 2(D+3) + 9 more,
// against 15+D floats per slot read once per tile.  Most pairs are gated
// (88% at 4k), so the design spends least on them (surfel.cuh's early
// reject, which moves no decision):
// - as a slot is staged, one thread computes its mask of the tile's 8
//   blocks in which every pixel is certainly gated; a warp reads the mask
//   (one broadcast load) and skips the slot for a pixel in a masked block;
//   every other pair takes the exact path;
// - a slot's 12 response rows are one record of three float4s, read by a
//   thread once for both its pixels; colours and normals, read by live
//   pairs only, stay one row per field;
// - the per-pair state stays in registers (at most six CTAs an SM for
//   D <= 8) and the CTA leaves early with its last pixel.
//
// COUNT instantiates the per-tile counts of contributing pairs (the
// backward's live pairs must equal them), of evaluated pairs (the work
// yardstick, masked pairs included), of pairs that took the exact path (the
// work behind the bound), and of masked pairs that the exact path, run on
// them too, would not have gated (must be 0); without it the kernel carries
// no counter.

#include <cuda_runtime.h>
#include <stdint.h>

#include "surfel.cuh"

namespace {

constexpr int kPix = 2;  // pixels per thread, one in each half of the tile
constexpr int kThreads = gs2d::kTile * gs2d::kTile / kPix;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 256;  // slots staged per batch
constexpr int kRec = 3;      // float4s of a staged record: the 12 response rows
// CTAs an SM the registers are held to: six for a few channels (on an H100
// at the 2DGS step's D = 4: 25.4 ms against 27.0 with the 96 registers the
// compiler takes unbounded, PERF.md), unbounded for more
template <int D>
constexpr int kMinBlocks = D <= 8 ? 6 : 1;
static_assert(4 * kRec == gs2d::kRowColor, "a record holds the response rows");

template <int D, bool COUNT>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
rasterize2d_fwd_kernel(const float* __restrict__ fields, long long P,
                       const int* __restrict__ bounds, int tiles_w, int tiles_per_image,
                       int width, int height, float* __restrict__ out,
                       float* __restrict__ out_t, int* __restrict__ med_slot_out,
                       int* __restrict__ pair_counts, int* __restrict__ eval_counts,
                       int* __restrict__ exact_counts, int* __restrict__ unsound_counts) {
  extern __shared__ float4 smem[];
  // record q of slot j at rec[q * kBatch + j]: its rows 4q to 4q+3
  float4* rec = smem;
  unsigned* masks = reinterpret_cast<unsigned*>(smem + kRec * kBatch);  // [kBatch] block masks
  float* chan = reinterpret_cast<float*>(masks + kBatch);  // [D + 3][kBatch]
  constexpr int C = D + 3;  // colours, then normals
  constexpr int kTile = gs2d::kTile;
  const int t = blockIdx.x;
  const int tr = threadIdx.x;
  const int lane = tr & 31;
  const int warp = tr >> 5;

  const int im = t / tiles_per_image;
  const int tl = t - im * tiles_per_image;
  const int ty = tl / tiles_w;
  const int tx = tl - ty * tiles_w;

  // warp w takes the 8x4 pixel blocks w + kWarps * k of the tile (blocks
  // two across, four down: gs2d::kBlocks), lane l pixel (l % 8, l / 8) of each
  int x[kPix], y[kPix];
  float px[kPix], py[kPix], T[kPix];
  bool inside[kPix], done[kPix];
  float acc[kPix][C], dist[kPix], A[kPix], B[kPix], med[kPix];
  int med_slot[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int block = warp + kWarps * k;
    x[k] = tx * kTile + (block & 1) * 8 + (lane & 7);
    y[k] = ty * kTile + (block >> 1) * 4 + (lane >> 3);
    px[k] = (float)x[k] + 0.5f;
    py[k] = (float)y[k] + 0.5f;
    inside[k] = x[k] < width && y[k] < height;
    done[k] = !inside[k];
    T[k] = inside[k] ? 1.0f : 0.0f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[k][c] = 0.0f;
    dist[k] = A[k] = B[k] = med[k] = 0.0f;
    med_slot[k] = -1;
  }
  // contributing, evaluated, exact-path and unsound pairs (COUNT only)
  int kept = 0, evaluated = 0, exact = 0, unsound = 0;

  const int start = bounds[t];
  const int end = bounds[t + 1];
  const int n_batches = (end - start + kBatch - 1) / kBatch;
  for (int batch = 0; batch < n_batches; ++batch) {
    bool mine_done = true;
#pragma unroll
    for (int k = 0; k < kPix; ++k) mine_done = mine_done && done[k];
    if (__syncthreads_count(mine_done) == kThreads) break;
    const int base = start + batch * kBatch;
    for (int j = tr; j < kBatch && base + j < end; j += kThreads) {
      const long long idx = base + j;
      float r[kRec * 4];
#pragma unroll
      for (int f = 0; f <= gs2d::kRowOp; ++f) r[f] = fields[f * P + idx];
      masks[j] = gs2d::surfel_block_mask(r, 1, gs2d::surfel_gate(r, 1), (float)(tx * kTile),
                                         (float)(ty * kTile));
#pragma unroll
      for (int q = 0; q < kRec; ++q)
        rec[q * kBatch + j] = make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
#pragma unroll
      for (int c = 0; c < C; ++c) chan[c * kBatch + j] = fields[(gs2d::kRowColor + c) * P + idx];
    }
    __syncthreads();
    const int n = min(kBatch, end - base);
    for (int j = 0; j < n && !mine_done; ++j) {
      // the block mask first; the record only for a pixel whose block the
      // mask leaves to the exact path
      const unsigned mask = masks[j];
      bool masked[kPix], need = COUNT;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        masked[k] = (mask >> (warp + kWarps * k)) & 1u;
        need = need || !(done[k] || masked[k]);
        if (COUNT && !done[k]) ++evaluated;
      }
      if (!need) continue;  // every pair gated by the mask
      float r[kRec * 4];  // the slot's record, read once for the thread's pixels
#pragma unroll
      for (int q = 0; q < kRec; ++q) {
        const float4 v = rec[q * kBatch + j];
        r[4 * q] = v.x;
        r[4 * q + 1] = v.y;
        r[4 * q + 2] = v.z;
        r[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (done[k]) continue;
        if (masked[k]) {
          if (COUNT) {
            gs2d::Surfel s;
            unsound += gs2d::surfel_passes_gate(px[k], py[k], r, 1, s);
          }
          continue;
        }
        if (COUNT) ++exact;
        done[k] = gs2d::composite_surfel(
            px[k], py[k], r, 1, T[k],
            [&](const gs2d::Surfel& s, float next_T) {
              const float w = __fmul_rn(s.alpha, T[k]);
#pragma unroll
              for (int c = 0; c < C; ++c)
                acc[k][c] = __fadd_rn(acc[k][c], __fmul_rn(w, chan[c * kBatch + j]));
              const float m = chan[(D - 1) * kBatch + j];
              dist[k] = __fadd_rn(dist[k], __fmul_rn(__fmul_rn(2.0f, w),
                                                     __fsub_rn(__fmul_rn(m, A[k]), B[k])));
              A[k] = __fadd_rn(A[k], w);
              B[k] = __fadd_rn(B[k], __fmul_rn(w, m));
              if (T[k] > 0.5f) {
                med[k] = m;
                med_slot[k] = base + j;
              }
              T[k] = next_T;
              if (COUNT) ++kept;
            });
      }
      mine_done = true;
#pragma unroll
      for (int k = 0; k < kPix; ++k) mine_done = mine_done && done[k];
    }
    __syncthreads();
  }

#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    if (!inside[k]) continue;
    const long long pix = ((long long)im * height + y[k]) * width + x[k];
    float* o = out + pix * (D + 5);
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = acc[k][c];
    o[D + 3] = dist[k];
    o[D + 4] = med[k];
    out_t[pix] = T[k];
    med_slot_out[pix] = med_slot[k];
  }
  if (COUNT) {
    const int total = gs2d::cta_count(kept);
    const int total_eval = gs2d::cta_count(evaluated);
    const int total_exact = gs2d::cta_count(exact);
    const int total_unsound = gs2d::cta_count(unsound);
    if (tr == 0) {
      pair_counts[t] = total;
      eval_counts[t] = total_eval;
      exact_counts[t] = total_exact;
      unsound_counts[t] = total_unsound;
    }
  }
}

template <int D, bool COUNT>
int launch(const float* fields, long long P, const int* bounds, int tiles_w,
           int tiles_per_image, int width, int height, int n_tiles, float* out, float* out_t,
           int* med_slot, int* pair_counts, int* eval_counts, int* exact_counts,
           int* unsound_counts, cudaStream_t stream) {
  const size_t smem = sizeof(float4) * kRec * kBatch + sizeof(unsigned) * kBatch +
                      sizeof(float) * (D + 3) * kBatch;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rasterize2d_fwd_kernel<D, COUNT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rasterize2d_fwd_kernel<D, COUNT><<<n_tiles, kThreads, smem, stream>>>(
      fields, P, bounds, tiles_w, tiles_per_image, width, height, out, out_t, med_slot,
      pair_counts, eval_counts, exact_counts, unsound_counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// fields [15+D, P] f32 sorted slot rows, bounds [n_tiles+1] i32 tile spans ->
// out [I, H, W, D+5] f32, out_t [I, H, W] f32, med_slot [I, H, W] i32 and,
// unless pair_counts is null, [n_tiles] i32 per tile: pair_counts, the
// contributing (pixel, slot) pairs; eval_counts, the evaluated ones;
// exact_counts, those that took the exact path; unsound_counts, those the
// block masks gated that the exact path would not have (all four non-null
// together).  Tile 16; D in [1, 32].
int gs_rasterize2d_fwd(const float* fields, long long P, const int* bounds, int D,
                       int tiles_w, int tiles_per_image, int width, int height, int n_tiles,
                       float* out, float* out_t, int* med_slot, int* pair_counts,
                       int* eval_counts, int* exact_counts, int* unsound_counts,
                       cudaStream_t stream) {
  if (n_tiles == 0) return (int)cudaGetLastError();
  switch (D) {
#define GS_CASE(d) \
  case d:          \
    return pair_counts != nullptr \
        ? launch<d, true>(fields, P, bounds, tiles_w, tiles_per_image, width, height, n_tiles, out, out_t, med_slot, pair_counts, eval_counts, exact_counts, unsound_counts, stream) \
        : launch<d, false>(fields, P, bounds, tiles_w, tiles_per_image, width, height, n_tiles, out, out_t, med_slot, pair_counts, eval_counts, exact_counts, unsound_counts, stream);
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
