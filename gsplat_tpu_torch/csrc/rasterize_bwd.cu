// 3DGS composite backward (K2) for Hopper.
//
// Replaces gsplat_tpu/ops/rasterize_pallas.py:_bwd_kernel (:475, wrapper
// _bwd_call :882).  What it computes, per pixel p and slot i of p's tile,
// front to back, with w_i = alpha_i * T_i, d_i = sum_c v_pix[c,p] * color[c,i],
// Dtot = sum_c v_pix[c,p] * pix_out[c,p] and E_i = sum_{j<=i} w_j d_j:
//   v_alpha = d_i*T_i - (Dtot - E_i)/(1-alpha_i) - v_T*T_final/(1-alpha_i)
// on live pairs; v_sigma = -alpha*v_alpha and v_op = exp(-sigma)*v_alpha where
// alpha was not clamped at 0.99; then, summed over the tile's pixels, the
// gradients of (x, y, a, b, c) from v_sigma and (dx, dy), and
// v_color[c,i] = sum_p v_pix[c,p] * w_i(p).  The result is one row set per
// sorted slot, v_slot [6+D, P]; every slot belongs to exactly one tile, so no
// two CTAs write the same element and nothing is accumulated with atomics.
//
// Shape (upstream gsplat's RasterizeToPixels3DGSBwd.cu, with its atomics
// replaced): one CTA per tile, one thread per pixel (tile 8, 16 or 32).  The
// CTA walks its span in batches of 32 slots staged in shared memory.  Each
// thread replays its own pixel forward, T and E in registers, deciding
// "gated / stops / live" through csrc/composite.cuh exactly as the forward
// did.  For each staged slot the 6+D per-pixel terms are reduced in a fixed
// order: a shuffle tree inside each warp, the warps' partials to shared
// memory, then one pass that adds the warps in index order and writes the
// batch's rows to v_slot, coalesced.  A warp in which no lane is live for a
// slot skips its reduction (a bit per slot and warp says so).  Once every
// pixel has stopped the CTA leaves; the rest of its span keeps the zeros the
// wrapper allocated.  The result is bit-identical from run to run.
//
// The TPU kernel's 256-lane chunks, its carry between neighbouring tiles,
// bf16 splits and moment basis exist for the TPU's matrix unit and ordered
// grid and are not carried over.
//
// Packed modes (rasterize_pallas.py:_bwd_kernel packed=True :613-624,
// :669-670, and pack_grads :690-709).  PACKED reads the packed payload that
// the packed forward read (ceil((6+D)/2) bf16-pair carriers per slot, means
// in tile-local pixels), unpacks it into the same staged rows and replays it
// with tile-local pixel centres, so its decisions are the packed forward's;
// dx = px - mx is translation invariant, so the means' gradient read in the
// tile-local frame is the gradient of the caller's means.  `pack_grads`
// writes the 6+D per-slot sums, after the same fixed-order reduction, as
// ceil((6+D)/2) bf16-pair carriers of the rows paired in order
// (csrc/bf16pair.cuh): half the output bytes and half the rows that the
// scatter back to emission order moves.  Slots no CTA reaches keep the zero
// bits the wrapper allocated.
//
// What bounds it on the H100: operations.  Every evaluated (pixel, slot)
// pair costs the forward's ~21 f32 operations again; a live pair needs
// 29 + 3D more for its gradient terms (38 at D = 3) and one add into each of
// its 6+D per-slot sums, against 2*(6+D) floats of traffic per slot.  The
// shuffle tree spends 5 shuffle-adds per value and lane where the function
// needs one add, which is this kernel's own cost and no part of its bound.
// The design keeps the per-pair state in registers, skips dead warps, and
// leaves early with the forward.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16pair.cuh"
#include "composite.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kBatch = 32;  // staged slots per batch: one live bit each
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFullMask, v, off);
  return v;  // lane 0 holds the sum
}

template <int D, bool PACKED>
__global__ void __launch_bounds__(kMaxThreads)
rasterize_bwd_kernel(const float* __restrict__ fields, long long P,
                     const int* __restrict__ bounds, int tile, int tiles_w,
                     int tiles_per_image, int width, int height, bool pack_grads,
                     const float* __restrict__ v_pix, const float* __restrict__ v_t,
                     const float* __restrict__ pix_out, const float* __restrict__ t_final,
                     float* __restrict__ v_slot, int* __restrict__ live_counts) {
  constexpr int F = 6 + D;
  constexpr int R = (F + 1) / 2;  // carriers per slot, of the payload and of the gradients
  extern __shared__ float smem[];
  const int B = blockDim.x;
  const int n_warps = B >> 5;
  float* stage = smem;                      // [F][kBatch] staged slot fields
  float* partial = smem + F * kBatch;       // [n_warps][F][kBatch] warp sums
  unsigned* live_bits = (unsigned*)(partial + n_warps * F * kBatch);  // [n_warps]

  const int t = blockIdx.x;
  const int tr = threadIdx.x;
  const int lane = tr & 31;
  const int warp = tr >> 5;

  const int im = t / tiles_per_image;
  const int tl = t - im * tiles_per_image;
  const int ty = tl / tiles_w;
  const int tx = tl - ty * tiles_w;
  const int x = tx * tile + tr % tile;
  const int y = ty * tile + tr / tile;
  // packed: tile-local centres, as the packed means are tile-local
  const float px = (float)(PACKED ? tr % tile : x) + 0.5f;
  const float py = (float)(PACKED ? tr / tile : y) + 0.5f;
  const bool inside = x < width && y < height;

  bool done = !inside;
  float T = inside ? 1.0f : 0.0f;
  float E = 0.0f;       // running sum_{j<=i} w_j d_j
  float dtot = 0.0f;    // sum_c v_pix[c] * pix_out[c]
  float vt_term = 0.0f; // v_T * T_final
  int n_live = 0;
  float vp[D];
#pragma unroll
  for (int k = 0; k < D; ++k) vp[k] = 0.0f;
  if (inside) {
    const long long pix = ((long long)im * height + y) * width + x;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      vp[k] = v_pix[pix * D + k];
      dtot += vp[k] * pix_out[pix * D + k];
    }
    vt_term = v_t[pix] * t_final[pix];
  }

  const int start = bounds[t];
  const int end = bounds[t + 1];
  const int n_batches = (end - start + kBatch - 1) / kBatch;
  for (int batch = 0; batch < n_batches; ++batch) {
    // also the barrier that frees the shared buffers of the batch before
    if (__syncthreads_count(done) == B) break;
    const int base = start + batch * kBatch;
    const int n = min(kBatch, end - base);
    if (PACKED) {
      for (int o = tr; o < R * kBatch; o += B) {
        const int c = o / kBatch;
        const int j = o - c * kBatch;
        if (j >= n) continue;
        const float carrier = fields[c * P + base + j];
        stage[(2 * c) * kBatch + j] = gs::bf16_hi(carrier);
        if (2 * c + 1 < F) stage[(2 * c + 1) * kBatch + j] = gs::bf16_lo(carrier);
      }
    } else {
      for (int o = tr; o < F * kBatch; o += B) {
        const int f = o / kBatch;
        const int j = o - f * kBatch;
        if (j < n) stage[o] = fields[f * P + base + j];
      }
    }
    __syncthreads();

    unsigned warp_live = 0;
    for (int j = 0; j < n; ++j) {
      bool live = false;
      float w = 0.0f, v_op = 0.0f, v_mx = 0.0f, v_my = 0.0f, v_a = 0.0f, v_b = 0.0f,
            v_c = 0.0f;
      if (!done) {
        const float a = stage[2 * kBatch + j];
        const float b = stage[3 * kBatch + j];
        const float c = stage[4 * kBatch + j];
        done = gs::composite_pair(
            px, py, stage[0 * kBatch + j], stage[1 * kBatch + j], a, b, c,
            stage[5 * kBatch + j], T,
            [&](const gs::Pair& p, float next_T) {
              live = true;
              ++n_live;
              w = p.alpha * T;
              float d = 0.0f;
#pragma unroll
              for (int k = 0; k < D; ++k) d += vp[k] * stage[(6 + k) * kBatch + j];
              E += w * d;
              const float ra = 1.0f / (1.0f - p.alpha);  // alpha <= 0.99
              const float v_alpha = d * T - (dtot - E) * ra - vt_term * ra;
              if (!p.clamped) {
                const float v_sigma = -p.alpha * v_alpha;
                v_op = p.vis * v_alpha;
                // sigma depends on the mean through dx = px - mx
                v_mx = -v_sigma * (a * p.dx + b * p.dy);
                v_my = -v_sigma * (c * p.dy + b * p.dx);
                v_a = 0.5f * v_sigma * p.dx * p.dx;
                v_b = v_sigma * p.dx * p.dy;
                v_c = 0.5f * v_sigma * p.dy * p.dy;
              }
              T = next_T;
            });
      }
      if (__ballot_sync(kFullMask, live) == 0) continue;
      warp_live |= 1u << j;
      float* out = partial + (size_t)warp * F * kBatch + j;
      v_mx = warp_sum(v_mx);
      v_my = warp_sum(v_my);
      v_a = warp_sum(v_a);
      v_b = warp_sum(v_b);
      v_c = warp_sum(v_c);
      v_op = warp_sum(v_op);
      if (lane == 0) {
        out[0 * kBatch] = v_mx;
        out[1 * kBatch] = v_my;
        out[2 * kBatch] = v_a;
        out[3 * kBatch] = v_b;
        out[4 * kBatch] = v_c;
        out[5 * kBatch] = v_op;
      }
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float v = warp_sum(vp[k] * w);
        if (lane == 0) out[(6 + k) * kBatch] = v;
      }
    }
    if (lane == 0) live_bits[warp] = warp_live;
    __syncthreads();

    // the warps' partials, added in warp order, one output element a thread
    auto slot_sum = [&](int f, int j) {
      float sum = 0.0f;
      for (int wi = 0; wi < n_warps; ++wi) {
        if ((live_bits[wi] >> j) & 1u) sum += partial[((size_t)wi * F + f) * kBatch + j];
      }
      return sum;
    };
    if (pack_grads) {
      for (int o = tr; o < R * kBatch; o += B) {
        const int c = o / kBatch;
        const int j = o - c * kBatch;
        if (j >= n) continue;
        const float lo = 2 * c + 1 < F ? slot_sum(2 * c + 1, j) : 0.0f;
        v_slot[c * P + base + j] = gs::pack_bf16_pair(slot_sum(2 * c, j), lo);
      }
    } else {
      for (int o = tr; o < F * kBatch; o += B) {
        const int f = o / kBatch;
        const int j = o - f * kBatch;
        if (j < n) v_slot[f * P + base + j] = slot_sum(f, j);
      }
    }
  }

  if (live_counts != nullptr) {
    // __syncthreads_count sums a predicate; the per-pixel counts go bit by bit
    int total = 0;
    for (int bit = 0; bit < 31; ++bit) {
      const int n = __syncthreads_count((n_live >> bit) & 1);
      total += n << bit;
      if (__syncthreads_or(n_live >> (bit + 1)) == 0) break;
    }
    if (tr == 0) live_counts[t] = total;
  }
}

template <int D, bool PACKED>
int launch(const float* fields, long long P, const int* bounds, int tile,
           int tiles_w, int tiles_per_image, int width, int height, int n_tiles,
           bool pack_grads, const float* v_pix, const float* v_t, const float* pix_out,
           const float* t_final, float* v_slot, int* live_counts, cudaStream_t stream) {
  constexpr int F = 6 + D;
  const int threads = tile * tile;
  const int n_warps = threads / 32;
  const size_t smem = sizeof(float) * F * kBatch * (1 + n_warps) + sizeof(unsigned) * n_warps;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rasterize_bwd_kernel<D, PACKED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rasterize_bwd_kernel<D, PACKED><<<n_tiles, threads, smem, stream>>>(
      fields, P, bounds, tile, tiles_w, tiles_per_image, width, height, pack_grads, v_pix,
      v_t, pix_out, t_final, v_slot, live_counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// fields [6+D, P] f32 sorted slot rows (packed: [ceil((6+D)/2), P] bf16-pair
// carriers with tile-local means), bounds [n_tiles+1] i32 tile spans, v_pix
// and pix_out [I, H, W, D] f32, v_t and t_final [I, H, W] f32 -> v_slot
// [6+D, P] f32, or with pack_grads [ceil((6+D)/2), P] bf16-pair carriers
// (zeroed by the caller; slots no CTA reaches stay zero) and, unless null,
// live_counts [n_tiles] i32: the live (pixel, slot) pairs of each tile.
// D in [1, 32].
int gs_rasterize_bwd(const float* fields, long long P, const int* bounds,
                     int D, int tile, int tiles_w, int tiles_per_image,
                     int width, int height, int n_tiles, int packed, int pack_grads,
                     const float* v_pix, const float* v_t, const float* pix_out,
                     const float* t_final, float* v_slot, int* live_counts,
                     cudaStream_t stream) {
  if (n_tiles == 0) return (int)cudaGetLastError();
  switch (D) {
#define GS_LAUNCH(d, p) \
  launch<d, p>(fields, P, bounds, tile, tiles_w, tiles_per_image, width, height, n_tiles, pack_grads != 0, v_pix, v_t, pix_out, t_final, v_slot, live_counts, stream)
#define GS_CASE(d) \
  case d:          \
    return packed ? GS_LAUNCH(d, true) : GS_LAUNCH(d, false);
    GS_CASE(1) GS_CASE(2) GS_CASE(3) GS_CASE(4) GS_CASE(5) GS_CASE(6) GS_CASE(7) GS_CASE(8)
    GS_CASE(9) GS_CASE(10) GS_CASE(11) GS_CASE(12) GS_CASE(13) GS_CASE(14) GS_CASE(15) GS_CASE(16)
    GS_CASE(17) GS_CASE(18) GS_CASE(19) GS_CASE(20) GS_CASE(21) GS_CASE(22) GS_CASE(23) GS_CASE(24)
    GS_CASE(25) GS_CASE(26) GS_CASE(27) GS_CASE(28) GS_CASE(29) GS_CASE(30) GS_CASE(31) GS_CASE(32)
#undef GS_CASE
#undef GS_LAUNCH
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
