// eval3d forward composite (K7a) for Hopper: the response of each gaussian
// evaluated in 3D along each pixel's world-space ray.
//
// Replaces gsplat_tpu/ops/rasterize_eval3d_pallas.py:_fwd_kernel (:122,
// wrapper _fwd_call_eval3d :526).  One CTA of 256 threads per 16x16 tile,
// one pixel a thread, each warp's 32 lanes on an 8x4 block of the tile's
// pixels (the blocks of the 2DGS forward, rasterize2d_fwd.cu).  The CTA
// walks its tile's span of the (tile, depth)-sorted slot stream in batches
// of 256 slots: the threads stage the batch into shared memory, then every
// thread composites it serially, front to back, for its pixel; the CTA
// leaves once every pixel has stopped (__syncthreads_count).  None of the
// TPU kernel's machinery carries over: its 128-lane chunks, lane cumprod,
// colour matmul and double-buffered DMA.
//
// Slot fields (rasterize_eval3d_pallas.py:_field_layout :53): x (3), M
// (9), opacity, [scale (3) when `hit`], D colour channels (the last one
// replaced by the hit distance when `hit`), [3 normal components when
// `normals`].  Per pixel it writes out[I, H, W, D + 3*normals]: the D
// channels, then the normals flipped toward the ray (n . d > 0 flips), and
// T_final [I, H, W].
//
// Numeric contract: csrc/ray3d.cuh decides gate and stop, shared with the
// backward.  Every sum here is a serial float32 sum in slot order with each
// product and add rounded on its own, as the plain version
// (ops/rasterize_eval3d_kernel.py:rasterize_eval3d_fwd_plain) computes it,
// so the two agree bit for bit.  A pixel stops for good (the oracle's rule;
// the JAX Pallas kernel can resume it in a later 128-slot chunk).  A ray
// with |d|^2 <= 1e-12 starts at T = 0, as in the JAX kernel.
//
// What bounds it on the H100: operations.  Each evaluated (pixel, slot)
// pair costs ~68 f32 operations by the whole response (three 3x3 products,
// a normalization with a square root and a division, a cross product, an
// exp), a live pair 2 D + 12 more, against 16 + D floats per slot read once
// per tile.  Most pairs are gated (82% at 4k), so the design spends least on
// them and on what every pixel shares (csrc/ray3d.cuh's hoisting and early
// reject, which move no decision):
// - once per CTA, each warp fits its block's bundle of rays (an affine
//   model of the directions, the origins' spread) and the CTA finds whether
//   every active ray has one origin;
// - as a slot is staged, its thread computes M x once, and with one origin
//   the whole of g = M o - M x (the walk is compiled for each case), and the
//   mask of the tile's 8 blocks in which the exact path certainly gates
//   every pixel; a warp reads the mask (one broadcast load) and skips the
//   slots its block masks, a branch uniform over the warp;
// - a slot's M, g (or M x), opacity and scale are one record of four
//   float4s; colours and normals, read by live pairs only, stay one row
//   per field;
// - the exact path is a chain of dependent operations, and a tile's span is
//   walked by one CTA (the lidar's longest tile holds 4,376 slots): each
//   thread takes the responses of the next two slots its block does not
//   mask at once (they do not depend on T), then decides them in slot
//   order; the per-pair state stays in registers and the CTA leaves early
//   with its last pixel.
//
// COUNT instantiates per-tile counts of contributing pairs (the backward's
// live pairs must equal them), of evaluated pairs (the work yardstick,
// masked pairs included), of pairs that took the exact path (the work
// behind the bound), of masked pairs that the exact path, run on them too,
// would not have gated (must be 0), and whether the tile took the hoisted
// route of one origin; it walks one slot at a time.  Without it the kernel
// carries no counter.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "ray3d.cuh"

namespace {

constexpr int kBatch = 256;  // slots staged per batch
constexpr int kRec = 4;      // float4s of a staged record
// record layout: M (9), then g with one origin or M x without (3), then
// the opacity and the scale (3)
enum { kRecG = 9, kRecOp = 12, kRecScale = 13 };
constexpr int kThreads = gs3d::kTile * gs3d::kTile;  // one pixel a thread
constexpr int kAhead = 2;  // slots' responses taken at once
// CTAs an SM the registers are held to: four for a few channels (on an
// H100 at the 3DGUT view's D = 4: 6.44 ms against 6.84 with three, 8.56
// with two; PERF.md), unbounded for more
template <int D>
constexpr int kMinBlocks = D <= 8 ? 4 : 1;

__device__ __forceinline__ void load_record(const float4* rec, int j, float* v) {
#pragma unroll
  for (int q = 0; q < kRec; ++q) {
    const float4 f4 = rec[q * kBatch + j];
    v[4 * q] = f4.x;
    v[4 * q + 1] = f4.y;
    v[4 * q + 2] = f4.z;
    v[4 * q + 3] = f4.w;
  }
}

// g = M o - M x for the ray r from a record: staged whole with one origin
// (UNIFORM), else from the staged M x, each operation as the exact path's
template <bool UNIFORM>
__device__ __forceinline__ void record_g(const float* v, const gs3d::Ray& r, float* g) {
#pragma unroll
  for (int c = 0; c < 3; ++c)
    g[c] = UNIFORM ? v[kRecG + c]
                   : __fsub_rn(gs3d::dot3(v[3 * c], v[3 * c + 1], v[3 * c + 2], r.o[0], r.o[1],
                                          r.o[2]),
                               v[kRecG + c]);
}

template <int D, bool COUNT>
__global__ void __launch_bounds__(kThreads, kMinBlocks<D>)
rasterize_eval3d_fwd_kernel(const float* __restrict__ fields, long long P,
                            const int* __restrict__ bounds, const float* __restrict__ rays,
                            bool hit, bool normals, int tiles_w, int tiles_per_image, int width,
                            int height, float* __restrict__ out, float* __restrict__ out_t,
                            int* __restrict__ pair_counts, int* __restrict__ eval_counts,
                            int* __restrict__ exact_counts, int* __restrict__ unsound_counts,
                            int* __restrict__ one_origin) {
  extern __shared__ float4 smem[];
  float4* rec = smem;  // record q of slot j at rec[q * kBatch + j]
  unsigned* masks = reinterpret_cast<unsigned*>(smem + kRec * kBatch);  // [kBatch]
  float* chan = reinterpret_cast<float*>(masks + kBatch);  // [D_mat + 3*normals][kBatch]
  __shared__ gs3d::RayBundle bundles[gs3d::kBlocks];
  __shared__ float tile_origin[3];
  __shared__ int first_at;
  constexpr int kTile = gs3d::kTile;
  const int color0 = hit ? gs3d::kRowScale + 3 : gs3d::kRowScale;
  const int normal0 = color0 + D;
  const int D_mat = hit ? D - 1 : D;  // channels read from the colour rows
  const int t = blockIdx.x;
  const int tr = threadIdx.x;
  const int lane = tr & 31;
  const int warp = tr >> 5;  // the warp's 8x4 block of the tile (two across, four down)

  const int im = t / tiles_per_image;
  const int tl = t - im * tiles_per_image;
  const int ty = tl / tiles_w;
  const int tx = tl - ty * tiles_w;
  const int x = tx * kTile + (warp & 1) * 8 + (lane & 7);  // lane l: pixel (l % 8, l / 8)
  const int y = ty * kTile + (warp >> 1) * 4 + (lane >> 3);
  const bool inside = x < width && y < height;
  const long long pix = ((long long)im * height + y) * width + x;
  gs3d::Ray r;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r.o[c] = inside ? rays[pix * 6 + c] : 0.0f;
    r.d[c] = inside ? rays[pix * 6 + 3 + c] : 0.0f;
  }
  bool done = !(inside && gs3d::dir_norm2(r) > 1e-12f);
  const bool active = !done;
  float T = done ? 0.0f : 1.0f;
  float acc[D + 3];  // channels, then normals
#pragma unroll
  for (int c = 0; c < D + 3; ++c) acc[c] = 0.0f;
  gs3d::ray_block_bundle(active, r, lane, &bundles[warp]);

  // one origin: every active ray's origin equals the first active one's bit for bit
  if (tr == 0) {
    first_at = 0x7fffffff;
    tile_origin[0] = tile_origin[1] = tile_origin[2] = 0.0f;
  }
  __syncthreads();
  if (active) atomicMin(&first_at, tr);
  __syncthreads();
  if (first_at == tr) {
#pragma unroll
    for (int c = 0; c < 3; ++c) tile_origin[c] = r.o[c];
  }
  __syncthreads();
  bool same = true;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    same = same && (!active || __float_as_uint(r.o[c]) == __float_as_uint(tile_origin[c]));
  const bool uniform = __syncthreads_and(same) != 0;
  const float o_t[3] = {tile_origin[0], tile_origin[1], tile_origin[2]};

  // contributing, evaluated, exact-path and unsound pairs (COUNT only)
  int kept = 0, evaluated = 0, exact = 0, unsound = 0;
  const int start = bounds[t];
  const int end = bounds[t + 1];
  const int n_batches = (end - start + kBatch - 1) / kBatch;

  // the walk, compiled for one origin (g staged whole) and for several
  auto walk = [&](auto uniform_c) {
    constexpr bool U = decltype(uniform_c)::value;
    for (int batch = 0; batch < n_batches; ++batch) {
      if (__syncthreads_count(done) == kThreads) break;
      const int base = start + batch * kBatch;
      for (int j = tr; j < kBatch && base + j < end; j += kThreads) {
        const long long idx = base + j;
        float xs[3], m[9], mx[3], g[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) xs[c] = fields[(gs3d::kRowX + c) * P + idx];
#pragma unroll
        for (int c = 0; c < 9; ++c) m[c] = fields[(gs3d::kRowM + c) * P + idx];
        const float op = fields[gs3d::kRowOp * P + idx];
        float sc[3] = {0.0f, 0.0f, 0.0f};
        if (hit) {
#pragma unroll
          for (int c = 0; c < 3; ++c) sc[c] = fields[(gs3d::kRowScale + c) * P + idx];
        }
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          mx[c] = gs3d::dot3(m[3 * c], m[3 * c + 1], m[3 * c + 2], xs[0], xs[1], xs[2]);
          if (U)
            g[c] = __fsub_rn(gs3d::dot3(m[3 * c], m[3 * c + 1], m[3 * c + 2], o_t[0], o_t[1],
                                        o_t[2]),
                             mx[c]);
        }
        const float gate = gs3d::ray_gate(xs, m, op);
        unsigned mask = 0u;
        if (gate == -INFINITY) {
          mask = (1u << gs3d::kBlocks) - 1u;
        } else if (gate < INFINITY) {
          const float sigma = gs3d::ray_sigma_max(m);
          const float x_norm = gs3d::norm3(xs[0], xs[1], xs[2]);
#pragma unroll 1
          for (int b = 0; b < gs3d::kBlocks; ++b) {
            const gs3d::RayBundle& bd = bundles[b];
            float gb[3];
#pragma unroll
            for (int c = 0; c < 3; ++c)
              gb[c] = U ? g[c]
                        : __fsub_rn(gs3d::dot3(m[3 * c], m[3 * c + 1], m[3 * c + 2], bd.oc[0],
                                               bd.oc[1], bd.oc[2]),
                                    mx[c]);
            if (gs3d::ray_block_gated(m, gb, x_norm, sigma, gate, bd)) mask |= 1u << b;
          }
        }
        masks[j] = mask;
        const float* G = U ? g : mx;
        rec[0 * kBatch + j] = make_float4(m[0], m[1], m[2], m[3]);
        rec[1 * kBatch + j] = make_float4(m[4], m[5], m[6], m[7]);
        rec[2 * kBatch + j] = make_float4(m[8], G[0], G[1], G[2]);
        rec[3 * kBatch + j] = make_float4(op, sc[0], sc[1], sc[2]);
        for (int c = 0; c < D_mat; ++c) chan[c * kBatch + j] = fields[(color0 + c) * P + idx];
        if (normals) {
#pragma unroll
          for (int c = 0; c < 3; ++c)
            chan[(D_mat + c) * kBatch + j] = fields[(normal0 + c) * P + idx];
        }
      }
      __syncthreads();
      const int n = min(kBatch, end - base);
      // a live pair's sums at slot j
      auto on_live = [&](int j) {
        return [&, j](const gs3d::Response& sp, float next_T) {
          const float w = __fmul_rn(sp.alpha, T);
#pragma unroll
          for (int c = 0; c < D; ++c) {
            if (c < D_mat) acc[c] = __fadd_rn(acc[c], __fmul_rn(w, chan[c * kBatch + j]));
          }
          if (hit) acc[D - 1] = __fadd_rn(acc[D - 1], __fmul_rn(w, sp.hd));
          if (normals) {
            const float* nr = chan + D_mat * kBatch + j;
            const float nd =
                gs3d::dot3(nr[0], nr[kBatch], nr[2 * kBatch], r.d[0], r.d[1], r.d[2]);
            const float ws = nd > 0.0f ? -w : w;
#pragma unroll
            for (int c = 0; c < 3; ++c)
              acc[D + c] = __fadd_rn(acc[D + c], __fmul_rn(ws, nr[c * kBatch]));
          }
          T = next_T;
          if (COUNT) ++kept;
        };
      };
      if (!COUNT) {
        // the next kAhead slots the warp's block does not mask (a scan the
        // warp shares), their responses, then the decisions in slot order
        int j = 0;
        while (!done) {
          int js[kAhead] = {};
          int nj = 0;
#pragma unroll
          for (int q = 0; q < kAhead; ++q) {
            while (j < n && ((masks[j] >> warp) & 1u)) ++j;
            js[q] = j < n ? j : js[0];
            if (j < n) {
              ++nj;
              ++j;
            }
          }
          if (nj == 0) break;
          gs3d::Response s[kAhead];
          bool passes[kAhead];
          float scale[kAhead][3];
#pragma unroll
          for (int q = 0; q < kAhead; ++q) {
            float v[4 * kRec], g[3];
            load_record(rec, js[q], v);
            record_g<U>(v, r, g);
            passes[q] = gs3d::ray_respond(r, v, g, v[kRecOp], s[q]);
#pragma unroll
            for (int c = 0; c < 3; ++c) scale[q][c] = v[kRecScale + c];
          }
#pragma unroll
          for (int q = 0; q < kAhead; ++q)
            if (q < nj && !done)
              done = gs3d::ray_decide(
                  s[q], passes[q], [&](int c) { return scale[q][c]; }, hit, T, on_live(js[q]));
          if (nj < kAhead) break;  // the batch's end
        }
      } else {
        // one slot at a time, every pair counted; a masked pair also takes
        // the exact path, which must gate it
        for (int j = 0; j < n && !done; ++j) {
          ++evaluated;
          float v[4 * kRec], g[3];
          load_record(rec, j, v);
          record_g<U>(v, r, g);
          gs3d::Response s;
          if ((masks[j] >> warp) & 1u) {
            unsound += gs3d::ray_respond(r, v, g, v[kRecOp], s);
            continue;
          }
          ++exact;
          const bool passes = gs3d::ray_respond(r, v, g, v[kRecOp], s);
          done = gs3d::ray_decide(s, passes, [&](int c) { return v[kRecScale + c]; }, hit, T,
                                  on_live(j));
        }
      }
      __syncthreads();
    }
  };
  if (uniform)
    walk(std::true_type{});
  else
    walk(std::false_type{});

  if (inside) {
    const int D_out = D + (normals ? 3 : 0);
    float* o = out + pix * D_out;
#pragma unroll
    for (int c = 0; c < D; ++c) o[c] = acc[c];
    if (normals) {
#pragma unroll
      for (int c = 0; c < 3; ++c) o[D + c] = acc[D + c];
    }
    out_t[pix] = T;
  }
  if (COUNT) {
    const int total = gs3d::cta_count(kept);
    const int total_eval = gs3d::cta_count(evaluated);
    const int total_exact = gs3d::cta_count(exact);
    const int total_unsound = gs3d::cta_count(unsound);
    if (tr == 0) {
      pair_counts[t] = total;
      eval_counts[t] = total_eval;
      exact_counts[t] = total_exact;
      unsound_counts[t] = total_unsound;
      one_origin[t] = uniform ? 1 : 0;
    }
  }
}

template <int D, bool COUNT>
int launch(const float* fields, long long P, const int* bounds, const float* rays, bool hit,
           bool normals, int tiles_w, int tiles_per_image, int width, int height, int n_tiles,
           float* out, float* out_t, int* pair_counts, int* eval_counts, int* exact_counts,
           int* unsound_counts, int* one_origin, cudaStream_t stream) {
  const int n_chan = (hit ? D - 1 : D) + (normals ? 3 : 0);
  const size_t smem = sizeof(float4) * kRec * kBatch + sizeof(unsigned) * kBatch +
                      sizeof(float) * n_chan * kBatch;
  if (smem > 40 * 1024) {  // beside the static bundles
    cudaError_t e = cudaFuncSetAttribute(rasterize_eval3d_fwd_kernel<D, COUNT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rasterize_eval3d_fwd_kernel<D, COUNT><<<n_tiles, kThreads, smem, stream>>>(
      fields, P, bounds, rays, hit, normals, tiles_w, tiles_per_image, width, height, out,
      out_t, pair_counts, eval_counts, exact_counts, unsound_counts, one_origin);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// fields [F, P] f32 sorted slot rows, bounds [n_tiles+1] i32 tile spans,
// rays [I, H, W, 6] f32 world-space (origin, direction) -> out [I, H, W,
// D + 3*normals] f32, out_t [I, H, W] f32 and, unless pair_counts is null,
// [n_tiles] i32 per tile: pair_counts, the contributing (pixel, slot) pairs;
// eval_counts, the evaluated ones; exact_counts, those that took the exact
// path; unsound_counts, those the block masks gated that the exact path
// would not have; one_origin, 1 where every active ray had one origin (all
// five non-null together).  F = 13 + 3*hit + D + 3*normals; tile 16; D in
// [1, 32] (at least 2 with the hit channel beside colours, 1 for it alone).
int gs_rasterize_eval3d_fwd(const float* fields, long long P, const int* bounds,
                            const float* rays, int D, int hit, int normals, int tiles_w,
                            int tiles_per_image, int width, int height, int n_tiles, float* out,
                            float* out_t, int* pair_counts, int* eval_counts, int* exact_counts,
                            int* unsound_counts, int* one_origin, cudaStream_t stream) {
  if (n_tiles == 0) return (int)cudaGetLastError();
  const bool h = hit != 0, nr = normals != 0;
  switch (D) {
#define GS_CASE(d) \
  case d:          \
    return pair_counts != nullptr \
        ? launch<d, true>(fields, P, bounds, rays, h, nr, tiles_w, tiles_per_image, width, height, n_tiles, out, out_t, pair_counts, eval_counts, exact_counts, unsound_counts, one_origin, stream) \
        : launch<d, false>(fields, P, bounds, rays, h, nr, tiles_w, tiles_per_image, width, height, n_tiles, out, out_t, pair_counts, eval_counts, exact_counts, unsound_counts, one_origin, stream);
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
