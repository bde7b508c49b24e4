// 3DGS forward composite (K1) for Hopper.
//
// Replaces gsplat_tpu/ops/rasterize_pallas.py:_fwd_kernel (:330, wrapper
// _fwd_call :818).  One CTA per tile (8, 16 or 32 pixels square), which
// walks its tile's span of the depth-sorted slot stream front to back.
//
// Numeric contract: csrc/composite.cuh holds the per-(pixel, slot) sigma,
// alpha, gate and stop code, shared with the backward kernel
// (rasterize_bwd.cu), which must replay these decisions bit for bit.  (The
// JAX Pallas kernel can resume a stopped pixel in a later 256-slot chunk;
// this kernel follows the oracle, rasterize_ref.py:32-47.)  Pixel centres
// sit at +0.5; pixels past the image edge start with T = 0 and are never
// written.  The alpha gate and the stop rule are discontinuous: one ulp of
// sigma or T can drop or keep a gaussian whose weight is up to 1/255 (the
// gate) or ~1e-2 (the excluded saturating one).  So sigma rounds each
// operation on its own and T is the serial product T *= 1 - alpha, exactly
// as the plain version computes them; the colour sums, too, round each
// product and sum alone in slot order, as the plain version's serial sum
// does, so the two agree bit for bit for every D.
//
// Inputs are the sorted field rows [6+D, P] (x, y, a, b, c, op, colors),
// materialized by one gather after the sort, so each batch load is a
// coalesced row read.  Outputs are written straight to the image layout
// [I, H, W, D] and T [I, H, W]; the JAX package's tiled layout is not
// needed.
//
// What bounds it on the H100: the (pixel, slot) pairs it evaluates, ~20 f32
// operations and one exp each, against the fields it reads once per tile;
// it is bound by operations, not bytes.  The decisions are separately
// rounded multiplies and adds, which do not fuse, and each evaluated pair
// takes one exp on the SM's special-function units (16 a clock per SM).
//
// Design (K2's, rasterize_bwd.cu).  Each thread owns kPix pixels, one in
// each of kPix 8x4 blocks of the tile (at tile 8, whose two blocks one warp
// covers, the rest are idle), so a slot's fields, colours included, are read
// from shared memory once per thread for all its pixels.  The span is walked
// in batches of kBatch slots, staged with cp.async and double-buffered: the
// next batch's rows are in flight while this one is composited.  A lane
// whose pixels have all stopped leaves the batch, a warp whose lanes all
// have skips it, and the CTA leaves once every pixel has stopped.  At the
// end each warp writes its blocks' colours through shared memory, a block
// row of 8 pixels' D channels at a time, so that the stores are coalesced.
// On an H100 at the serving shape (4k, RGB) four pixels a thread took 3.09
// ms where two took 3.28 and eight 3.99 (PERF.md): the decisions, not the
// reads around them, are most of the time.
//
// COUNT instantiates the per-tile count of contributing pairs (the check
// that the backward's live pairs equal them), one block reduction at the
// end; without it the kernel carries no counter.
//
// PACKED is the packed mode (rasterize_pallas.py:_fwd_kernel packed=True,
// :399-407 and :421-425): the slot stream holds ceil((6+D)/2) bf16-pair
// carriers per slot (csrc/bf16pair.cuh) with the mean in tile-local pixels,
// as the packed emission (expand.cu, K4) writes them, and the pixel centres
// are tile-local too, (lx) + 0.5, so dx = px - mx is the same difference in a
// frame whose coordinates stay below a few tiles.  The carriers are staged
// as they are and unpacked once per batch, after they land, into float rows
// in shared memory (on an H100 at 4k, 2.93 ms where unpacking each field
// where a thread reads it took 3.29: PERF.md).  Everything after the unpack
// is the float32 composite of the unpacked values, so the packed kernel
// equals its plain version bit for bit as the float32 one does.  The stream
// moves 5 rows per slot for RGB instead of 9.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16pair.cuh"
#include "composite.cuh"

namespace {

constexpr int kPix = 4;  // pixels per thread, one in each of kPix 8x4 blocks
constexpr int kMaxThreads = 32 * 32 / kPix;
constexpr int kBatch = 64;  // slots staged per batch
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Shared memory: the staged rows, [2][SR][kBatch] (packed: the carriers,
// then the batch's unpacked [F][kBatch]); after the last batch the same
// space holds the colours on their way out, [threads][D].
template <int D, bool PACKED>
__host__ __device__ constexpr int staged_rows() {
  return PACKED ? (6 + D + 1) / 2 : 6 + D;
}

template <int D, bool PACKED>
size_t smem_bytes(int threads) {
  constexpr int SR = staged_rows<D, PACKED>();
  const size_t stage = 2 * SR * kBatch + (PACKED ? (6 + D) * kBatch : 0);
  const size_t out = (size_t)threads * D;
  return sizeof(float) * (stage > out ? stage : out);
}

template <int D, bool COUNT, bool PACKED>
__global__ void __launch_bounds__(kMaxThreads)
rasterize_fwd_kernel(const float* __restrict__ fields, long long P,
                     const int* __restrict__ bounds, int tile, int tiles_w,
                     int tiles_per_image, int width, int height,
                     float* __restrict__ out_color, float* __restrict__ out_t,
                     int* __restrict__ pair_counts) {
  extern __shared__ float smem[];
  constexpr int F = 6 + D;
  constexpr int SR = staged_rows<D, PACKED>();
  float* stage = smem;                   // [2][SR][kBatch]
  float* unpacked = smem + 2 * SR * kBatch;  // [F][kBatch] (PACKED)
  __shared__ int cta_kept;

  const int B = blockDim.x;
  const int n_warps = B >> 5;
  const int n_blocks = tile * tile / 32;
  const int blocks_w = tile >> 3;
  const int t = blockIdx.x;
  const int tr = threadIdx.x;
  const int lane = tr & 31;
  const int warp = tr >> 5;
  const int im = t / tiles_per_image;
  const int tl = t - im * tiles_per_image;
  const int ty = tl / tiles_w;
  const int tx = tl - ty * tiles_w;

  // warp w takes the 8x4 pixel blocks w + n_warps * k < n_blocks of the
  // tile, lane l pixel (l % 8, l / 8) of each
  bool done[kPix];
  float T[kPix], px[kPix], py[kPix], acc[kPix][D];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int block = warp + n_warps * k;
    const int lx = (block % blocks_w) * 8 + (lane & 7);
    const int ly = (block / blocks_w) * 4 + (lane >> 3);
    const int x = tx * tile + lx;
    const int y = ty * tile + ly;
    const bool inside = block < n_blocks && x < width && y < height;
    // packed: tile-local centres, as the packed means are tile-local
    px[k] = (float)(PACKED ? lx : x) + 0.5f;
    py[k] = (float)(PACKED ? ly : y) + 0.5f;
    T[k] = inside ? 1.0f : 0.0f;
    done[k] = !inside;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[k][c] = 0.0f;
  }
  int kept = 0;  // pairs that contributed to this thread's pixels (COUNT only)

  const int start = bounds[t];
  const int end = bounds[t + 1];
  const int n_batches = (end - start + kBatch - 1) / kBatch;
  auto stage_batch = [&](int batch) {
    const int base = start + batch * kBatch;
    const int n = min(kBatch, end - base);
    float* dst = stage + (batch & 1) * SR * kBatch;
    for (int o = tr; o < SR * kBatch; o += B) {
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
    if (__syncthreads_count(mine_done) == B) break;
    if (batch + 1 < n_batches) stage_batch(batch + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of `batch` have landed
    __syncthreads();     // and everyone's

    const int n = min(kBatch, end - (start + batch * kBatch));
    const float* rows = stage + (batch & 1) * SR * kBatch;  // [F][kBatch]
    if (PACKED) {  // the batch's carriers, unpacked once for every thread
      for (int o = tr; o < SR * kBatch; o += B) {
        const int c = o / kBatch;
        const int j = o - c * kBatch;
        const float carrier = rows[o];
        unpacked[(2 * c) * kBatch + j] = gs::bf16_hi(carrier);
        if (2 * c + 1 < F) unpacked[(2 * c + 1) * kBatch + j] = gs::bf16_lo(carrier);
      }
      __syncthreads();
      rows = unpacked;
    }
    if (__all_sync(kFullMask, mine_done)) continue;
    for (int j = 0; j < n; ++j) {
      bool all_done = true;
#pragma unroll
      for (int k = 0; k < kPix; ++k) all_done = all_done && done[k];
      if (all_done) break;
      // the slot's fields, read once for all kPix pixels
      const float mx = rows[j], my = rows[kBatch + j];
      const float a = rows[2 * kBatch + j], b = rows[3 * kBatch + j];
      const float c = rows[4 * kBatch + j], op = rows[5 * kBatch + j];
      float col[D];
#pragma unroll
      for (int ch = 0; ch < D; ++ch) col[ch] = rows[(6 + ch) * kBatch + j];
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if (done[k]) continue;
        const bool stop = gs::composite_pair(
            px[k], py[k], mx, my, a, b, c, op, T[k], [&](const gs::Pair& p, float next_T) {
              const float vis = __fmul_rn(p.alpha, T[k]);
              // each product and sum rounded alone, in slot order: the
              // plain version's serial sum, bit for bit
#pragma unroll
              for (int ch = 0; ch < D; ++ch)
                acc[k][ch] = __fadd_rn(acc[k][ch], __fmul_rn(col[ch], vis));
              T[k] = next_T;
              if (COUNT) ++kept;
            });
        done[k] = done[k] || stop;
      }
    }
  }
  cp_async_wait<0>();  // nothing in flight into this CTA's buffers
  __syncthreads();     // every warp is past the staged rows: reuse them

  // each block's colours through shared memory, one block row (8 pixels'
  // D channels, contiguous in the image) at a time, coalesced
  float* out = smem + warp * 32 * D;
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const int block = warp + n_warps * k;
    if (block >= n_blocks) continue;  // the same for the whole warp
    const int x0 = tx * tile + (block % blocks_w) * 8;
    const int y0 = ty * tile + (block / blocks_w) * 4;
#pragma unroll
    for (int ch = 0; ch < D; ++ch) out[lane * D + ch] = acc[k][ch];
    __syncwarp();
    const int nv = min(8, width - x0) * D;  // the block row's elements in the image
    for (int r = 0; r < 4; ++r) {
      if (y0 + r >= height) break;
      float* dst = out_color + (((long long)im * height + y0 + r) * width + x0) * D;
      for (int e = lane; e < nv; e += 32) dst[e] = out[r * 8 * D + e];
    }
    __syncwarp();
    const int x = x0 + (lane & 7), y = y0 + (lane >> 3);
    if (x < width && y < height) out_t[((long long)im * height + y) * width + x] = T[k];
  }
  if (COUNT) {
    if (tr == 0) cta_kept = 0;
    __syncthreads();
    const int warp_kept = __reduce_add_sync(kFullMask, kept);
    if (lane == 0) atomicAdd(&cta_kept, warp_kept);  // integers: any order
    __syncthreads();
    if (tr == 0) pair_counts[t] = cta_kept;
  }
}

template <int D, bool COUNT, bool PACKED>
int launch(const float* fields, long long P, const int* bounds, int tile,
           int tiles_w, int tiles_per_image, int width, int height, int n_tiles,
           float* out_color, float* out_t, int* pair_counts, cudaStream_t stream) {
  const int threads = max(32, tile * tile / kPix);
  const size_t smem = smem_bytes<D, PACKED>(threads);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rasterize_fwd_kernel<D, COUNT, PACKED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rasterize_fwd_kernel<D, COUNT, PACKED><<<n_tiles, threads, smem, stream>>>(
      fields, P, bounds, tile, tiles_w, tiles_per_image, width, height,
      out_color, out_t, pair_counts);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// fields [6+D, P] f32 sorted slot rows (packed: [ceil((6+D)/2), P] bf16-pair
// carriers with tile-local means), bounds [n_tiles+1] i32 tile spans ->
// out_color [I, H, W, D] f32, out_t [I, H, W] f32 and, unless null,
// pair_counts [n_tiles] i32: the (pixel, slot) pairs that contributed in each
// tile (the backward's live pairs).  Tile 8, 16 or 32; D in [1, 32].
int gs_rasterize_fwd(const float* fields, long long P, const int* bounds,
                     int D, int tile, int tiles_w, int tiles_per_image,
                     int width, int height, int n_tiles, int packed, float* out_color,
                     float* out_t, int* pair_counts, cudaStream_t stream) {
  if (n_tiles == 0) return (int)cudaGetLastError();
  if (tile != 8 && tile != 16 && tile != 32) return (int)cudaErrorInvalidValue;
  const bool count = pair_counts != nullptr;
  switch (D) {
#define GS_LAUNCH(d, c, p) \
  launch<d, c, p>(fields, P, bounds, tile, tiles_w, tiles_per_image, width, height, n_tiles, out_color, out_t, pair_counts, stream)
#define GS_CASE(d) \
  case d:          \
    return packed ? (count ? GS_LAUNCH(d, true, true) : GS_LAUNCH(d, false, true)) \
                  : (count ? GS_LAUNCH(d, true, false) : GS_LAUNCH(d, false, false));
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
