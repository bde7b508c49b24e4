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
// What bounds it on the H100: operations.  Every evaluated (pixel, slot)
// pair costs the forward's ~21 f32 operations again; a live pair needs
// 29 + 3D more for its gradient terms (38 at D = 3) and one add into each of
// its 6+D per-slot sums, against 2*(6+D) floats of traffic per slot.
//
// Design (K6b's, csrc/rasterize2d_bwd.cu).  One CTA per tile (8, 16 or 32
// pixels square); each thread owns kPix pixels, one in each of kPix 8x4
// blocks of the tile, so that much of each per-slot sum is taken in
// registers, and a warp's 32 lanes cover one pixel of each of its blocks
// (at tile 8, whose two blocks one warp covers, the rest are idle).  A
// slot's fields, colours included, are read once per thread for all its
// pixels.  kPix is 8 for the packed payload, whose fields are unpacked
// where read, and 4 for float32 rows: on an H100, packed at the 3DGS step's
// 4k inputs 8 took 9.88 ms where 4 took 10.42 (and two 12.85), float32 4
// took 9.48 at 4k and 2.94 on the AV cameras where 8 took 9.52 and 3.34
// (PERF.md): more pixels share a slot's reads and reduction, fewer leave
// more warps to hide the latency of light tiles.  The tile's span
// is walked in batches of kBatch slots, staged into shared memory with
// cp.async and double-buffered: the next batch's rows are in flight while
// this one is replayed.  For each slot a thread replays each of its pixels
// that has not stopped through csrc/composite.cuh, exactly as the forward
// (rasterize_fwd.cu) decides gate and stop, and adds each live pixel's terms
// into its own 6+D partial sums.  A warp with a live lane then reduces those
// 6+D values across its lanes by recursive halving (a reduce-scatter:
// ceil(F/2) + ceil(F/4) + ... shuffles, 12 for F = 9, where one shuffle tree
// per value took 5F = 45), which leaves each row's warp sum on one lane; that
// lane writes it to shared memory.  At the batch's end one thread per (row,
// slot) adds the warps' sums in warp order and writes the row, coalesced.
// Every sum has a fixed order, so the result is the same bits from run to
// run.  The gradient chain, which decides nothing, takes one approximate
// reciprocal 1/(1-alpha) per live pair (one MUFU instruction, about an ulp);
// the decisions keep composite.cuh's rounded intrinsics.
//
// A warp whose pixels have all stopped skips the batch; the CTA leaves once
// all its pixels have, writing zeros over the rest of its span.  The CTAs
// also write the zeros of the slots outside every span, so the wrapper
// allocates the output without clearing it.
//
// The TPU kernel's 256-lane chunks, its carry between neighbouring tiles,
// bf16 splits and moment basis exist for the TPU's matrix unit and ordered
// grid and are not carried over.
//
// Packed modes (rasterize_pallas.py:_bwd_kernel packed=True :613-624,
// :669-670, and pack_grads :690-709).  PACKED stages the packed payload
// that the packed forward read (ceil((6+D)/2) bf16-pair carriers per slot,
// means in tile-local pixels) and unpacks a field where it reads it, so it
// replays the packed forward's decisions with tile-local pixel centres;
// dx = px - mx is translation invariant, so the means' gradient read in the
// tile-local frame is the gradient of the caller's means.  `pack_grads`
// writes the 6+D per-slot sums, after the same fixed-order reduction, as
// ceil((6+D)/2) bf16-pair carriers of the rows paired in order
// (csrc/bf16pair.cuh): half the output bytes and half the rows that the
// scatter back to emission order moves.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16pair.cuh"
#include "composite.cuh"

namespace {

// pixels per thread, one in each of kPix 8x4 blocks; threads and warps of
// a CTA at tile 32
template <bool PACKED>
constexpr int kPix = PACKED ? 8 : 4;
template <bool PACKED>
constexpr int kMaxThreads = 32 * 32 / kPix<PACKED>;
template <bool PACKED>
constexpr int kMaxWarps = kMaxThreads<PACKED> / 32;
constexpr int kBatch = 64;            // slots staged per batch: one live bit each
constexpr int kPStride = kBatch + 1;  // a warp-sum row in shared memory, padded
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

// 1/x to about an ulp, one MUFU instruction: the gradient chain's
// reciprocal (decisions never read it)
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

template <int D, bool PACKED>
__global__ void __launch_bounds__(kMaxThreads<PACKED>)
rasterize_bwd_kernel(const float* __restrict__ fields, long long P,
                     const int* __restrict__ bounds, int n_tiles, int tile, int tiles_w,
                     int tiles_per_image, int width, int height, bool pack_grads,
                     const float* __restrict__ v_pix, const float* __restrict__ v_t,
                     const float* __restrict__ pix_out, const float* __restrict__ t_final,
                     float* __restrict__ v_slot, int* __restrict__ live_counts) {
  constexpr int F = 6 + D;
  constexpr int R = (F + 1) / 2;         // carriers per slot, of the payload and of the gradients
  constexpr int SR = PACKED ? R : F;     // staged rows per slot
  extern __shared__ unsigned long long smem_u64[];
  constexpr int NP = kPix<PACKED>;  // pixels per thread
  unsigned long long* live_bits = smem_u64;                   // [kMaxWarps]
  float* stage = (float*)(smem_u64 + kMaxWarps<PACKED>);       // [2][SR][kBatch]
  float* partial = stage + 2 * SR * kBatch;                  // [n_warps][F][kPStride]

  const int B = blockDim.x;
  const int n_warps = B >> 5;
  const int n_blocks = tile * tile / 32;
  const int t = blockIdx.x;
  const int tr = threadIdx.x;
  const int lane = tr & 31;
  const int warp = tr >> 5;

  const int im = t / tiles_per_image;
  const int tl = t - im * tiles_per_image;
  const int ty = tl / tiles_w;
  const int tx = tl - ty * tiles_w;
  // warp w takes the 8x4 pixel blocks w + n_warps * k < n_blocks of the
  // tile (tile / 8 blocks across), lane l pixel (l % 8, l / 8) of each
  const int blocks_w = tile >> 3;

  // per pixel: the replay's state, the cotangents and the forward's outputs
  bool done[NP];
  float T[NP], px[NP], py[NP], vp[NP][D], dtot[NP], vt_term[NP], E[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
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
    dtot[k] = vt_term[k] = E[k] = 0.0f;
#pragma unroll
    for (int c = 0; c < D; ++c) vp[k][c] = 0.0f;
    if (inside) {
      const long long pix = ((long long)im * height + y) * width + x;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        vp[k][c] = v_pix[pix * D + c];
        dtot[k] += vp[k][c] * pix_out[pix * D + c];
      }
      vt_term[k] = v_t[pix] * t_final[pix];
    }
    done[k] = !inside;
  }
  int n_live = 0;
  int held_first = 0, held_n = F;
  held_rows<F, 16>(lane, &held_first, &held_n);

  // field f of staged slot j, unpacked where it is read
  auto field = [&](const float* st, int f, int j) -> float {
    if (PACKED) {
      const float carrier = st[(f >> 1) * kBatch + j];
      return (f & 1) ? gs::bf16_lo(carrier) : gs::bf16_hi(carrier);
    }
    return st[f * kBatch + j];
  };

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

  const int out_rows = pack_grads ? R : F;
  int batch = 0;
  for (; batch < n_batches; ++batch) {
    bool mine_done = true;
#pragma unroll
    for (int k = 0; k < NP; ++k) mine_done = mine_done && done[k];
    // also the barrier after which the batch before's buffers may be reused
    if (__syncthreads_count(mine_done) == B) break;
    if (batch + 1 < n_batches) stage_batch(batch + 1);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of `batch` have landed
    __syncthreads();     // and everyone's

    const int base = start + batch * kBatch;
    const int n = min(kBatch, end - base);
    const float* st = stage + (batch & 1) * SR * kBatch;
    unsigned long long warp_live = 0;
    if (!__all_sync(kFullMask, mine_done)) {
      for (int j = 0; j < n; ++j) {
        float acc[F];
#pragma unroll
        for (int r = 0; r < F; ++r) acc[r] = 0.0f;
        bool live = false;
        bool need = false;
#pragma unroll
        for (int k = 0; k < NP; ++k) need = need || !done[k];
        if (need) {
          // the slot's response and colours, read once for all NP pixels
          const float mx = field(st, 0, j), my = field(st, 1, j);
          const float a = field(st, 2, j), b = field(st, 3, j), c = field(st, 4, j);
          const float op = field(st, 5, j);
          float col[D];
#pragma unroll
          for (int ch = 0; ch < D; ++ch) col[ch] = field(st, 6 + ch, j);
#pragma unroll
          for (int k = 0; k < NP; ++k) {
            if (done[k]) continue;
            const bool stop = gs::composite_pair(
                px[k], py[k], mx, my, a, b, c, op, T[k], [&](const gs::Pair& p, float next_T) {
                  live = true;
                  ++n_live;
                  const float Tk = T[k];
                  const float w = p.alpha * Tk;
                  float d = 0.0f;
#pragma unroll
                  for (int ch = 0; ch < D; ++ch) {
                    d += vp[k][ch] * col[ch];
                    acc[6 + ch] += vp[k][ch] * w;
                  }
                  E[k] += w * d;
                  const float ra = fast_rcp(1.0f - p.alpha);  // alpha <= 0.99
                  const float v_alpha = d * Tk - (dtot[k] - E[k]) * ra - vt_term[k] * ra;
                  if (!p.clamped) {
                    // s = -v_sigma; sigma depends on the mean through
                    // dx = px - mx.  Rows 2 to 4 add s dx^2, s dx dy, s dy^2:
                    // their sums take -1/2, -1, -1/2 at the batch's end
                    const float s = p.alpha * v_alpha;
                    const float t1 = s * p.dx, t2 = s * p.dy;
                    acc[5] += p.vis * v_alpha;
                    acc[0] += a * t1 + b * t2;
                    acc[1] += c * t2 + b * t1;
                    acc[2] += t1 * p.dx;
                    acc[3] += t1 * p.dy;
                    acc[4] += t2 * p.dy;
                  }
                  T[k] = next_T;
                });
            done[k] = done[k] || stop;
          }
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

    // the warps' sums, added in warp order, one output element a thread
    // (rows 2 to 4 scaled as the replay left them: exact, a power of two)
    auto slot_sum = [&](int f, int j) {
      float sum = 0.0f;
      for (int wi = 0; wi < n_warps; ++wi) {
        if ((live_bits[wi] >> j) & 1ull) sum += partial[((size_t)wi * F + f) * kPStride + j];
      }
      return f == 2 || f == 4 ? -0.5f * sum : f == 3 ? -sum : sum;
    };
    for (int o = tr; o < out_rows * kBatch; o += B) {
      const int r = o / kBatch;
      const int j = o - r * kBatch;
      if (j >= n) continue;
      if (pack_grads) {
        const float lo = 2 * r + 1 < F ? slot_sum(2 * r + 1, j) : 0.0f;
        v_slot[r * P + base + j] = gs::pack_bf16_pair(slot_sum(2 * r, j), lo);
      } else {
        v_slot[r * P + base + j] = slot_sum(r, j);
      }
    }
  }
  cp_async_wait<0>();  // nothing in flight into this CTA's buffers

  // the rest of the span, which no live pair reaches, reads 0 (zero bits)
  const int rest = start + batch * kBatch;
  for (int r = 0; r < out_rows; ++r)
    for (int s = rest + tr; s < end; s += B) v_slot[r * P + s] = 0.0f;
  // this CTA's share of the slots outside every span
  const long long lead = bounds[0];
  const long long outside = lead + (P - bounds[n_tiles]);
  const long long q_lo = outside * t / n_tiles;
  const long long q_hi = outside * (t + 1) / n_tiles;
  for (int r = 0; r < out_rows; ++r)
    for (long long q = q_lo + tr; q < q_hi; q += B)
      v_slot[r * P + (q < lead ? q : bounds[n_tiles] + (q - lead))] = 0.0f;

  if (live_counts != nullptr) {
    const int total = cta_count(n_live);
    if (tr == 0) live_counts[t] = total;
  }
}

template <int D, bool PACKED>
int launch(const float* fields, long long P, const int* bounds, int tile,
           int tiles_w, int tiles_per_image, int width, int height, int n_tiles,
           bool pack_grads, const float* v_pix, const float* v_t, const float* pix_out,
           const float* t_final, float* v_slot, int* live_counts, cudaStream_t stream) {
  constexpr int F = 6 + D;
  constexpr int SR = PACKED ? (F + 1) / 2 : F;
  const int threads = max(32, tile * tile / kPix<PACKED>);
  const int n_warps = threads / 32;
  const size_t smem = sizeof(unsigned long long) * kMaxWarps<PACKED> +
                      sizeof(float) * (2 * SR * kBatch + n_warps * F * kPStride);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(rasterize_bwd_kernel<D, PACKED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rasterize_bwd_kernel<D, PACKED><<<n_tiles, threads, smem, stream>>>(
      fields, P, bounds, n_tiles, tile, tiles_w, tiles_per_image, width, height, pack_grads,
      v_pix, v_t, pix_out, t_final, v_slot, live_counts);
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
// (every element written: zeros where no live pair reaches) and, unless
// null, live_counts [n_tiles] i32: the live (pixel, slot) pairs of each
// tile.  Tile 8, 16 or 32; D in [1, 32].
int gs_rasterize_bwd(const float* fields, long long P, const int* bounds,
                     int D, int tile, int tiles_w, int tiles_per_image,
                     int width, int height, int n_tiles, int packed, int pack_grads,
                     const float* v_pix, const float* v_t, const float* pix_out,
                     const float* t_final, float* v_slot, int* live_counts,
                     cudaStream_t stream) {
  if (n_tiles == 0) return (int)cudaGetLastError();
  if (tile != 8 && tile != 16 && tile != 32) return (int)cudaErrorInvalidValue;
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
