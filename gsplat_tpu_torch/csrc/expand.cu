// Tight-plan row expansion (K3), emission expansion (K4) and AABB emission
// expansion (K8) for Hopper.
//
// K3 `expand_rows` replaces gsplat_tpu/ops/gather_pallas.py:_expand_rows_kernel
// (:396, wrapper expand_rows :526).  One thread per row record r: it finds
// its gaussian by binary search (the first g with gh_in[g] > r) and computes
// the exact x-interval of the alpha >= 1/255 ellipse over the record's tile
// row, in f32 and in the same order as the JAX kernel (:465-512).
//
// K4 `expand_emission` replaces gather_pallas.py:_expand2_kernel (:584,
// wrapper expand_emission2 :721), in both its layouts.  One thread per
// emission slot s: it finds its row record in rr_cum_in, computes the tile
// key (:652-665) and copies gaussian gid's 6+D render fields.  The search
// takes K8's prologue (search_brackets_kernel): one search of all R records
// per 256-slot CTA, all at once; the CTA then stages its records (at most
// 256: each covers a slot or more) in shared memory with coalesced loads, and
// each thread searches them there (where ~22 levels of R in device memory
// took the slot's thread before).  Dummy records and slots past n_slots carry the sentinel key and
// zeros.  The packed layout (PACKED, :691-716) writes ceil((6+D)/2) bf16-pair
// carriers instead (csrc/bf16pair.cuh): the mean made tile-local first,
// x - tx*tile and y - ty*tile in float32, then the rows paired in order, so
// the slot sort moves 5 rows for RGB instead of 9.  A slot without a record
// writes zero bits; a dummy's fields are zero and its tile origin 0, so it
// writes zero bits too.
//
// K8 `expand_emission_aabb` replaces gather_pallas.py:_expand_kernel (:120,
// wrapper expand_emission :216), the AABB emission of the 2DGS path.  One
// thread per emission slot s: a binary search of cum_in finds gaussian g,
// integer div/mod of s's position within g's run by the rect width gives
// the tile, and the slot takes g's key, depth, flat id and R field rows.  A
// slot at or past n_slots, or a dummy slot (a culled gaussian's one slot,
// image == n_images), gets the sentinel key, an infinite depth, id 0 and zero
// fields, by select: a NaN in a culled row never reaches a live slot.  (The
// TPU kernel's f32 _int_divmod, hi/lo transport and one-hot selection are
// TPU workarounds.)  Bound by device-memory bytes: its [R, cap] output.
// With R = 0 (no table) it writes only keys, depth and ids, 12 bytes a slot
// instead of 12 + 4R, and the search is its larger cost: a prologue finds
// the gaussian of each CTA's first slot (one search of all E rows per CTA,
// all at once), and each thread searches only between its CTA's and the
// next CTA's (a few rows, where 24 levels of E = 16.8 M took the slot's
// thread before).  This is the mode of the 2DGS and eval3d paths, whose gather
// into sorted order (csrc/align.cu, K9) reads each slot's fields from the
// gaussian-major table through the sort, so no emission-ordered copy of the
// fields is made.
//
// What bounds them on the H100: both move little data per thread and do
// little arithmetic (a ~20-step binary search, ~40 flops for K3, one
// F-float copy for K4), so they are bound by device-memory bytes: K3 by
// its [16, E] gaussian table and [5, R] output, K4 by its [F, cap] output
// ([ceil(F/2), cap] packed: the roundings are a few operations per word).
// The design keeps every write coalesced (thread i writes element i of each
// output row) and lets neighbouring threads share the binary-search path
// and the source gaussian, so those reads hit L1/L2.  The TPU's windowed
// one-hot selection and 12-bit integer transport are not needed: a GPU
// thread reads any address directly.
//
// Build with -fmad=false (see _build.py): every f32 operation of K3 rounds
// on its own, as PyTorch's elementwise ops do, so floor/ceil match the
// plain version exactly.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16pair.cuh"

namespace {

constexpr int kThreads = 256;  // a CTA's threads, one slot or row each

// Column order of K3's float table gg_f [10, E].
enum { GF_MX, GF_MY, GF_A, GF_B, GF_C, GF_SIG, GF_YEXT, GF_XEXT, GF_DET, GF_AABB };
// Column order of K3's int table gg_i [6, E].
enum { GI_EX, GI_IN, GI_RY0, GI_IM, GI_TMINX, GI_TMAXX };
// Row order of K4's record table rr [6, R].
enum { RR_EX, RR_IN, RR_X0, RR_TY, RR_IM, RR_GID };

// First index i in [0, n) with a[i] > v (n if none).
__device__ __forceinline__ long long upper_bound(const int* __restrict__ a,
                                                 long long n, long long v) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    long long mid = (lo + hi) >> 1;
    if ((long long)a[mid] > v) hi = mid; else lo = mid + 1;
  }
  return lo;
}

__device__ __forceinline__ float dx_hi(float u, float a, float b, float sig, float det) {
  float disc = fmaxf(2.0f * sig * a - det * u * u, 0.0f);
  return (-b * u + sqrtf(disc)) / a;
}

__device__ __forceinline__ float dx_lo(float u, float a, float b, float sig, float det) {
  float disc = fmaxf(2.0f * sig * a - det * u * u, 0.0f);
  return (-b * u - sqrtf(disc)) / a;
}

__global__ void expand_rows_kernel(const float* __restrict__ gg_f,
                                   const int* __restrict__ gg_i, long long E,
                                   const int* __restrict__ n_rows_p, long long row_cap,
                                   float ts, int n_images, int* __restrict__ out) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= row_cap) return;
  int x0 = 0, ty = 0, im = n_images, w = 0, gid = 0;
  const long long n_rows = *n_rows_p;
  const long long g = r < n_rows ? upper_bound(gg_i + GI_IN * E, E, r) : E;
  if (g < E) {
    gid = (int)g;
    im = gg_i[GI_IM * E + g];
    if (im == n_images) {  // dummy record: one sentinel slot
      w = 1;
    } else {
      const int q = (int)(r - gg_i[GI_EX * E + g]);
      ty = gg_i[GI_RY0 * E + g] + q;
      const int tminx = gg_i[GI_TMINX * E + g];
      const int tmaxx = gg_i[GI_TMAXX * E + g];
      int x1;
      if (gg_f[GF_AABB * E + g] > 0.5f) {
        x0 = tminx;
        x1 = tmaxx;
      } else {
        const float mx = gg_f[GF_MX * E + g];
        const float my = gg_f[GF_MY * E + g];
        const float a = fmaxf(gg_f[GF_A * E + g], 1e-12f);
        const float b = gg_f[GF_B * E + g];
        const float c = fmaxf(gg_f[GF_C * E + g], 1e-12f);
        const float sig = gg_f[GF_SIG * E + g];
        const float yext = gg_f[GF_YEXT * E + g];
        const float xext = gg_f[GF_XEXT * E + g];
        const float det = gg_f[GF_DET * E + g];

        const float u0 = (float)ty * ts - my;
        const float u1 = u0 + ts;
        const float uc0 = fminf(fmaxf(u0, -yext), yext);
        const float uc1 = fminf(fmaxf(u1, -yext), yext);
        const float u_star_hi = -(b / c) * xext;
        const float u_star_lo = (b / c) * xext;
        float hi = fmaxf(dx_hi(uc0, a, b, sig, det), dx_hi(uc1, a, b, sig, det));
        if (u_star_hi >= uc0 && u_star_hi <= uc1) hi = xext;
        float lo = fminf(dx_lo(uc0, a, b, sig, det), dx_lo(uc1, a, b, sig, det));
        if (u_star_lo >= uc0 && u_star_lo <= uc1) lo = -xext;
        hi = hi + 1e-3f;
        lo = lo - 1e-3f;
        x0 = (int)floorf((mx + lo) / ts);
        x0 = min(max(x0, tminx), max(tmaxx - 1, tminx));
        x1 = (int)ceilf((mx + hi) / ts);
        x1 = min(max(x1, x0 + 1), tmaxx);
      }
      w = max(x1 - x0, 1);
    }
  }
  out[0 * row_cap + r] = x0;
  out[1 * row_cap + r] = ty;
  out[2 * row_cap + r] = im;
  out[3 * row_cap + r] = w;
  out[4 * row_cap + r] = gid;
}

template <bool PACKED>
__global__ void expand_emission_kernel(const int* __restrict__ rr, long long R,
                                       const float* __restrict__ table_g, long long E,
                                       int F, const int* __restrict__ n_slots_p,
                                       long long cap, int tile_w, int tiles_per_im,
                                       int sentinel, int tile, const long long* __restrict__ br,
                                       int* __restrict__ keys, float* __restrict__ fields) {
  // The CTA's records [lo, lo + count): cum_in, cum_ex, x0, ty, im, gid.
  // Every live record covers a slot or more (K3's width is at least 1), so
  // the CTA's i-th slot lies in one of records lo to lo + i: its slots need
  // no more than kThreads records from lo.
  __shared__ int rec[6][kThreads];
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n_slots = *n_slots_p;
  const long long lo = br[blockIdx.x];
  const long long last = min(min(br[blockIdx.x + 1], R - 1), lo + kThreads - 1);
  const int count = lo < R ? (int)(last - lo + 1) : 0;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    rec[0][i] = rr[RR_IN * R + lo + i];
    rec[1][i] = rr[RR_EX * R + lo + i];
    rec[2][i] = rr[RR_X0 * R + lo + i];
    rec[3][i] = rr[RR_TY * R + lo + i];
    rec[4][i] = rr[RR_IM * R + lo + i];
    rec[5][i] = rr[RR_GID * R + lo + i];
  }
  __syncthreads();
  if (s >= cap) return;
  int key = sentinel;
  long long gid = -1;
  int tx = 0, ty = 0;
  if (s < n_slots) {
    int a = 0, b = count;  // the first staged record with cum_in > s
    while (a < b) {
      const int mid = (a + b) >> 1;
      if ((long long)rec[0][mid] > s) b = mid; else a = mid + 1;
    }
    if (a < count) {  // else no record holds the slot (past the last one)
      tx = rec[2][a] + (int)(s - rec[1][a]);
      ty = rec[3][a];
      key = min(rec[4][a] * tiles_per_im + ty * tile_w + tx, sentinel);
      gid = rec[5][a];
    }
  }
  keys[s] = key;
  if (PACKED) {
    for (int c = 0; 2 * c < F; ++c) {
      float carrier = 0.0f;  // zero bits
      if (gid >= 0) {
        float hi_f = table_g[(2 * c) * E + gid];
        float lo_f = 2 * c + 1 < F ? table_g[(2 * c + 1) * E + gid] : 0.0f;
        if (c == 0) {  // the mean in tile-local pixels
          hi_f = __fsub_rn(hi_f, (float)(tx * tile));
          lo_f = __fsub_rn(lo_f, (float)(ty * tile));
        }
        carrier = gs::pack_bf16_pair(hi_f, lo_f);
      }
      fields[c * cap + s] = carrier;
    }
  } else {
    for (int f = 0; f < F; ++f)
      fields[f * cap + s] = gid >= 0 ? table_g[f * E + gid] : 0.0f;
  }
}

// The search's prologue of K4 and K8: the record (K4) or gaussian (K8) of
// each CTA's first slot, br[b] = upper_bound(cum_in, E, b * per_cta) where
// that slot lies below min(cap, n_slots), else E.  Slot s of CTA b then has
// its own in [br[b], br[b + 1]]: one thread per CTA searches all E rows
// here, all CTAs at once, and the main kernel searches only between the two.
__global__ void search_brackets_kernel(const int* __restrict__ cum_in, long long E,
                                       const int* __restrict__ n_slots_p, long long cap,
                                       int per_cta, long long n_br, long long* __restrict__ br) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_br) return;
  const long long s0 = b * per_cta;
  br[b] = s0 < min(cap, (long long)*n_slots_p) ? upper_bound(cum_in, E, s0) : E;
}

__global__ void expand_aabb_kernel(const int* __restrict__ cum_in,
                                   const int* __restrict__ rect, long long E,
                                   const float* __restrict__ depth,
                                   const float* __restrict__ table, int R,
                                   const int* __restrict__ n_slots_p, long long cap,
                                   int tile_w, int tiles_per_im, int sentinel,
                                   const long long* __restrict__ br,
                                   int* __restrict__ keys, float* __restrict__ depth_out,
                                   int* __restrict__ flat, float* __restrict__ fields) {
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= cap) return;
  long long g = E;
  int key = sentinel;
  if (s < (long long)*n_slots_p) {
    const long long lo = br[blockIdx.x];
    g = lo + upper_bound(cum_in + lo, br[blockIdx.x + 1] - lo, s);
    if (g < E) {
      const long long ex = g > 0 ? cum_in[g - 1] : 0;
      const int within = (int)(s - ex);
      const int w_rect = max(rect[2 * E + g], 1);
      const int ty = rect[1 * E + g] + within / w_rect;
      const int tx = rect[0 * E + g] + within % w_rect;
      key = min(rect[3 * E + g] * tiles_per_im + ty * tile_w + tx, sentinel);
    }
  }
  const bool live = key < sentinel;
  keys[s] = key;
  depth_out[s] = live ? depth[g] : __int_as_float(0x7f800000);
  flat[s] = live ? (int)g : 0;
  for (int f = 0; f < R; ++f) fields[f * cap + s] = live ? table[f * E + g] : 0.0f;
}

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

const char* gs_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// gg_f [10, E] f32, gg_i [6, E] i32, n_rows [1] i32 (device) -> out [5, row_cap]
// i32 rows (x0, ty, im, w, gid).
int gs_expand_rows(const float* gg_f, const int* gg_i, long long E,
                   const int* n_rows, long long row_cap, float tile_size,
                   int n_images, int* out, cudaStream_t stream) {
  if (row_cap > 0)
    expand_rows_kernel<<<blocks_for(row_cap), kThreads, 0, stream>>>(
        gg_f, gg_i, E, n_rows, row_cap, tile_size, n_images, out);
  return (int)cudaGetLastError();
}

// rr [6, R] i32 (cum_ex, cum_in, x0, ty, im, gid), table_g [F, E] f32,
// n_slots [1] i32 (device), scratch br [n_br] i64 with n_br >= ceil(cap /
// 256) + 1 -> keys [cap] i32 and fields [F, cap] f32, or with `packed` the
// bf16-pair carriers [ceil(F/2), cap] with tile-local means (tile: the tile
// size in pixels).
int gs_expand_emission(const int* rr, long long R, const float* table_g,
                       long long E, int F, const int* n_slots, long long cap,
                       int tile_w, int tiles_per_im, int sentinel, int packed, int tile,
                       long long* br, long long n_br, int* keys, float* fields,
                       cudaStream_t stream) {
  if (cap > 0) {
    const long long blocks = blocks_for(cap);
    if (n_br < blocks + 1) return (int)cudaErrorInvalidValue;
    search_brackets_kernel<<<blocks_for(blocks + 1), kThreads, 0, stream>>>(
        rr + RR_IN * R, R, n_slots, cap, kThreads, blocks + 1, br);
    if (packed)
      expand_emission_kernel<true><<<(unsigned int)blocks, kThreads, 0, stream>>>(
          rr, R, table_g, E, F, n_slots, cap, tile_w, tiles_per_im, sentinel, tile, br,
          keys, fields);
    else
      expand_emission_kernel<false><<<(unsigned int)blocks, kThreads, 0, stream>>>(
          rr, R, table_g, E, F, n_slots, cap, tile_w, tiles_per_im, sentinel, tile, br,
          keys, fields);
  }
  return (int)cudaGetLastError();
}

// cum_in [E] i32 inclusive cumsum of max(cnt, 1), rect [4, E] i32 (tminx,
// tminy, w_rect, im), depth [E] f32, table [R, E] f32, n_slots [1] i32
// (device), scratch br [n_br] i64 with n_br >= ceil(cap / 256) + 1 -> keys
// [cap] i32, depth_out [cap] f32, flat [cap] i32, fields [R, cap] f32
// (R = 0: no table and no fields).
int gs_expand_aabb(const int* cum_in, const int* rect, long long E,
                   const float* depth, const float* table, int R, const int* n_slots,
                   long long cap, int tile_w, int tiles_per_im, int sentinel,
                   long long* br, long long n_br, int* keys, float* depth_out, int* flat,
                   float* fields, cudaStream_t stream) {
  if (cap > 0) {
    const long long blocks = blocks_for(cap);
    if (n_br < blocks + 1) return (int)cudaErrorInvalidValue;
    search_brackets_kernel<<<blocks_for(blocks + 1), kThreads, 0, stream>>>(
        cum_in, E, n_slots, cap, kThreads, blocks + 1, br);
    expand_aabb_kernel<<<(unsigned int)blocks, kThreads, 0, stream>>>(
        cum_in, rect, E, depth, table, R, n_slots, cap, tile_w, tiles_per_im, sentinel, br,
        keys, depth_out, flat, fields);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
