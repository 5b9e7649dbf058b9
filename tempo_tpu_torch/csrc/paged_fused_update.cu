// Paged fused span-metrics update: one pass over a span batch updates the
// whole span-metrics plane family in the page pool's arenas.
//
// Replaces the Pallas TPU kernel `paged_fused_update`
// (tempo_tpu/ops/pallas_kernels.py:196, pallas_call at :404). That kernel
// walks every logical page of the series table as a sequential grid step,
// rescans all N spans for each page and accumulates a
// [page_rows, 4 + hist + 1 + dd_buckets + k+1] one-hot product in VMEM
// before it writes each page back once. On Hopper that design does not
// carry over: the page accumulator is ~1.3 MB at the default widths
// (256 rows x 1304 features x 4 B), far above a block's 227 KB of shared
// memory, and the rescan is O(N * pages).
//
// What bounds it here: bytes. Each span reads 16 B of batch and does a
// read-modify-write of one 4 B cell in each of up to 7 role arenas, plus
// k+3 cells of the moments row; the arithmetic is a few dozen f32 ops per
// span. The least time is the batch plus the touched cells (each read and
// written once) over 3.35 TB/s; under the compact tier every row of every
// backed page of the latency-sum pair is read and written too (below).
//
// Design (first, simple and correct).
//
// f32 state (`compact` 0): one launch, one thread per span, blocks of 256.
// The thread translates its slot through each role's page table once and
// adds its contributions straight into the arena cells with f32
// atomicAdd. A role whose table entry is <= 0 (unbacked, or padding) is
// skipped, so physical page 0, the trash page, is never written. The
// moments row (slots below mom_rows) takes T_0..T_k of the clipped log
// duration times the weight by atomicAdd, and its two support bounds,
// max(z - lo, 0) and max(hi - z, 0), unweighted, by atomicMax on the int
// bits: both columns are >= +0 with 0 meaning empty, and for non-negative
// IEEE floats the int order is the float order.
//
// Compact state (`compact` 1: int32 counts, the latency sum as a bf16
// (sum, compensation) Kahan pair, sizes and moments f32): two launches.
// The TPU kernel rounds each cell's WHOLE-DISPATCH f32 delta once
// (`_round_i32`, :190-193, applied at :342) — per-span rounding would turn
// three spans of weight 0.25 into 0 instead of 1 — and it runs the Kahan
// step on EVERY row of every backed page of the pair role each dispatch,
// untouched rows included (:352-361), which re-normalises a pair whose
// compensation has grown. So per-span atomics cannot go into the arena.
//   Pass 1 (`paged_fused_update_kernel`, the same span pass) adds every
//   contribution into a zeroed f32 scratch that the wrapper allocates,
//   indexed by LOGICAL row of each role: [n_lrows] or [rows_r, width_r]
//   per role, ~89 MB at the default widths (83 MB of it the DDSketch
//   grid, 16,384 x 1,269 x 4 B). Unbacked pages are skipped here too.
//   Pass 2 (`paged_fused_update_fold_kernel`) runs on a 2-D grid: y is the
//   role, x walks the role's logical pages in chunks of FOLD_CHUNK
//   elements (a page of role r is page_rows x width_r contiguous scratch
//   elements, and a backed page's arena rows are contiguous too, so an
//   element's arena offset is the page base plus its offset in the page).
//   A chunk on an unbacked page is skipped whole. Each element is folded
//   under its role's rule: int32 += __float2int_rn(delta) (round half to
//   even, as jnp.round; not roundf, which rounds half away from zero); the
//   pair takes y = delta + comp, tot = sum + y, comp' = y - (tot - sum) in
//   f32 and stores both with __float2bfloat16_rn; f32 += delta; the
//   moments bounds take the max. Elements with delta 0 write nothing
//   except the pair, which is folded on every backed row.
// What bounds this design: the scratch. Its zeroing and the fold's read
// of its backed pages move up to ~2 x 89 MB per dispatch at the default
// widths, against a few hundred KB of cells the batch touches. A fold
// that visits only touched elements (a compacted list, or spans bucketed
// by logical page with one block per touched page), with no zeroing, is
// the faster design for later.
//
// Numerics. Integer-count planes stay exact under atomics for integer
// weights while each cell is below 2^24; float sums take their adds in no
// fixed order. The DDSketch bucket follows the reference's f32 op order,
// ceil(logf(max(v, min) / min) / f32(log gamma)), and the moments basis
// z = logf(clip(v, f32(e^lo), f32(e^hi))), s = clip((z - f32(c)) / f32(h),
// -1, 1), T_j = (2 s) T_{j-1} - T_{j-2}, with IEEE logf and division and
// no contraction: build without --use_fast_math, with -ftz=false
// -prec-div=true -fmad=false.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define PFU_MAX_EDGES 64
#define PFU_MAX_ROLES 8
#define PFU_MAX_K 32
#define PFU_BLOCK 256

// must match `_pfu_params` in tempo_tpu_torch/ops/cuda_kernels.py
struct PfuParams {
  int n;            // spans in the batch
  int n_roles;      // 5, +2 with the DDSketch planes, +1 with moments
  int p_pages;      // logical pages per table row
  int page_shift;   // log2(page_rows)
  int dd_rows;      // slots below this feed the DDSketch planes (0 = off)
  int nb_dd;        // DDSketch buckets per row
  int n_edges;      // latency histogram edges (buckets = n_edges + 1)
  int mom_rows;     // slots below this feed the moments row (0 = off)
  int mom_k;        // Chebyshev moments; the row is k + 3 wide
  int compact;      // 1: write f32 deltas by logical row into scratch
  float min_value;  // DDSketch min value
  float log_gamma;  // f32(log gamma)
  float mom_vmin;   // f32(exp(lo))
  float mom_vmax;   // f32(exp(hi))
  float mom_c;      // f32((lo + hi) / 2)
  float mom_h;      // f32((hi - lo) / 2)
  float mom_lo;     // f32(lo)
  float mom_hi;     // f32(hi)
  float edges[PFU_MAX_EDGES];
};

struct PfuDst {
  float* role[PFU_MAX_ROLES];  // arena (f32 state) or scratch (compact)
};

__global__ void __launch_bounds__(PFU_BLOCK)
paged_fused_update_kernel(const PfuParams p, const PfuDst dst,
                          const int* __restrict__ tables,
                          const float* __restrict__ slots_f,
                          const int* __restrict__ slots_i,
                          const float* __restrict__ vals) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  // packed batches carry slot ids as f32 (exact below 2^24)
  const int s = slots_f != nullptr ? (int)slots_f[i] : slots_i[i];
  if (s < 0) return;
  const int lp = s >> p.page_shift;
  if (lp >= p.p_pages) return;
  const int64_t off = s & ((1 << p.page_shift) - 1);
  const float dur = vals[i];
  const float size = vals[p.n + i];
  const float w = vals[2 * p.n + i];

  // target row of role r: the physical arena row, or the logical row of
  // the compact scratch; -1 when the role's page is unbacked
  auto row = [&](int r) -> int64_t {
    const int phys = tables[r * p.p_pages + lp];
    if (phys <= 0) return -1;
    return p.compact ? (int64_t)s : (((int64_t)phys << p.page_shift) | off);
  };

  int64_t r;
  if ((r = row(0)) >= 0) atomicAdd(dst.role[0] + r, w);
  if ((r = row(1)) >= 0) atomicAdd(dst.role[1] + r, dur * w);
  if ((r = row(2)) >= 0) atomicAdd(dst.role[2] + r, w);
  if ((r = row(3)) >= 0) atomicAdd(dst.role[3] + r, size * w);
  if ((r = row(4)) >= 0) {
    int b = 0;
    for (int e = 0; e < p.n_edges; ++e) b += dur > p.edges[e];
    atomicAdd(dst.role[4] + r * (p.n_edges + 1) + b, w);
  }
  if (p.dd_rows > 0 && s < p.dd_rows) {
    if (dur <= p.min_value) {
      if ((r = row(5)) >= 0) atomicAdd(dst.role[5] + r, w);
    } else if ((r = row(6)) >= 0) {
      float idx = ceilf(logf(fmaxf(dur, p.min_value) / p.min_value) /
                        p.log_gamma);
      idx = fminf(fmaxf(idx, 0.0f), (float)(p.nb_dd - 1));
      atomicAdd(dst.role[6] + r * p.nb_dd + (int64_t)idx, w);
    }
  }
  const int mr = p.n_roles - 1;
  if (p.mom_rows > 0 && s < p.mom_rows && (r = row(mr)) >= 0) {
    float* m = dst.role[mr] + r * (p.mom_k + 3);
    const float z = logf(fminf(fmaxf(dur, p.mom_vmin), p.mom_vmax));
    const float sv = fminf(fmaxf((z - p.mom_c) / p.mom_h, -1.0f), 1.0f);
    atomicAdd(m, w);
    atomicAdd(m + 1, sv * w);
    const float two_s = 2.0f * sv;
    float t2 = 1.0f, t1 = sv;
    for (int j = 2; j <= p.mom_k; ++j) {
      const float t = two_s * t1 - t2;
      atomicAdd(m + j, t * w);
      t2 = t1;
      t1 = t;
    }
    const float b1 = fmaxf(z - p.mom_lo, 0.0f);
    const float b2 = fmaxf(p.mom_hi - z, 0.0f);
    atomicMax((int*)(m + p.mom_k + 1), __float_as_int(b1));
    atomicMax((int*)(m + p.mom_k + 2), __float_as_int(b2));
  }
}

// fold kinds: must match `_FOLD_KIND` / `_FOLD_MOMENTS` in cuda_kernels.py
#define FOLD_INT32 0
#define FOLD_PAIR 1
#define FOLD_F32 2
#define FOLD_MOMENTS 3

// elements a fold block takes from one page, FOLD_PER_THREAD per thread
#define FOLD_PER_THREAD 8
#define FOLD_CHUNK (PFU_BLOCK * FOLD_PER_THREAD)

struct FoldParams {
  int p_pages;
  int page_shift;
  int mom_k;
  void* arena[PFU_MAX_ROLES];
  const float* delta[PFU_MAX_ROLES];  // role r's scratch, [rows, width]
  int64_t rows[PFU_MAX_ROLES];        // logical rows of role r's scratch
  int width[PFU_MAX_ROLES];           // delta columns (the pair: 1)
  int kind[PFU_MAX_ROLES];
};

__global__ void __launch_bounds__(PFU_BLOCK)
paged_fused_update_fold_kernel(const FoldParams p,
                               const int* __restrict__ tables) {
  const int r = blockIdx.y;
  const int width = p.width[r];
  const int kind = p.kind[r];
  const int page_rows = 1 << p.page_shift;
  const int page_elems = page_rows * width;
  const int per_page = (page_elems + FOLD_CHUNK - 1) / FOLD_CHUNK;
  const int64_t n_lp = (p.rows[r] + page_rows - 1) >> p.page_shift;
  for (int64_t b = blockIdx.x; b < n_lp * per_page; b += gridDim.x) {
    const int64_t lp = b / per_page;
    const int phys = tables[r * p.p_pages + lp];
    if (phys <= 0) continue;
    // the role's last page may hold fewer than page_rows logical rows
    const int64_t left = p.rows[r] - (lp << p.page_shift);
    const int n = (int)(left < page_rows ? left : page_rows) * width;
    const int lo = (int)(b - lp * per_page) * FOLD_CHUNK + threadIdx.x;
    const float* __restrict__ d = p.delta[r] + lp * page_elems;
    const int64_t base = ((int64_t)phys << p.page_shift) * width;
    float v[FOLD_PER_THREAD];
#pragma unroll
    for (int j = 0; j < FOLD_PER_THREAD; ++j) {
      const int i = lo + j * PFU_BLOCK;
      v[j] = i < n ? d[i] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < FOLD_PER_THREAD; ++j) {
      const int i = lo + j * PFU_BLOCK;
      if (i >= n) break;
      const float x = v[j];
      switch (kind) {
        case FOLD_PAIR: {  // width 1: the pair of arena row base + i
          __nv_bfloat16* a = (__nv_bfloat16*)p.arena[r] + (base + i) * 2;
          const float sum = __bfloat162float(a[0]);
          const float comp = __bfloat162float(a[1]);
          const float y = x + comp;
          const float tot = sum + y;
          const float comp_new = y - (tot - sum);
          a[0] = __float2bfloat16_rn(tot);
          a[1] = __float2bfloat16_rn(comp_new);
          break;
        }
        case FOLD_INT32:
          if (x != 0.0f) ((int*)p.arena[r])[base + i] += __float2int_rn(x);
          break;
        case FOLD_F32:
          if (x != 0.0f) ((float*)p.arena[r])[base + i] += x;
          break;
        case FOLD_MOMENTS:
          if (x != 0.0f) {
            float* a = (float*)p.arena[r] + base + i;
            *a = i % width <= p.mom_k ? *a + x : fmaxf(*a, x);
          }
          break;
      }
    }
  }
}

extern "C" {

// Launch the span pass on `stream`; returns cudaGetLastError() (0 =
// launched). `params` holds a PfuParams of `params_bytes`; `dst` the
// n_roles target pointers.
int paged_fused_update_launch(const void* params, int params_bytes,
                              const int* tables, const float* slots_f,
                              const int* slots_i, const float* vals,
                              float* const* dst, void* stream) {
  if (params_bytes != (int)sizeof(PfuParams)) return (int)cudaErrorInvalidValue;
  PfuParams p;
  memcpy(&p, params, sizeof p);
  if (p.n_edges < 0 || p.n_edges > PFU_MAX_EDGES) return (int)cudaErrorInvalidValue;
  const int want = 5 + (p.dd_rows > 0 ? 2 : 0) + (p.mom_rows > 0 ? 1 : 0);
  if (p.n_roles != want || p.mom_k < 0 || p.mom_k > PFU_MAX_K)
    return (int)cudaErrorInvalidValue;
  PfuDst d;
  for (int r = 0; r < PFU_MAX_ROLES; ++r) d.role[r] = r < p.n_roles ? dst[r] : nullptr;
  if (p.n > 0) {
    const int blocks = (p.n + PFU_BLOCK - 1) / PFU_BLOCK;
    paged_fused_update_kernel<<<blocks, PFU_BLOCK, 0, (cudaStream_t)stream>>>(
        p, d, tables, slots_f, slots_i, vals);
  }
  return (int)cudaGetLastError();
}

// Launch the compact fold on `stream`; returns cudaGetLastError().
// `deltas[r]` is role r's scratch, `rows[r]` x `widths[r]` f32.
int paged_fused_update_fold_launch(void* const* arenas,
                                   const float* const* deltas,
                                   const long long* rows,
                                   const long long* widths,
                                   const long long* kinds, int n_roles,
                                   int p_pages, int page_shift, int mom_k,
                                   const int* tables, void* stream) {
  if (n_roles < 5 || n_roles > PFU_MAX_ROLES) return (int)cudaErrorInvalidValue;
  FoldParams p;
  memset(&p, 0, sizeof p);
  p.p_pages = p_pages;
  p.page_shift = page_shift;
  p.mom_k = mom_k;
  int64_t chunks = 0;  // the most chunks of any role
  for (int r = 0; r < n_roles; ++r) {
    p.arena[r] = arenas[r];
    p.delta[r] = deltas[r];
    p.rows[r] = rows[r];
    p.width[r] = (int)widths[r];
    p.kind[r] = (int)kinds[r];
    const int64_t page_elems = (int64_t)widths[r] << page_shift;
    if (page_elems > INT32_MAX) return (int)cudaErrorInvalidValue;
    const int64_t n_lp = (rows[r] + (1 << page_shift) - 1) >> page_shift;
    const int64_t c = n_lp * ((page_elems + FOLD_CHUNK - 1) / FOLD_CHUNK);
    if (c > chunks) chunks = c;
  }
  if (chunks > 0) {
    int sms = 132;
    int dev = 0;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int64_t cap = (int64_t)sms * 8;
    const dim3 grid((unsigned)(chunks < cap ? chunks : cap), n_roles);
    paged_fused_update_fold_kernel<<<grid, PFU_BLOCK, 0,
                                     (cudaStream_t)stream>>>(p, tables);
  }
  return (int)cudaGetLastError();
}

const char* kernel_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
