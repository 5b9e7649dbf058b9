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
// Design. One thread per span (`pfu_span_kernel`), blocks of 256, one
// launch per dispatch under f32 state and two under compact state.
// `span_cells` (the slot's row: logical page, row in the page, the span's
// values) and `span_columns` (latency bucket, DDSketch role and column)
// say which cells a span adds to; both passes call them, so the two cannot
// disagree. A role whose table entry is <= 0 (unbacked, or padding) is
// skipped, so physical page 0, the trash page, is never written. The row
// roles' atomics go out before the columns' arithmetic (a logf), so the
// two overlap. With the moments row on, each block first stages the
// [R, P] tables in dynamic shared memory (8 KB at the default widths; the
// wrapper refuses tables above PFU_MAX_SMEM); without it the tables are
// read from global memory, which measured faster there.
//
// f32 state (`compact` 0): every contribution goes straight into the arena
// cells: f32 atomicAdd (fire-and-forget reductions), and the two moments
// support bounds, max(z - lo, 0) and max(hi - z, 0), unweighted, by
// atomicMax on the int bits (both columns are >= +0 with 0 meaning empty,
// and for non-negative IEEE floats the int order is the float order). The
// moments row's k+1 sums go out as float4 atomicAdds on its 16-byte-aligned
// quads (Hopper adds vectors in global memory) and scalars on its ragged
// ends: 4-7 atomics a span instead of 13 at k = 12.
//
// Compact state (`compact` 1: int32 counts, the latency sum as a bf16
// (sum, compensation) Kahan pair, sizes and moments f32). The TPU kernel
// rounds each cell's WHOLE-DISPATCH f32 delta once (`_round_i32`,
// :190-193, applied at :342) — per-span rounding would turn three spans of
// weight 0.25 into 0 instead of 1 — and runs the Kahan step on EVERY row of
// every backed page of the pair role each dispatch, untouched rows
// included (:352-361). So the int32 roles and the pair go through a
// persistent f32 scratch indexed by logical row, which the caller allocates
// zeroed once and which is all zero between dispatches. Sizes and the
// moments row take their atomics straight into the arena, as under f32
// state (old + each delta, in no fixed order: the f32 contract; the
// bounds' max is exact either way).
//   Pass 1 (`pfu_span_kernel`) adds the int32 roles' and the pair's
//   contributions into the scratch.
//   Pass 2 (`pfu_fold_kernel`), one launch in two parts:
//   (a) one thread per span recomputes its cells; for each int32 cell on a
//       backed page it takes x = atomicExch(&scratch, 0) and, if x != 0,
//       adds __float2int_rn(x) (half to even, as jnp.round) to the arena
//       cell. The span pass has finished (stream order), so each cell's
//       whole-dispatch delta is taken exactly once, by one thread, and the
//       scratch is zero again afterwards.
//   (b) one thread per logical row of the pair role on a backed page reads
//       its scratch delta, writes 0 back and folds y = delta + comp,
//       tot = sum + y, comp' = y - (tot - sum) in f32, both stored with
//       __float2bfloat16_rn. It runs on a dispatch of no spans too.
//
// Designs measured against this one and slower (PERF.md): the
// tables staged in shared memory without the moments row, or read from
// global memory with it; warp-aggregated atomics (__match_any_sync, a
// shuffle sum, one atomic per cell); scalar atomics for the moments sums;
// a fold that walks a list of the cells whose scratch add returned +0.
//
// What bounds it now: latency and atomics, not bytes. The compulsory bytes
// (16 B a span plus the touched cells, and 12 B per backed pair row) take
// well under 1 us at 3.35 TB/s. The span pass: 16,384 spans make 64
// blocks, one per SM on half the card; each warp waits on its loads and a
// table lookup per role before its atomics go out, and a hot series' cells
// take its atomics one after another at L2 (7 + 4-7 a span under `both`).
// The fold: part (a) repeats the cell arithmetic, and each exchange waits
// on its L2 round trip before the add; part (b) is a table lookup, a load
// and a store per backed pair row. Each pass also pays a launch. No pass
// reads or clears the scratch of cells the batch did not touch.
//
// Numerics. Integer-count planes stay exact under atomics for integer
// (or dyadic) weights while each cell is below 2^24; float sums take their
// adds in no fixed order. The DDSketch bucket follows the reference's f32
// op order, ceil(logf(max(v, min) / min) / f32(log gamma)), and the
// moments basis z = logf(clip(v, f32(e^lo), f32(e^hi))),
// s = clip((z - f32(c)) / f32(h), -1, 1), T_j = (2 s) T_{j-1} - T_{j-2},
// with IEEE logf and division and no contraction: build without
// --use_fast_math, with -ftz=false -prec-div=true -fmad=false.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define PFU_MAX_EDGES 64
#define PFU_MAX_ROLES 8
#define PFU_MAX_K 32
#define PFU_BLOCK 256
#define PFU_MAX_SMEM 232448  // dynamic shared memory a block may use (227 KB)

// must match `_PFU_FIELDS` in tempo_tpu_torch/ops/cuda_kernels.py
struct PfuParams {
  int n_roles;      // 5, +2 with the DDSketch planes, +1 with moments
  int p_pages;      // logical pages per table row
  int page_shift;   // log2(page_rows)
  int dd_rows;      // slots below this feed the DDSketch planes (0 = off)
  int nb_dd;        // DDSketch buckets per row
  int n_edges;      // latency histogram edges (buckets = n_edges + 1)
  int mom_rows;     // slots below this feed the moments row (0 = off)
  int mom_k;        // Chebyshev moments; the row is k + 3 wide
  int compact;      // 1: int32 roles and the pair go through the scratch
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

struct PfuPtrs {
  void* arena[PFU_MAX_ROLES];
  // compact: role r's logical-row f32 delta ([rows_r, width_r]) for the
  // int32 roles and the pair; null for sizes, moments and under f32 state
  float* scratch[PFU_MAX_ROLES];
};

// The cells one span adds to. Both passes build it with `span_cells` (the
// slot's row) and `span_columns` (its histogram and DDSketch columns).
struct Span {
  int s;       // logical slot; -1 = no cells (discard, past the table, i >= n)
  int lp;      // logical page
  int off;     // row within the page
  int hb;      // latency histogram bucket
  int dd;      // DDSketch role: 5 (zero count), 6 (grid) or -1 (none)
  int di;      // DDSketch grid column (dd == 6)
  float dur, size, w;
};

__device__ __forceinline__ Span span_cells(const PfuParams& p, int n, int i,
                                           const float* __restrict__ slots_f,
                                           const int* __restrict__ slots_i,
                                           const float* __restrict__ vals) {
  Span c;
  c.s = -1;
  c.lp = c.off = c.hb = c.di = 0;
  c.dd = -1;
  c.dur = c.size = c.w = 0.0f;
  if (i >= n) return c;
  // packed batches carry slot ids as f32 (exact below 2^24)
  const int s = slots_f != nullptr ? (int)slots_f[i] : slots_i[i];
  if (s < 0 || (s >> p.page_shift) >= p.p_pages) return c;
  c.s = s;
  c.lp = s >> p.page_shift;
  c.off = s & ((1 << p.page_shift) - 1);
  c.dur = vals[i];
  c.size = vals[n + i];
  c.w = vals[2 * n + i];
  return c;
}

__device__ __forceinline__ void span_columns(const PfuParams& p, Span& c) {
  for (int e = 0; e < p.n_edges; ++e) c.hb += c.dur > p.edges[e];
  if (p.dd_rows > 0 && c.s < p.dd_rows) {
    if (c.dur <= p.min_value) {
      c.dd = 5;
    } else {
      float idx = ceilf(logf(fmaxf(c.dur, p.min_value) / p.min_value) /
                        p.log_gamma);
      idx = fminf(fmaxf(idx, 0.0f), (float)(p.nb_dd - 1));
      c.dd = 6;
      c.di = (int)idx;
    }
  }
}

// Physical arena row of role r for this span (c.s >= 0), or -1 when r's
// page is unbacked.
__device__ __forceinline__ int64_t phys_row(const PfuParams& p,
                                            const int* tab, const Span& c,
                                            int r) {
  const int phys = tab[r * p.p_pages + c.lp];
  if (phys <= 0) return -1;
  return ((int64_t)phys << p.page_shift) | c.off;
}

// Role r's add for this span: into `scratch` by logical row when given
// (compact int32 roles and the pair), else into `arena` by physical row.
// The callers pick the pointers with constant indices: an index into
// PfuPtrs known only at run time would copy the struct to local memory.
__device__ __forceinline__ void role_add(const PfuParams& p, const int* tab,
                                         const Span& c, int r, void* arena,
                                         float* scratch, int width, int col,
                                         float x) {
  const int64_t row = phys_row(p, tab, c, r);
  if (row < 0) return;
  float* at = scratch != nullptr ? scratch + (int64_t)c.s * width + col
                                 : (float*)arena + row * width + col;
  atomicAdd(at, x);
}

__device__ __forceinline__ void put4(float4& q, int at, float x) {
  if (at == 0) q.x = x;
  else if (at == 1) q.y = x;
  else if (at == 2) q.z = x;
  else q.w = x;
}

__device__ __forceinline__ float get4(const float4& q, int at) {
  return at == 0 ? q.x : at == 1 ? q.y : at == 2 ? q.z : q.w;
}

// The moments row's k+1 sums (count and T_1..T_k times the weight), as
// the Chebyshev recurrence yields them, go out by 16-byte-aligned quads,
// one float4 atomicAdd each (Hopper adds vectors in global memory), and
// the row's ragged ends by scalars; the row is k+3 floats wide, so its
// alignment differs from row to row.
__device__ __forceinline__ void moment_sums(const PfuParams& p, float* m,
                                            float sv, float w) {
  const float two_s = 2.0f * sv;
  float t2 = 1.0f, t1 = sv;
  const int o = (int)(((uintptr_t)m >> 2) & 3);  // column 0's place in a quad
  float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int j = 0; j <= p.mom_k; ++j) {
    const float t = j == 0 ? 1.0f : j == 1 ? sv : two_s * t1 - t2;
    if (j >= 2) {
      t2 = t1;
      t1 = t;
    }
    const int at = (o + j) & 3;
    put4(q, at, t * w);
    if (at == 3 || j == p.mom_k) {
      const int start = j - at < 0 ? 0 : j - at;
      if (start == j - 3) {
        atomicAdd((float4*)(m + start), q);
      } else {
        for (int col = start; col <= j; ++col)
          atomicAdd(m + col, get4(q, (o + col) & 3));
      }
    }
  }
}

// STAGE is a template parameter, not a branch: a table pointer that may
// point to shared or to global memory makes every lookup a generic load.
template <bool STAGE>
__global__ void __launch_bounds__(PFU_BLOCK)
pfu_span_kernel(const PfuParams p, const PfuPtrs d, int n,
                const int* __restrict__ tables,
                const float* __restrict__ slots_f,
                const int* __restrict__ slots_i,
                const float* __restrict__ vals) {
  // the span's loads go out before a staged table is read, so the two
  // overlap
  Span c = span_cells(p, n, blockIdx.x * blockDim.x + threadIdx.x, slots_f,
                      slots_i, vals);
  extern __shared__ int staged[];
  if (STAGE) {
    for (int j = threadIdx.x; j < p.n_roles * p.p_pages; j += blockDim.x)
      staged[j] = tables[j];
    __syncthreads();
  }
  const int* tab = STAGE ? staged : tables;
  if (c.s < 0) return;
  // the scratch pointers are all null under f32 state
  role_add(p, tab, c, 0, d.arena[0], d.scratch[0], 1, 0, c.w);
  role_add(p, tab, c, 1, d.arena[1], d.scratch[1], 1, 0, c.dur * c.w);
  role_add(p, tab, c, 2, d.arena[2], d.scratch[2], 1, 0, c.w);
  role_add(p, tab, c, 3, d.arena[3], nullptr, 1, 0, c.size * c.w);
  // the columns' arithmetic (a logf) overlaps the row roles' atomics
  span_columns(p, c);
  role_add(p, tab, c, 4, d.arena[4], d.scratch[4], p.n_edges + 1, c.hb, c.w);
  if (c.dd == 6)
    role_add(p, tab, c, 6, d.arena[6], d.scratch[6], p.nb_dd, c.di, c.w);
  else if (c.dd == 5)
    role_add(p, tab, c, 5, d.arena[5], d.scratch[5], 1, 0, c.w);
  if (c.s < p.mom_rows) {
    // the moments role is the last: 7 with the DDSketch planes, else 5
    const int64_t mrow = phys_row(p, tab, c, p.n_roles - 1);
    if (mrow < 0) return;
    float* m = (float*)(p.dd_rows > 0 ? d.arena[7] : d.arena[5]) +
               mrow * (p.mom_k + 3);
    const float z = logf(fminf(fmaxf(c.dur, p.mom_vmin), p.mom_vmax));
    const float sv = fminf(fmaxf((z - p.mom_c) / p.mom_h, -1.0f), 1.0f);
    moment_sums(p, m, sv, c.w);
    atomicMax((int*)(m + p.mom_k + 1),
              __float_as_int(fmaxf(z - p.mom_lo, 0.0f)));
    atomicMax((int*)(m + p.mom_k + 2),
              __float_as_int(fmaxf(p.mom_hi - z, 0.0f)));
  }
}

// Fold part (a) for role r's int32 cell of this span: take the
// whole-dispatch delta out of the scratch and add it, rounded half to
// even, to the arena cell. Only the thread that took x != 0 writes the
// cell, so an atomic add with no return spares a read-modify-write's load.
__device__ __forceinline__ void fold_role(const PfuParams& p,
                                          const int* tables, const Span& c,
                                          int r, void* arena, float* scratch,
                                          int width, int col) {
  const int64_t row = phys_row(p, tables, c, r);
  if (row < 0) return;
  const float x = atomicExch(scratch + (int64_t)c.s * width + col, 0.0f);
  if (x != 0.0f) atomicAdd((int*)arena + row * width + col, __float2int_rn(x));
}

__global__ void __launch_bounds__(PFU_BLOCK)
pfu_fold_kernel(const PfuParams p, const PfuPtrs d, int n, int a_blocks,
                const int* __restrict__ tables,
                const float* __restrict__ slots_f,
                const int* __restrict__ slots_i,
                const float* __restrict__ vals) {
  if ((int)blockIdx.x >= a_blocks) {
    // (b) the pair: every logical row of every backed page
    const int64_t lrow = (int64_t)(blockIdx.x - a_blocks) * blockDim.x +
                         threadIdx.x;
    if (lrow >= ((int64_t)p.p_pages << p.page_shift)) return;
    const int phys = __ldg(&tables[p.p_pages + (int)(lrow >> p.page_shift)]);
    if (phys <= 0) return;
    float* sc = d.scratch[1] + lrow;
    const float x = *sc;
    if (x != 0.0f) *sc = 0.0f;
    __nv_bfloat162* a = (__nv_bfloat162*)d.arena[1] +
                        (((int64_t)phys << p.page_shift) |
                         (lrow & ((1 << p.page_shift) - 1)));
    const __nv_bfloat162 v = *a;
    const float sum = __low2float(v);
    const float comp = __high2float(v);
    const float y = x + comp;
    const float tot = sum + y;
    *a = __floats2bfloat162_rn(tot, y - (tot - sum));
    return;
  }
  // (a) one thread per span: its int32 cells, the row roles' first (as in
  // the span pass)
  Span c = span_cells(p, n, blockIdx.x * blockDim.x + threadIdx.x, slots_f,
                      slots_i, vals);
  if (c.s < 0) return;
  fold_role(p, tables, c, 0, d.arena[0], d.scratch[0], 1, 0);
  fold_role(p, tables, c, 2, d.arena[2], d.scratch[2], 1, 0);
  span_columns(p, c);
  fold_role(p, tables, c, 4, d.arena[4], d.scratch[4], p.n_edges + 1, c.hb);
  if (c.dd == 6)
    fold_role(p, tables, c, 6, d.arena[6], d.scratch[6], p.nb_dd, c.di);
  else if (c.dd == 5)
    fold_role(p, tables, c, 5, d.arena[5], d.scratch[5], 1, 0);
}

extern "C" {

// Launch K1 on `stream`: the span pass when n > 0 and, under compact, the
// fold. `block` holds, packed, the tables pointer, PFU_MAX_ROLES arena
// pointers, PFU_MAX_ROLES scratch pointers and a PfuParams: what does not
// change between dispatches on one set of arenas (`_Plan` in
// cuda_kernels.py). Returns cudaGetLastError() (0 = launched).
int paged_fused_update_launch(const void* block, int block_bytes, int n,
                              const float* slots_f, const int* slots_i,
                              const float* vals, void* stream) {
  const size_t ptrs = (1 + 2 * PFU_MAX_ROLES) * sizeof(void*);
  if (block_bytes != (int)(ptrs + sizeof(PfuParams)))
    return (int)cudaErrorInvalidValue;
  const char* b = (const char*)block;
  const int* tables;
  void* arenas[PFU_MAX_ROLES];
  float* scratch[PFU_MAX_ROLES];
  PfuParams p;
  memcpy(&tables, b, sizeof tables);
  memcpy(arenas, b + sizeof(void*), sizeof arenas);
  memcpy(scratch, b + (1 + PFU_MAX_ROLES) * sizeof(void*), sizeof scratch);
  memcpy(&p, b + ptrs, sizeof p);
  const int want = 5 + (p.dd_rows > 0 ? 2 : 0) + (p.mom_rows > 0 ? 1 : 0);
  if (p.n_edges < 0 || p.n_edges > PFU_MAX_EDGES || p.n_roles != want ||
      p.mom_k < 0 || p.mom_k > PFU_MAX_K)
    return (int)cudaErrorInvalidValue;
  PfuPtrs d;
  memset(&d, 0, sizeof d);
  for (int r = 0; r < p.n_roles; ++r) {
    d.arena[r] = arenas[r];
    d.scratch[r] = p.compact ? scratch[r] : nullptr;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const int span_blocks = (n + PFU_BLOCK - 1) / PFU_BLOCK;
  if (n > 0) {
    // with the moments row on, staging the tables measured faster;
    // without it, slower (PERF.md)
    const bool stage = p.mom_rows > 0;
    const size_t smem =
        stage ? (size_t)p.n_roles * p.p_pages * sizeof(int) : 0;
    if (smem > PFU_MAX_SMEM) return (int)cudaErrorInvalidValue;
    static size_t smem_set = 48 * 1024;  // opted-in dynamic shared memory
    if (smem > smem_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          pfu_span_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          PFU_MAX_SMEM);
      if (e != cudaSuccess) return (int)e;
      smem_set = PFU_MAX_SMEM;
    }
    if (stage)
      pfu_span_kernel<true><<<span_blocks, PFU_BLOCK, smem, st>>>(
          p, d, n, tables, slots_f, slots_i, vals);
    else
      pfu_span_kernel<false><<<span_blocks, PFU_BLOCK, 0, st>>>(
          p, d, n, tables, slots_f, slots_i, vals);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (p.compact) {
    const int64_t n_lrows = (int64_t)p.p_pages << p.page_shift;
    const int64_t pair_blocks = (n_lrows + PFU_BLOCK - 1) / PFU_BLOCK;
    if (span_blocks + pair_blocks > INT32_MAX)
      return (int)cudaErrorInvalidValue;
    // part (a) one thread per span, then part (b)
    pfu_fold_kernel<<<(unsigned)(span_blocks + pair_blocks), PFU_BLOCK, 0,
                      st>>>(p, d, n, span_blocks, tables, slots_f, slots_i,
                            vals);
  }
  return (int)cudaGetLastError();
}

const char* kernel_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
