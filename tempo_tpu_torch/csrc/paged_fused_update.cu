// Paged fused span-metrics update: one pass over a span batch updates the
// whole span-metrics plane family in the page pool's arenas.
//
// Replaces the Pallas TPU kernel `paged_fused_update`
// (tempo_tpu/ops/pallas_kernels.py:196, pallas_call at :404). That kernel
// walks every logical page of the series table as a sequential grid step,
// rescans all N spans for each page and accumulates a
// [page_rows, 4 + hist + 1 + dd_buckets] one-hot product in VMEM before it
// writes each page back once. On Hopper that design does not carry over:
// the page accumulator is ~1.3 MB at the default widths (256 rows x 1289
// features x 4 B), far above a block's 227 KB of shared memory, and the
// rescan is O(N * pages).
//
// What bounds it here: bytes. Each span reads 16 B of batch and does a
// read-modify-write of one 4 B cell in each of up to 7 role arenas; the
// arithmetic is a few dozen f32 ops per span. The least time is the batch
// plus the touched cells (each read and written once) over 3.35 TB/s.
//
// Design (first, simple and correct): one thread per span, blocks of 256.
// The thread translates its slot through each role's page table once and
// adds its contributions straight into the arena cells with f32
// atomicAdd. A role whose table entry is <= 0 (unbacked, or padding) is
// skipped, so physical page 0, the trash page, is never written. The
// histogram edges ride in the kernel's parameter block. No shared memory,
// no allocation, no synchronisation; the launch goes on the caller's
// stream. Hot series serialise on their atomics; warp-aggregated atomics
// or a sort-by-page pass with a shared-memory page accumulator are the
// faster designs for later.
//
// Numerics. Integer-count planes (calls, latency count, histogram
// buckets, DDSketch zeros and buckets) stay exact under atomics for
// integer weights while each cell is below 2^24. The two float sums take
// their adds in no fixed order. The DDSketch bucket follows the
// reference's f32 op order, ceil(logf(max(v, min) / min) / f32(log gamma)),
// with IEEE logf and division: build without --use_fast_math, with
// -ftz=false -prec-div=true -fmad=false.

#include <cuda_runtime.h>
#include <stdint.h>

#define PFU_MAX_EDGES 64
#define PFU_BLOCK 256

struct PfuParams {
  int n;            // spans in the batch
  int n_roles;      // 5, or 7 with the DDSketch planes
  int p_pages;      // logical pages per table row
  int page_shift;   // log2(page_rows)
  int dd_rows;      // slots below this feed the DDSketch planes
  int nb_dd;        // DDSketch buckets per row
  int n_edges;      // latency histogram edges (buckets = n_edges + 1)
  float min_value;  // DDSketch min value
  float log_gamma;  // f32(log gamma)
  float edges[PFU_MAX_EDGES];
};

__global__ void __launch_bounds__(PFU_BLOCK)
paged_fused_update_kernel(const PfuParams p, const int* __restrict__ tables,
                          const float* __restrict__ slots_f,
                          const int* __restrict__ slots_i,
                          const float* __restrict__ vals,
                          float* __restrict__ calls, float* __restrict__ hsum,
                          float* __restrict__ hcnt, float* __restrict__ sizes,
                          float* __restrict__ hbuckets,
                          float* __restrict__ ddz, float* __restrict__ ddc) {
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

  // physical row of role r, or -1 when the role's page is unbacked
  auto row = [&](int r) -> int64_t {
    const int phys = tables[r * p.p_pages + lp];
    return phys > 0 ? ((int64_t)phys << p.page_shift) | off : -1;
  };

  int64_t r;
  if ((r = row(0)) >= 0) atomicAdd(calls + r, w);
  if ((r = row(1)) >= 0) atomicAdd(hsum + r, dur * w);
  if ((r = row(2)) >= 0) atomicAdd(hcnt + r, w);
  if ((r = row(3)) >= 0) atomicAdd(sizes + r, size * w);
  if ((r = row(4)) >= 0) {
    int b = 0;
    for (int e = 0; e < p.n_edges; ++e) b += dur > p.edges[e];
    atomicAdd(hbuckets + r * (p.n_edges + 1) + b, w);
  }
  if (p.n_roles == 7 && s < p.dd_rows) {
    if (dur <= p.min_value) {
      if ((r = row(5)) >= 0) atomicAdd(ddz + r, w);
    } else if ((r = row(6)) >= 0) {
      float idx = ceilf(logf(fmaxf(dur, p.min_value) / p.min_value) /
                        p.log_gamma);
      idx = fminf(fmaxf(idx, 0.0f), (float)(p.nb_dd - 1));
      atomicAdd(ddc + r * p.nb_dd + (int64_t)idx, w);
    }
  }
}

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 = launched).
int paged_fused_update_launch(
    const int* tables, int n_roles, int p_pages, const float* slots_f,
    const int* slots_i, const float* vals, int n, float* calls, float* hsum,
    float* hcnt, float* sizes, float* hbuckets, float* ddz, float* ddc,
    int page_shift, int dd_rows, int nb_dd, const float* edges, int n_edges,
    float min_value, float log_gamma, void* stream) {
  if (n_edges < 0 || n_edges > PFU_MAX_EDGES) return (int)cudaErrorInvalidValue;
  if (n_roles != 5 && n_roles != 7) return (int)cudaErrorInvalidValue;
  PfuParams p;
  p.n = n;
  p.n_roles = n_roles;
  p.p_pages = p_pages;
  p.page_shift = page_shift;
  p.dd_rows = dd_rows;
  p.nb_dd = nb_dd;
  p.n_edges = n_edges;
  p.min_value = min_value;
  p.log_gamma = log_gamma;
  for (int e = 0; e < n_edges; ++e) p.edges[e] = edges[e];
  if (n > 0) {
    const int blocks = (n + PFU_BLOCK - 1) / PFU_BLOCK;
    paged_fused_update_kernel<<<blocks, PFU_BLOCK, 0, (cudaStream_t)stream>>>(
        p, tables, slots_f, slots_i, vals, calls, hsum, hcnt, sizes, hbuckets,
        ddz, ddc);
  }
  return (int)cudaGetLastError();
}

const char* paged_fused_update_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
