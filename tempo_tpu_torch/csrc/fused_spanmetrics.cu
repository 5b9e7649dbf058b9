// Dense fused span-metrics delta: one pass over a span batch builds the
// [S, F] delta of count | duration sum | size sum | latency histogram,
// F = 3 + n_edges + 1.
//
// Replaces the Pallas TPU kernel `fused_spanmetrics_matmul`
// (tempo_tpu/ops/pallas_kernels.py:141, pallas_call at :156). That kernel
// is the "scatter as a matrix product" trick of the TPU: per span block it
// builds a one-hot [N, S] slot matrix and a [N, F] feature matrix and
// accumulates onehot^T @ feats on the matrix unit at f32 precision, paying
// S * F * N multiply-adds for an O(N * F) job. On Hopper the tensor cores
// would take that product in TF32 or bf16 at best, which breaks exact
// counts, and the work is a scatter anyway.
//
// What bounds it here: L2 atomic operations, not bytes. Each span reads
// 16 B (slot, duration, size, weight) and adds into 4 cells of the output;
// the output (S * F * 4 B: 256 KB at the benchmark's 4,096 series and 16
// columns, 4.7 MB at 65,536 series and 18) is written once. Those bytes
// take 1.3-1.5 us at 3.35 TB/s. The card retires about 60 G atomic
// operations a second in L2 whether each adds one float or four (PERF.md),
// so the time follows the number of atomic operations, and under skewed
// slots the operations that queue on one hot series' cells.
//
// Design. Two device operations a call: the C launch function zeroes the
// output with cudaMemsetAsync (the wrapper allocates it with torch.empty),
// then one pass, `fsm_span_kernel`, blocks of 256, SPT spans a thread: 4
// (one 16 B load per input when the four inputs are 16-byte aligned) for
// a batch of at least 4 x 256 x 132 spans, which still gives each of an
// H100's 132 SMs a block, else 1, so that a small batch spreads over the
// card (the wrapper's `k2_layout` picks it). A span's columns 0..2 and
// its bucket column 3 + b go out as float4 atomicAdds (Hopper adds
// vectors in global memory) on the 16-byte quads of the flat output that
// hold them, with +0.0 in the lanes the span does not add to: one quad
// when the row starts on a quad boundary (F a multiple of 4, as at the
// benchmark's F = 16), two when columns 0..2 straddle one (F = 18 puts
// every other row two floats into a quad). The bucket joins the last of
// those quads when it lies in it, and is one scalar atomic otherwise: two
// operations a span where today's design took four. A quad that would run
// past the end of the output goes out as scalars. Adding +0.0 leaves every
// cell as it was (no cell ever holds -0.0: it starts at +0.0 and
// +0.0 + -0.0 is +0.0), and spills into the neighbouring row's cells only
// as +0.0.
//
// Designs measured against this one and slower (PERF.md, "PR 4"): four
// scalar atomics a span into a zeroed output (the first port); one span a
// thread at every batch size, or four at every size; the zeroing and the atomics in one cooperative launch with a
// grid-wide barrier; the lanes of a warp that hold one series summed
// first (__match_any_sync, or a per-warp shared table) before one atomic;
// partitioning the spans by series tile (count, scatter, reduce each tile
// in shared memory and store it whole: no memset and no global float
// atomics, but three passes and shared-memory atomics that queue on a
// tile's hot series).
//
// The bucket is the number of edges strictly below the duration, as both
// reference formulations compute (`dur > e` summed, and searchsorted
// side="left"). Slots < 0 or >= S drop.
//
// Numerics: counts and histogram buckets exact under atomics for integer
// weights below 2^24 per cell; the two sums take their adds in no fixed
// order. Built with -fmad=false, so `dur * w` is one rounded product as in
// the reference.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#define FSM_MAX_EDGES 64
#define FSM_BLOCK 256

// must match `_K2_FIELDS` in tempo_tpu_torch/ops/cuda_kernels.py
struct FsmParams {
  int n_series;  // rows of the output
  int n_edges;   // latency histogram edges; F = n_edges + 4
  float edges[FSM_MAX_EDGES];
};

__device__ __forceinline__ void put4(float4& q, int at, float x) {
  if (at == 0) q.x = x;
  else if (at == 1) q.y = x;
  else if (at == 2) q.z = x;
  else q.w = x;
}

// One span's adds into row s of out (total = S * F cells): w, d * w and
// size * w to columns 0..2 and w to column 3 + b, as one or two float4
// atomics and, when the bucket is in neither quad, one scalar.
__device__ __forceinline__ void span_add(float* out, int64_t total, int F,
                                         int s, int b, float w, float dw,
                                         float sw) {
  const int64_t o = (int64_t)s * F;
  const int64_t q0 = o >> 2, q2 = (o + 2) >> 2, qh = (o + 3 + b) >> 2;
  if ((q2 << 2) + 4 > total) {  // the last quad would run past the end
    atomicAdd(out + o, w);
    atomicAdd(out + o + 1, dw);
    atomicAdd(out + o + 2, sw);
    atomicAdd(out + o + 3 + b, w);
    return;
  }
  const int p = (int)(o & 3);  // column 0's place in its quad
  float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), c = a;
  put4(a, p, w);
  if (p + 1 < 4) put4(a, p + 1, dw); else put4(c, p - 3, dw);
  if (p + 2 < 4) put4(a, p + 2, sw); else put4(c, p - 2, sw);
  const int ph = (int)((o + 3 + b) & 3);
  bool alone = true;
  if (qh == q0) {
    put4(a, ph, w);
    alone = false;
  } else if (qh == q2) {
    put4(c, ph, w);
    alone = false;
  }
  atomicAdd((float4*)(out + (q0 << 2)), a);
  if (q2 != q0) atomicAdd((float4*)(out + (q2 << 2)), c);
  if (alone) atomicAdd(out + o + 3 + b, w);
}

// SPT spans a thread; VEC (SPT 4 only): the four inputs are 16-byte
// aligned, so a thread loads its spans with one 16 B load per input.
template <int SPT, bool VEC>
__global__ void __launch_bounds__(FSM_BLOCK)
fsm_span_kernel(const FsmParams p, int n, const int* __restrict__ slots,
                const float* __restrict__ dur,
                const float* __restrict__ sizes,
                const float* __restrict__ weights, float* __restrict__ out) {
  const int64_t i0 = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * SPT;
  if (i0 >= n) return;
  int s[SPT];
  float d[SPT], z[SPT], w[SPT];
  if (VEC && SPT == 4 && i0 + 3 < n) {
    const int4 s4 = *(const int4*)(slots + i0);
    const float4 d4 = *(const float4*)(dur + i0);
    const float4 z4 = *(const float4*)(sizes + i0);
    const float4 w4 = *(const float4*)(weights + i0);
    // (k % SPT keeps the indices in range where SPT is 1; the branch is
    // dead there)
    s[0] = s4.x; s[1 % SPT] = s4.y; s[2 % SPT] = s4.z; s[3 % SPT] = s4.w;
    d[0] = d4.x; d[1 % SPT] = d4.y; d[2 % SPT] = d4.z; d[3 % SPT] = d4.w;
    z[0] = z4.x; z[1 % SPT] = z4.y; z[2 % SPT] = z4.z; z[3 % SPT] = z4.w;
    w[0] = w4.x; w[1 % SPT] = w4.y; w[2 % SPT] = w4.z; w[3 % SPT] = w4.w;
  } else {
#pragma unroll
    for (int k = 0; k < SPT; ++k) {
      const int64_t i = i0 + k;
      const bool in = i < n;
      s[k] = in ? slots[i] : -1;
      d[k] = in ? dur[i] : 0.0f;
      z[k] = in ? sizes[i] : 0.0f;
      w[k] = in ? weights[i] : 0.0f;
    }
  }
  const int F = p.n_edges + 4;
  const int64_t total = (int64_t)p.n_series * F;
#pragma unroll
  for (int k = 0; k < SPT; ++k) {
    if (s[k] < 0 || s[k] >= p.n_series) continue;
    int b = 0;
    for (int e = 0; e < p.n_edges; ++e) b += d[k] > p.edges[e];
    span_add(out, total, F, s[k], b, w[k], d[k] * w[k], z[k] * w[k]);
  }
}

extern "C" {

// Zero `out` [n_series, n_edges + 4] and, when n > 0, launch the span pass
// with `spt` (1 or 4) spans a thread, both on `stream`. `params` is a
// packed FsmParams (`_k2_params_of` in cuda_kernels.py). Returns
// cudaGetLastError() (0 = launched).
int fused_spanmetrics_launch(const void* params, int params_bytes, int n,
                             int spt, const int* slots, const float* dur,
                             const float* sizes, const float* weights,
                             float* out, void* stream) {
  // the float4 atomics need a 16-byte-aligned output
  if (params_bytes != (int)sizeof(FsmParams) || n < 0 ||
      (spt != 1 && spt != 4) || ((uintptr_t)out & 15) != 0)
    return (int)cudaErrorInvalidValue;
  FsmParams p;
  memcpy(&p, params, sizeof p);
  if (p.n_series < 0 || p.n_edges < 0 || p.n_edges > FSM_MAX_EDGES)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = cudaMemsetAsync(
      out, 0, (size_t)p.n_series * (p.n_edges + 4) * sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  if (n > 0) {
    const int64_t threads = ((int64_t)n + spt - 1) / spt;
    const unsigned blocks = (unsigned)((threads + FSM_BLOCK - 1) / FSM_BLOCK);
    const bool vec = ((((uintptr_t)slots) | ((uintptr_t)dur) |
                       ((uintptr_t)sizes) | ((uintptr_t)weights)) & 15) == 0;
    if (spt == 1)
      fsm_span_kernel<1, false><<<blocks, FSM_BLOCK, 0, st>>>(
          p, n, slots, dur, sizes, weights, out);
    else if (vec)
      fsm_span_kernel<4, true><<<blocks, FSM_BLOCK, 0, st>>>(
          p, n, slots, dur, sizes, weights, out);
    else
      fsm_span_kernel<4, false><<<blocks, FSM_BLOCK, 0, st>>>(
          p, n, slots, dur, sizes, weights, out);
  }
  return (int)cudaGetLastError();
}

const char* kernel_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
