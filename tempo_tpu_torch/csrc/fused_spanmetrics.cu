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
// What bounds it here: bytes. Each span reads 16 B (slot, duration, size,
// weight) and adds into 4 cells of the output; the output (S * F * 4 B,
// 256 KB at the benchmark's 4,096 series and 16 features) is written once.
// The least time is the batch plus the output over 3.35 TB/s.
//
// Design (first, simple and correct): one thread per span, blocks of 256,
// f32 atomicAdd into the output, which the wrapper zeroes. The bucket is
// the number of edges strictly below the duration, as both reference
// formulations compute (`dur > e` summed, and searchsorted side="left").
// Slots < 0 or >= S drop. A shared-memory privatised histogram per block
// is the faster design, but the output at the benchmark's shape (256 KB)
// is above a block's 227 KB of shared memory, so it needs a series split
// across blocks: later work.
//
// Numerics: counts and histogram buckets exact under atomics for integer
// weights below 2^24 per cell; the two sums take their adds in no fixed
// order. Built with -fmad=false, so `dur * w` is one rounded product as in
// the reference.

#include <cuda_runtime.h>
#include <stdint.h>

#define FSM_MAX_EDGES 64
#define FSM_BLOCK 256

struct FsmEdges {
  float e[FSM_MAX_EDGES];
};

__global__ void __launch_bounds__(FSM_BLOCK)
fused_spanmetrics_kernel(int n, int n_series, int n_edges, const FsmEdges edges,
                         const int* __restrict__ slots,
                         const float* __restrict__ dur,
                         const float* __restrict__ sizes,
                         const float* __restrict__ weights,
                         float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int s = slots[i];
  if (s < 0 || s >= n_series) return;
  const float d = dur[i];
  const float w = weights[i];
  float* row = out + (int64_t)s * (n_edges + 4);
  atomicAdd(row, w);
  atomicAdd(row + 1, d * w);
  atomicAdd(row + 2, sizes[i] * w);
  int b = 0;
  for (int e = 0; e < n_edges; ++e) b += d > edges.e[e];
  atomicAdd(row + 3 + b, w);
}

extern "C" {

// Launch on `stream` into `out` [n_series, n_edges + 4] (zeroed by the
// caller); returns cudaGetLastError() (0 = launched).
int fused_spanmetrics_launch(const int* slots, const float* dur,
                             const float* sizes, const float* weights, int n,
                             int n_series, const float* edges, int n_edges,
                             float* out, void* stream) {
  if (n_edges < 0 || n_edges > FSM_MAX_EDGES) return (int)cudaErrorInvalidValue;
  FsmEdges e;
  for (int k = 0; k < FSM_MAX_EDGES; ++k) e.e[k] = k < n_edges ? edges[k] : 0.0f;
  if (n > 0) {
    const int blocks = (n + FSM_BLOCK - 1) / FSM_BLOCK;
    fused_spanmetrics_kernel<<<blocks, FSM_BLOCK, 0, (cudaStream_t)stream>>>(
        n, n_series, n_edges, e, slots, dur, sizes, weights, out);
  }
  return (int)cudaGetLastError();
}

const char* kernel_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
