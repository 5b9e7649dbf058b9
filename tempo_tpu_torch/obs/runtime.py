"""Process runtime self-metrics of the PyTorch/CUDA port.

Counterpart of `tempo_tpu/obs/jaxruntime.py`: one process-wide registry
(`RUNTIME`), distinct from any per-App registry, for the facts every
tenant of the process shares (device transfers, kernel walls, launch
plans) and for the families the scheduler, the device-time ledger and
the fault points register at import.

The reference's `tempo_jax_device_put_bytes_total` and
`tempo_jax_kernel_duration_seconds` keep their names, so dashboards read
the port's process the same way. Its jit-compile families have no
counterpart: the port compiles no graphs. In their place are
`tempo_torch_k1_launch_plans_total` (K1 launch plans built: validated
sets of tables, arenas and scratch, the port's analog of a cache-miss
trace; flat in steady state) and `tempo_torch_kernel_launches_total`
(hand-kernel launches, by kernel).
"""

from __future__ import annotations

import contextlib
import time

import torch

from tempo_tpu_torch.obs.registry import Registry, exponential_buckets

RUNTIME = Registry()

DEVICE_PUT_BYTES = RUNTIME.counter(
    "tempo_jax_device_put_bytes_total",
    "Bytes uploaded host-to-device, by call site",
    labels=("site",))
KERNEL_SECONDS = RUNTIME.histogram(
    "tempo_jax_kernel_duration_seconds",
    "Device time of a timed region, measured between two CUDA events on "
    "the current stream (wall time on the host for host tensors), per "
    "kernel",
    labels=("kernel",),
    buckets=exponential_buckets(1e-5, 4.0, 12))


def _k1_plans():
    from tempo_tpu_torch.ops import cuda_kernels
    return [((), float(cuda_kernels.paged_fused_update.plans))]


def _launches():
    from tempo_tpu_torch.ops import cuda_kernels
    return [((w.__name__,), float(w.launches)) for w in cuda_kernels.WRAPPERS]


RUNTIME.counter_func(
    "tempo_torch_k1_launch_plans_total", _k1_plans,
    help="Launch plans K1 (paged_fused_update) built: one per validated "
         "set of page tables, arenas and scratch, so one per span-metrics "
         "processor in steady state whatever the batch sizes")
RUNTIME.counter_func(
    "tempo_torch_kernel_launches_total", _launches,
    help="Launches of the port's hand-written CUDA kernels, by kernel",
    labels=("kernel",))


def record_device_put(nbytes: int, site: str) -> None:
    DEVICE_PUT_BYTES.inc(int(nbytes), (site,))


@contextlib.contextmanager
def kernel_timer(kernel: str, device=None):
    """Time a region into the kernel-time histogram: between two CUDA
    events on the current stream of `device` when it is a CUDA device
    (the end event is waited on when the region closes), else on the
    host's clock."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            end.synchronize()
            KERNEL_SECONDS.observe(start.elapsed_time(end) / 1e3, (kernel,))
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        KERNEL_SECONDS.observe(time.perf_counter() - t0, (kernel,))


__all__ = ["RUNTIME", "record_device_put", "kernel_timer",
           "DEVICE_PUT_BYTES", "KERNEL_SECONDS"]
