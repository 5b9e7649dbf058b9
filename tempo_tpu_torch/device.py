"""Device resolution and numeric policy for the PyTorch/CUDA port.

Every object that owns device state takes an explicit `device`. Entry
points run on `cuda` unless the caller asks for `"cpu"`; asking for
`cuda` on a host without a CUDA device raises instead of quietly running
somewhere else.

TF32 is switched off for matrix products and convolutions: the
reference contracts its one-hot products at `Precision.HIGHEST`
(`tempo_tpu/ops/pallas_kernels.py:133-138`) because any reduced-precision
contraction breaks exact integer counts.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """The device an entry point runs on: `cuda` by default, `cpu` only
    when asked for. Raises when CUDA is requested and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (use cuda or cpu)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the host")
    return dev


def bucket_rows(n: int, lo: int = 64, hi: "int | None" = None) -> int:
    """Power-of-two shape bucket for a row count: next pow2 >= max(n, lo),
    capped at `hi` when given."""
    b = max(int(lo), 1)
    while b < n:
        b <<= 1
    if hi is not None:
        b = min(b, hi)
    return b


__all__ = ["resolve_device", "bucket_rows"]
