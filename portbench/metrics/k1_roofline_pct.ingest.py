"""K1's share of the bandwidth roofline in the traced slice: the least
bytes of the span-metrics updates acknowledged in it (`core/roofline.
k1_bytes`) over the summed device time of K1's kernels (`pfu_*`)."""

from portbench.core.roofline import share_pct


def read(rec):
    if rec.trace is None:
        return None
    return share_pct(rec.data.get("k1_bytes", 0), rec.data.get("k1_device_s", 0))
