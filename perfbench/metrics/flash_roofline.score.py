"""Causal attention of the traced forward calls (operations and bytes
counted from the shapes, whatever computes them) at the card's bf16
peak and memory bandwidth, over the device time of the flash kernels,
in percent.  Silent where no flash kernel ran."""

from pb import peaks


def read(ctx):
    if ctx.kind != "score" or not ctx.trace:
        return None
    t = ctx.trace["by_kind"].get("flash", 0.0)
    if t <= 0:
        return None
    ops, nbytes = ctx.work.traced_flash()
    bound = max(ops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)
    return 100.0 * bound / t
