"""The model's product operations for the positions the traced calls
embedded (2 x the weights each token multiplies by x the program's
``tokens``, ``flops.matmul_params``) over the product operations the
program ran there (its ``product_ops`` counter, every dtype), in
percent: below 100 where the program multiplies one-hot dispatches and
experts padded to capacity."""

from pb import flops, lm


def read(ctx):
    snap = lm.counters(ctx)
    total = sum(snap["product_ops"].values()) if snap else 0
    if total <= 0 or not snap["tokens"]:
        return None
    return 100.0 * 2 * flops.matmul_params(ctx.arch) * snap["tokens"] / total
