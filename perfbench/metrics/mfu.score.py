"""Model operations of the window (counted from the configuration and
the shapes: products with the active weights and the unembedding for
every token, attention over the causal or cached span) over the
window's seconds and the card's bf16 dense peak, in percent."""

from pb import peaks


def read(ctx):
    if ctx.kind != "score" or ctx.window_s <= 0:
        return None
    return 100.0 * ctx.work.window_flops() / ctx.window_s / peaks.BF16_FLOPS
