"""Share of the traced stretch in which no operation ran on the
device, in percent."""


def read(ctx):
    if ctx.kind != "score" or not ctx.trace or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
