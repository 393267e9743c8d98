"""Device time of the kernels launched under the program's MoE ranges
(``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``) over
device busy time in the traced stretch, in percent."""


def read(ctx):
    if ctx.kind != "score" or not ctx.trace or ctx.trace["busy_s"] <= 0:
        return None
    moe = sum(ctx.trace["moe_s"].values())
    return 100.0 * moe / ctx.trace["busy_s"] if moe > 0 else None
