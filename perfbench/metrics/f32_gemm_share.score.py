"""Device time of float32 GEMM kernels over device busy time in the
traced stretch, in percent."""


def read(ctx):
    if ctx.kind != "score" or not ctx.trace or ctx.trace["busy_s"] <= 0:
        return None
    return 100.0 * ctx.trace["by_kind"].get("gemm_f32", 0.0) \
        / ctx.trace["busy_s"]
