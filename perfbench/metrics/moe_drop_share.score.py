"""Expert choices dropped over capacity in the traced calls: 1 - the
program's ``moe_kept`` over ``moe_choices`` (tokens x top-k), in
percent."""

from pb import lm


def read(ctx):
    snap = lm.counters(ctx)
    if not snap or snap["moe_choices"] <= 0:
        return None
    return 100.0 * (1.0 - snap["moe_kept"] / snap["moe_choices"])
