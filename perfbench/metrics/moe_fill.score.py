"""Expert slots that hold a token in the traced calls: the program's
``moe_kept`` (choices under capacity) over ``moe_slots`` (groups x
experts x capacity), in percent."""

from pb import lm


def read(ctx):
    snap = lm.counters(ctx)
    if not snap or snap["moe_slots"] <= 0:
        return None
    return 100.0 * snap["moe_kept"] / snap["moe_slots"]
