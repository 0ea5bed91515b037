"""Seconds from the process's start to the window's: imports, data, weights, models, the
checked steps, the warm-up (and with ``--trace 1`` the model-FLOP count)."""

UNIT = "s"


def read(ctx):
    return ctx.get("setup_s")
