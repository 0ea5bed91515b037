"""Percent of the profiled stretch's wall time in which the device ran nothing.
Layer: device."""

UNIT = "%"


def read(ctx):
    p = ctx.get("profile")
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"]) if p and p["window_s"] > 0 else None
