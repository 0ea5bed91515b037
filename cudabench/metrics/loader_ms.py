"""Host ms a step in ``next()`` of the program's training loader
(``data/device_sampler.py:DeviceEpisodicLoader``), mean over the trace run's unprofiled
stretch; the harness's own clock around each call.  Layer: data."""

UNIT = "ms"


def read(ctx):
    s = ctx.get("unprofiled")
    return 1e3 * s["loader_s"] / s["steps"] if s and s["steps"] else None
