"""Host ms a step from the call of ``train/image.py:train_step`` to its return, no
synchronize, mean over the trace run's unprofiled stretch.  Layer: game step."""

UNIT = "ms"


def read(ctx):
    s = ctx.get("unprofiled")
    return 1e3 * s["enqueue_s"] / s["steps"] if s and s["steps"] else None
