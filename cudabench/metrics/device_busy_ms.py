"""Device ms a step in which a kernel, memcpy or memset ran: the union of their
intervals over the profiled stretch, a step's share.  Layer: models, blocks and ops."""

UNIT = "ms"


def read(ctx):
    p = ctx.get("profile")
    return 1e3 * p["busy_s"] / p["steps"] if p and p["busy_s"] > 0 else None
