"""Percent of their roofline that K1 and K1b (``kernels/adain.py``, kernels named
``adain_fwd*`` and ``adain_bwd*``) reach inside the profiled steps: the frozen least time
of every launch at the configuration's sites over the kernels' device time.  Layer:
kernels."""

from cudabench.counts.kernels import roofline_share

UNIT = "%"


def read(ctx):
    return roofline_share(ctx, ("adain_fwd", "adain_bwd"))
