"""Percent of its roofline that K2 (``kernels/csrc/attention.cu``, kernels named
``attention_core*``) reaches inside the profiled steps: the frozen least time of every
launch at the configuration's sites over the kernel's device time.  Layer: kernels."""

from cudabench.counts.kernels import roofline_share

UNIT = "%"


def read(ctx):
    return roofline_share(ctx, ("attention_core",))
