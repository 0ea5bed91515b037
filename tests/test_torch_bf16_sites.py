"""The port's bf16 roundings against XLA's compile of the JAX package, site by site.

A site is a bf16 value that reaches a normalisation, the attention's residual,
tanh or a set statistic with no conv or matmul in between.  The port rounds
after every PyTorch op; XLA's default compile may keep a fused intermediate
in f32 and skip a rounding the JAX code writes (``xla_allow_excess_precision``).
Where it does, the consumer reads the unrounded value, and a port that
rounds first feeds it a different input (the env decoder's first block, the
hard-glyph head-to-head).

Each case (``bf16_sites_support.py``) is a chain: the block that makes the
value and the consumer that reads it; ``bf16_sites_jax.py`` builds the JAX
chain and reads both (``scripts/torch_bf16_sites.py`` prints the readings at
the flagship and VoxCeleb widths).  The tests take small widths (img 32,
style 32) and ``bias_scale`` 30, and hold the port's mean error at the
consumer's output to at most ``RATIO`` = 1.5 times the default compile's.
Where XLA keeps the value in f32 (``xla_keeps_f32``), the port must track
the default compile more closely than with the value rounded; where XLA
rounds, the port's output must equal the rounded chain's, so that a later
change that keeps such a value in f32 fails.
"""

import pytest
import torch
from bf16_sites_jax import readings, xla_keeps_f32
from bf16_sites_support import KEEPS_F32, ROUNDS, SMALL, by_name

torch.set_num_threads(1)

RATIO = 1.5


# --- the tests ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    return by_name(SMALL), SMALL.players()


@pytest.mark.parametrize("name", KEEPS_F32)
def test_port_keeps_the_value_in_f32_where_xla_does(small, name):
    named, players = small
    r = readings(named[name], SMALL, players)
    assert xla_keeps_f32(r), r
    assert r["port"] <= RATIO * r["jax_default"], r
    # the port tracks the default compile better than with the value rounded
    assert r["port ~ jax_default"] < r["port_rounded ~ jax_default"], r


@pytest.mark.parametrize("name", ROUNDS)
def test_port_rounds_where_xla_does(small, name):
    named, players = small
    r = readings(named[name], SMALL, players)
    assert not xla_keeps_f32(r), r
    assert r["port"] <= RATIO * r["jax_default"], r
    assert r["port rounds"], r
