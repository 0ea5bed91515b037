"""What the port's kernels must compute and move, checked on the CPU.

* In bf16 the attention core rounds the softmax P to the activation dtype
  before the second product, as the JAX reference does
  (``nn/blocks.py:SelfAttention``, ``.astype(hproj.dtype)``).  The port's CPU
  path (the kernel's plain version) matches that core to within 2^-9 of the
  largest output entry, with at least 99 % of the bf16 outputs equal, where
  the unrounded core misses both.  In f32 the rounding changes nothing.
* The byte counts the bounds are built from: each input read once, each
  output written once, at every site of the flagship train step.
* The AdaIN kernels' tile plans, forward and backward from one planner:
  one pass over a resident tile at every flagship site.
* The VoxCeleb step's sites (64x64x3): their bounds, summed per step, and
  the tiles the planner gives the two AdaIN sites the flagship lacks, a
  resident tile of 32-channel (K1) and 16-channel (K1b) rows at 32x32x64
  and the flat tile at 64x64x3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimalstrategiesagainstgenerativeattacks_torch.kernels import adain as k1
from optimalstrategiesagainstgenerativeattacks_torch.kernels import attention as k2

torch.set_num_threads(1)

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet


def _jax_core(f, g, h):
    """nn/blocks.py SelfAttention (:895-899): f32 scores and softmax, P rounded to h's dtype."""
    attn = jnp.einsum("bic,bjc->bij", f, g, preferred_element_type=jnp.float32)
    attn = jax.nn.softmax(attn.astype(jnp.float32), axis=1)
    attn = attn.astype(h.dtype)
    out = jnp.einsum("bic,bij->bjc", h, attn, preferred_element_type=jnp.float32)
    return out.astype(h.dtype)


def _unrounded_core(f, g, h):
    p = torch.softmax(torch.bmm(f.float(), g.float().transpose(1, 2)), dim=1)
    return torch.bmm(p.transpose(1, 2), h.float()).to(h.dtype)


def _bf16_case(b, n, c, cq, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in ((b, n, cq), (b, n, cq), (b, n, c))]
    want = np.asarray(_jax_core(*(jnp.asarray(a, jnp.bfloat16) for a in arrays)).astype(jnp.float32))
    return [torch.from_numpy(a).to(torch.bfloat16) for a in arrays], want


def _agreement(got, want):
    """(max |got - want| / max |want|, share of exactly equal entries)."""
    d = np.abs(got.float().numpy() - want)
    return d.max() / np.abs(want).max(), (d == 0).mean()


ATT_BF16 = [(2, 16, 8, 1), (2, 64, 32, 4), (1, 256, 16, 2), (2, 50, 20, 3), (2, 64, 256, 32)]


@pytest.mark.parametrize("shape", ATT_BF16, ids=["n16_cq1", "n64_cq4", "n256_cq2", "n50_cq3",
                                                 "n64_c256_cq32"])
def test_attention_core_bf16_rounds_p_as_the_jax_reference(shape):
    (f, g, h), want = _bf16_case(*shape, seed=shape[1])
    rel, equal = _agreement(k2.attention_core(f, g, h), want)
    assert rel <= 2.0 ** -9 and equal >= 0.99, (rel, equal)
    assert torch.equal(k2.attention_core_ref(f, g, h), k2.attention_core(f, g, h))
    # the same core without the rounding of P misses the reference at bf16 level
    rel_u, equal_u = _agreement(_unrounded_core(f, g, h), want)
    assert rel_u > 2.0 ** -9 or equal_u < 0.99, (rel_u, equal_u)


def test_attention_core_rounding_of_p_is_exact_in_f32():
    rng = np.random.default_rng(4)
    f, g, h = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 64, 4), (2, 64, 4), (2, 64, 16)))
    assert torch.equal(k2.attention_core_ref(f, g, h), _unrounded_core(f, g, h))


# flagship sites: (B', N, C, CQ) -> bound in us at 3.35 TB/s; (B', H, W, C) -> us
K2_SITES = {(1920, 64, 256, 32): 42.3, (1280, 64, 256, 32): 28.2, (128, 64, 256, 32): 2.8,
            (640, 64, 128, 16): 7.0, (640, 64, 256, 32): 14.1, (640, 256, 128, 16): 28.2}
K1B_SITES = {(640, 4, 4, 512): 10.4, (640, 8, 8, 256): 19.3, (640, 16, 16, 128): 37.8,
             (640, 32, 32, 1): 1.2}
K1_SITES = {(640, 4, 4, 512): 6.7, (640, 8, 8, 256): 12.7, (640, 16, 16, 128): 25.1,
            (640, 32, 32, 1): 0.8}
SITE_IDS = ["4x4x512", "8x8x256", "16x16x128", "32x32x1"]
# K1b's tiles at those sites (mode, grid, block, warps), the fastest of its sweep
K1B_TILES = {(640, 4, 4, 512): (0, (640, 4), (1, 16, 128), 1),
             (640, 8, 8, 256): (0, (640, 4), (1, 64, 64), 2),
             (640, 16, 16, 128): (0, (640, 4), (1, 256, 32), 4),
             (640, 32, 32, 1): (1, (640,), (1, 1024, 1), 1)}
DIRECTIONS = pytest.mark.parametrize("direction", ["fwd", "bwd"])
K2_PER_STEP = {(1920, 64, 256, 32): 2, (1280, 64, 256, 32): 2, (128, 64, 256, 32): 2,
               (640, 64, 128, 16): 1, (640, 64, 256, 32): 1, (640, 256, 128, 16): 1}
K1_PER_STEP = {(640, 4, 4, 512): 11, (640, 8, 8, 256): 2, (640, 16, 16, 128): 2,
               (640, 32, 32, 1): 1}


def _us(n_bytes):
    return n_bytes / HBM_BYTES_PER_S * 1e6


def test_byte_counts_of_the_named_sites():
    assert k2.attention_core_bytes(1920, 64, 256, 32, torch.bfloat16) == 141_557_760
    assert k1.ada_in_bwd_bytes(640, 4, 4, 512, torch.bfloat16) == 34_734_080
    assert k1.ada_in_fwd_bytes(640, 4, 4, 512, torch.bfloat16) == 22_282_240
    # f32 doubles the activations' bytes; the f32 statistics stay
    assert k2.attention_core_bytes(1, 64, 256, 32, torch.float32) == 2 * k2.attention_core_bytes(
        1, 64, 256, 32, torch.bfloat16)


@pytest.mark.parametrize("site", list(K2_SITES), ids=[f"b{b}_n{n}_c{c}_cq{q}"
                                                      for b, n, c, q in K2_SITES])
def test_attention_core_bound_per_site(site):
    assert round(_us(k2.attention_core_bytes(*site, torch.bfloat16)), 1) == K2_SITES[site]
    # memory bounds it: the products take less at the bf16 tensor-core peak
    assert k2.attention_core_flops(*site) / 989e12 * 1e6 < K2_SITES[site]


@pytest.mark.parametrize("site", list(K1B_SITES), ids=SITE_IDS)
def test_ada_in_bwd_bound_per_site(site):
    assert round(_us(k1.ada_in_bwd_bytes(*site, torch.bfloat16)), 1) == K1B_SITES[site]
    assert k1.ada_in_bwd_flops(*site) / 67e12 * 1e6 < K1B_SITES[site]


@pytest.mark.parametrize("site", list(K1_SITES), ids=SITE_IDS)
def test_ada_in_fwd_bound_per_site(site):
    bytes_us = _us(k1.ada_in_fwd_bytes(*site, torch.bfloat16))
    assert round(bytes_us, 1) == K1_SITES[site]
    # memory bounds it: the flops take less at the f32 peak
    assert k1.ada_in_fwd_flops(*site) / 67e12 * 1e6 < bytes_us


def test_bounds_summed_over_the_flagship_step():
    k2_ms = sum(n * _us(k2.attention_core_bytes(*s, torch.bfloat16)) for s, n in K2_PER_STEP.items())
    k1b_ms = sum(n * _us(k1.ada_in_bwd_bytes(*s, torch.bfloat16)) for s, n in K1_PER_STEP.items())
    k1_ms = sum(n * _us(k1.ada_in_fwd_bytes(*s, torch.bfloat16)) for s, n in K1_PER_STEP.items())
    assert (round(k2_ms / 1e3, 3), round(k1b_ms / 1e3, 3), round(k1_ms / 1e3, 3)) == (
        0.196, 0.229, 0.150)


@DIRECTIONS
@pytest.mark.parametrize("site", list(K1B_SITES), ids=SITE_IDS)
def test_ada_in_tile_is_resident_at_every_flagship_site(direction, site):
    b, h, w, c = site
    per_thread = k1.PER_THREAD[direction]
    cfg = k1.tile_config(b, h * w, c, per_thread)
    assert cfg["MODE"] in (0, 1)  # resident tile or flat resident tile, never the loop
    assert cfg["BLOCK_HW"] >= (h * w if cfg["MODE"] == 0 else h * w * c)
    programs = int(np.prod(cfg["grid"]))
    tile = cfg["BLOCK_B"] * cfg["BLOCK_HW"] * cfg["BLOCK_C"]
    assert programs * tile >= b * h * w * c  # the grid covers the map
    assert tile // (32 * cfg["num_warps"]) <= per_thread[cfg["MODE"]]
    if direction == "bwd":  # the shared planner keeps K1b's tiles
        assert (cfg["MODE"], cfg["grid"], (cfg["BLOCK_B"], cfg["BLOCK_HW"], cfg["BLOCK_C"]),
                cfg["num_warps"]) == K1B_TILES[site]


@DIRECTIONS
def test_ada_in_loops_where_the_tile_would_not_fit(direction):
    assert k1.tile_config(2, 64 * 64, 64, k1.PER_THREAD[direction])["MODE"] == 2


# VoxCeleb step: (B', N, C, CQ) and (B', H, W, C) -> launches per step
K2_VOX_PER_STEP = {(1920, 256, 128, 16): 2, (1280, 256, 128, 16): 2, (128, 256, 128, 16): 2,
                   (640, 64, 256, 32): 1, (640, 256, 128, 16): 2}
K1_VOX_PER_STEP = {(640, 4, 4, 512): 11, (640, 8, 8, 256): 2, (640, 16, 16, 128): 2,
                   (640, 32, 32, 64): 2, (640, 64, 64, 3): 1}
# the sites the flagship lacks: (direction, site) -> (mode, BLOCK_HW, BLOCK_C, warps)
VOX_TILES = {("fwd", (640, 32, 32, 64)): (0, 1024, 32, 8), ("bwd", (640, 32, 32, 64)): (0, 1024, 16, 8),
             ("fwd", (640, 64, 64, 3)): (1, 16384, 1, 8), ("bwd", (640, 64, 64, 3)): (1, 16384, 1, 8)}


def test_bounds_summed_over_the_vox_step():
    k2_ms = sum(n * _us(k2.attention_core_bytes(*s, torch.bfloat16))
                for s, n in K2_VOX_PER_STEP.items())
    k1b_ms = sum(n * _us(k1.ada_in_bwd_bytes(*s, torch.bfloat16))
                 for s, n in K1_VOX_PER_STEP.items())
    k1_ms = sum(n * _us(k1.ada_in_fwd_bytes(*s, torch.bfloat16))
                for s, n in K1_VOX_PER_STEP.items())
    assert (round(k2_ms / 1e3, 4), round(k1b_ms / 1e3, 4), round(k1_ms / 1e3, 4)) == (
        0.3634, 0.3928, 0.2585)
    # memory bounds every site: the flops take less at their peak rates
    for s in K2_VOX_PER_STEP:
        assert k2.attention_core_flops(*s) / 989e12 * 1e6 < _us(
            k2.attention_core_bytes(*s, torch.bfloat16))
    for s in K1_VOX_PER_STEP:
        assert k1.ada_in_bwd_flops(*s) / 67e12 * 1e6 < _us(k1.ada_in_bwd_bytes(*s, torch.bfloat16))


@pytest.mark.parametrize("direction,site", list(VOX_TILES),
                         ids=[f"{d}-{h}x{w}x{c}" for d, (_, h, w, c) in VOX_TILES])
def test_ada_in_tiles_at_the_vox_sites(direction, site):
    b, h, w, c = site
    cfg = k1.tile_config(b, h * w, c, k1.PER_THREAD[direction])
    assert (cfg["MODE"], cfg["BLOCK_HW"], cfg["BLOCK_C"], cfg["num_warps"]) == VOX_TILES[
        (direction, site)]
    programs = int(np.prod(cfg["grid"]))
    assert programs * cfg["BLOCK_B"] * cfg["BLOCK_HW"] * cfg["BLOCK_C"] >= b * h * w * c
