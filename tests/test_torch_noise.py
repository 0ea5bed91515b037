"""The impersonator's noise draw against ``jax.random.normal``'s, per compute dtype.

The JAX package draws the impersonator's z with ``jax.random.normal`` in the
compute dtype (``models/image.py``, its ``GIMFaceImpersonator.__call__``).
In bf16, ``jax.random.uniform`` randomises only the 7 mantissa bits, so u
takes the 128 values (4 r - 255) / 256, r = 0 .. 127, each with probability
1/128, and z = sqrt(2) * erfinv(u) with erfinv and the product each rounded
to bf16: 128 values from -2.890625 to 2.515625, of mean -0.0120.  The port's
draw is held to that set and those frequencies: the same values (exactly, as
XLA's CPU compile gives them), each value's count within 5 standard
deviations of its binomial expectation, the mean within 5 standard errors of
the JAX distribution's.  In f32 both sides draw a standard normal with 23
random mantissa bits or more: held to the moments within 5 standard errors.
Both the train step's draw (``train/image.py:noise``) and the model's own
(``z=None``) are held.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
from test_torch_support import small_cfg

N_DRAWS = 1 << 18


def jax_normal(dtype, n: int = N_DRAWS, seed: int = 0) -> np.ndarray:
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype), np.float32)


def port_noise(compute_dtype: str, n: int = N_DRAWS, seed: int = 0) -> torch.Tensor:
    cfg = small_cfg(compute_dtype=compute_dtype)
    b = n // (cfg.n * cfg.style_dim)
    return timg.noise(cfg, b, torch.Generator().manual_seed(seed), "cpu")


def test_bf16_noise_takes_the_values_of_jax_random_normal():
    want = jax_normal(jnp.bfloat16)
    z = port_noise("bfloat16")
    assert z.dtype == torch.bfloat16
    values, counts = np.unique(z.float().numpy(), return_counts=True)
    want_values, want_counts = np.unique(want, return_counts=True)
    assert len(want_values) == 128
    np.testing.assert_array_equal(values, want_values)
    # each value has probability 1/128 on both sides
    p = want_counts / want_counts.sum()
    np.testing.assert_allclose(p, 1 / 128, atol=5 * np.sqrt((1 / 128) * (127 / 128) / len(want)))
    n = counts.sum()
    sd = np.sqrt(n * (1 / 128) * (127 / 128))
    assert np.all(np.abs(counts - n / 128) <= 5 * sd), np.abs(counts - n / 128).max() / sd
    mean, std = values.mean(), values.std()  # the exact moments of the 128 equally likely values
    zf = z.float().numpy()
    assert abs(zf.mean() - mean) <= 5 * std / np.sqrt(zf.size)
    assert round(float(mean), 4) == -0.0120


def test_f32_noise_moments_match_jax_random_normal():
    z = port_noise("float32").numpy()
    want = jax_normal(jnp.float32)
    assert z.dtype == np.float32 and len(np.unique(z)) > 0.99 * z.size
    for x in (z, want):
        assert abs(x.mean()) <= 5 / np.sqrt(x.size)
        assert abs(x.var() - 1) <= 5 * np.sqrt(2 / x.size)


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_impersonator_draws_the_step_noise(compute_dtype):
    """The model's own draw (z=None) is the train step's draw from the same generator."""
    cfg = small_cfg(compute_dtype=compute_dtype)
    au, im = timg.build_models(cfg)
    state = timg.create_state(cfg, au, im, 0, "cpu")
    leaked = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (cfg.batch_size, cfg.m, cfg.img_size, cfg.img_size, 1), dtype=np.uint8))
    x = timg.prepare(cfg, leaked, "cpu")
    with torch.no_grad():
        own = state.im(x, cfg.n, generator=torch.Generator().manual_seed(3))
        z = timg.noise(cfg, cfg.batch_size, torch.Generator().manual_seed(3), "cpu")
        injected = state.im(x, cfg.n, z=z)
    assert torch.equal(own, injected)


def test_bf16_impersonator_draws_jax_values_on_the_model_path():
    cfg = dataclasses.replace(small_cfg(), compute_dtype="bfloat16")
    _, im = timg.build_models(cfg)
    seen = []
    im.env_noise_mapper.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    with torch.no_grad():
        im(torch.zeros(64, cfg.m, cfg.img_size, cfg.img_size, 1, dtype=torch.bfloat16), cfg.n,
           generator=torch.Generator().manual_seed(0))
    values = np.unique(seen[0].float().numpy())
    assert set(values) <= set(np.unique(jax_normal(jnp.bfloat16)))
