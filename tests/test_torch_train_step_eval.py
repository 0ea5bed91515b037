"""``eval_step``, ``sample`` and ``diag`` of the port against the JAX reference's
``make_eval_step``, ``make_sample_fn`` and ``make_diag_fn``, on the players of
``test_torch_train_step.py``'s reg0 case."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
from optimalstrategiesagainstgenerativeattacks_tpu.train import image as jimg
from optimalstrategiesagainstgenerativeattacks_tpu.train.state import GameState
from test_torch_support import (
    init_jax_players,
    jax_build,
    jax_cfg,
    small_cfg,
    torch_state_from,
    uint8_batch,
)

torch.set_num_threads(1)


def test_eval_sample_and_diag_match_jax():
    """``eval_step``, ``sample`` and ``diag`` against the reference's ``make_eval_step``,
    ``make_sample_fn`` and ``make_diag_fn`` on the f32 case's transplanted players
    (before its step), the noise recovered from the reference's key and injected:
    metrics and diagnostics rtol 1e-4 / atol 1e-6, the fake rtol 1e-4 / atol 5e-5."""
    cfg = small_cfg()  # the f32 reg0 case's config and players, without its step
    _, _, av, iv = init_jax_players(cfg)
    jau, jim = jax_build(cfg)
    jcfg = jax_cfg(cfg)
    jstate = GameState(step=jnp.asarray(-1, jnp.int32), params_au=av["params"],
                       params_im=iv["params"], spectral_au=av["spectral"],
                       spectral_im=iv["spectral"], opt_au=None, opt_im=None,
                       rng=jax.random.PRNGKey(7))
    batch = uint8_batch(cfg, seed=4)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(11)
    shape = (cfg.batch_size, cfg.n, cfg.style_dim)
    z = np.array(jim.apply(iv, method=lambda m: jax.random.normal(m.make_rng("noise"), shape),
                           rngs={"noise": key}))
    want_metrics = {k: float(v) for k, v in jimg.make_eval_step(jcfg, jau, jim)(
        jstate, jbatch, key).items()}
    want_fake = np.asarray(jimg.make_sample_fn(jcfg, jim)(jstate, jbatch["leaked_sample"], key))
    want_diag = {k: float(v) for k, v in jimg.make_diag_fn(jcfg, jau)(
        jstate, jbatch, jnp.asarray(want_fake)).items()}

    tstate = torch_state_from(cfg, av, iv)
    got_metrics = timg.eval_step(tstate, batch, z=torch.from_numpy(z))
    assert set(got_metrics) == set(want_metrics) == set(timg.EVAL_KEYS)
    for k, v in got_metrics.items():
        np.testing.assert_allclose(float(v), want_metrics[k], rtol=1e-4, atol=1e-6, err_msg=k)
    fake = timg.sample(tstate, batch["leaked_sample"], z=torch.from_numpy(z))
    np.testing.assert_allclose(fake.numpy(), want_fake, rtol=1e-4, atol=5e-5)
    got_diag = timg.diag(tstate, batch, torch.from_numpy(want_fake.copy()))
    assert set(got_diag) == set(want_diag) == set(timg.DIAG_KEYS)
    for k, v in got_diag.items():
        np.testing.assert_allclose(float(v), want_diag[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert tstate.step == -1  # none of the three changes the state
