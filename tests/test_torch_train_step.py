"""One full train step of the port against the JAX reference step.

Both sides start from one transplanted state (small config, f32,
``au_microbatch=1``, norms and attention gammas randomised) and take one
step on the same uint8 batch.  The reference draws the impersonator's noise
inside its step; the test recovers that draw (same key, same ``make_rng``
call at the impersonator's root) and injects it into the port's step.

Compared after the step:
  * gradients of both players: with beta1 = 0 the first Adam moment is the
    gradient itself (the reference's ``mu``, the port's ``exp_avg``),
    rtol 1e-3 with an absolute floor of 1e-4 * max|g| of the tensor (2e-3
    past the set std, see below) and of 1e-6 * max|g| of the player
    (tensors whose gradient is zero in exact arithmetic, such as the
    attention f/g biases, which shift every source score of a column
    alike).  The 2e-3 tensor floor is set by conditioning, not
    by the port: the n fakes of an episode differ only through the mapped
    noise, so the authenticator's env features of the fake set nearly
    coincide (set std / |feature| has a median of ~8e-4 at this size) and
    the gradient of the set std, (x - mean) / ((S - 1) std), magnifies f32
    rounding about a thousandfold.  Every gradient downstream of it (the
    authenticator's env encoder, all of the impersonator) then differs from
    the reference by up to ~1e-3 of its tensor's largest entry; the src
    encoder and the head, which it does not reach, agree to ~1e-5;
  * the new spectral u/v of both players, atol 1e-6;
  * the metrics, rtol 1e-4 / atol 1e-6;
  * the new parameters.  With beta1 = 0 the first Adam step is about
    lr * sign(g), which is ill-conditioned where |g| is near Adam's eps.
    So parameters are compared to f32 rounding (atol 1e-7, rtol 1e-6)
    where |g| > 1e-6, and within 2 * lr of the reference elsewhere.  In the
    R1 case an entry of the env encoder, past the set std, can have a
    gradient above 1e-6 that is still within the gradient comparison's
    floor of its tensor (2e-3 of its largest entry): the two programs'
    rounding then decides its sign, and Adam moves it 2 lr apart (one entry
    of 9214 in ``encoders.env.down_1.conv_r2.weight``, as the suite runs the
    reference).  There, at most 4 entries a tensor whose gradients take
    opposite signs, each within that floor, are held to 2 lr as well.

Two cases: the flagship's ``reg_param = 0`` on one channel, and the R1 case
(``reg_param = 10``, three channels, as the VoxCeleb config), whose
authenticator gradient runs a double backward through the encoders.  Both
hold the same tolerances; the R1 metrics include ``au_reg``.

The R1 case in bf16 is in ``test_torch_train_step_bf16.py``, ``eval_step``,
``sample`` and ``diag`` in ``test_torch_train_step_eval.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from optimalstrategiesagainstgenerativeattacks_torch.port.transplant import flax_to_state_dict
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


def _adam_mu(opt_state):
    """Merge every Adam first moment in an optax state into one params-shaped tree."""
    found = []

    def walk(x):
        if hasattr(x, "mu") and hasattr(x, "nu"):
            found.append(x.mu)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, tuple):
            for v in x:
                walk(v)

    walk(opt_state)
    merged = {}
    for tree in found:
        for path, leaf in flatten_dict(tree).items():
            if hasattr(leaf, "shape"):
                merged[path] = np.asarray(leaf)
    return unflatten_dict(merged)


# the flagship's reg_param = 0 on one channel, and the VoxCeleb config's R1 on three
CASES = {"reg0": dict(), "r1": dict(reg_param=10.0, img_channels=3)}


def _lowered_step(cfg, av, iv, batch):
    """(the transplanted reference state, its step lowered for the batch's shapes, the
    impersonator's noise draw of that step as f32 numpy)."""
    jau, jim = jax_build(cfg)
    jcfg = jax_cfg(cfg)
    opt_au, opt_im, _ = jimg.make_optimizers(jcfg)
    jstate = GameState(
        step=jnp.asarray(-1, jnp.int32), params_au=av["params"], params_im=iv["params"],
        spectral_au=av["spectral"], spectral_im=iv["spectral"],
        opt_au=opt_au.init(av["params"]), opt_im=opt_im.init(iv["params"]),
        rng=jax.random.PRNGKey(7),
    )
    # the reference step's noise draw: rng, k_noise = split(fold_in(rng, step)); z at the
    # root, in the compute dtype
    _, k_noise = jax.random.split(jax.random.fold_in(jstate.rng, 0))
    shape = (cfg.batch_size, cfg.n, cfg.style_dim)
    z_dtype = jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32
    z = jim.apply(iv, method=lambda m: jax.random.normal(m.make_rng("noise"), shape, z_dtype),
                  rngs={"noise": k_noise})
    lowered = jax.jit(jimg.make_train_step_fn(jcfg, jau, jim, opt_au, opt_im)).lower(
        jstate, _jax_batch(batch))
    return jstate, lowered, np.asarray(z, np.float32)


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# XLA's compile with every bf16 rounding the reference's code writes
AS_WRITTEN = {"xla_allow_excess_precision": False}


def _reference_step(cfg, av, iv, batch, excess_precision=True):
    """One reference step from the transplanted state -> (new state, metrics,
    the impersonator's noise draw as f32 numpy)."""
    jstate, lowered, z = _lowered_step(cfg, av, iv, batch)
    step_fn = lowered.compile(compiler_options=None if excess_precision else AS_WRITTEN)
    new_jstate, jmetrics, _ = step_fn(jstate, _jax_batch(batch))
    return new_jstate, {k: float(v) for k, v in jmetrics.items()}, z


@functools.cache
def _step_case(name):
    cfg = small_cfg(**CASES[name])
    _, _, av, iv = init_jax_players(cfg)
    batch = uint8_batch(cfg, seed=3)
    new_jstate, jmetrics, z = _reference_step(cfg, av, iv, batch)
    tstate = torch_state_from(cfg, av, iv)
    tmetrics, _ = timg.train_step(tstate, batch, z=torch.from_numpy(z.copy()))
    return cfg, new_jstate, jmetrics, tstate, {k: float(v) for k, v in tmetrics.items()}, (av, iv)


@pytest.fixture(scope="module", params=list(CASES))
def one_step(request):
    return _step_case(request.param)


PLAYERS = ["au", "im"]
MAX_R1_SIGN_FLIPS = 4  # per tensor


def _torch_grads(tstate, player):
    module = getattr(tstate, player)
    opt = getattr(tstate, f"opt_{player}")
    return {k: opt.state[p]["exp_avg"].numpy() for k, p in module.named_parameters()}


def _grad_floors(want, player):
    """The gradient comparison's absolute floor of each tensor (see the module docstring)."""
    player_max = max(np.abs(w).max() for w in want.values())
    # only the authenticator's src encoder and head lie outside the set std's reach
    return {k: max((2e-3 if player == "im" or k.startswith("encoders.env.") else 1e-4)
                   * np.abs(w).max(), 1e-6 * player_max) for k, w in want.items()}


@pytest.mark.parametrize("player", PLAYERS)
def test_step_gradients_match_jax(one_step, player):
    _, jstate, _, tstate, _, _ = one_step
    want = flax_to_state_dict(_adam_mu(getattr(jstate, f"opt_{player}")), {})
    got = _torch_grads(tstate, player)
    assert set(got) == set(want)
    floors = _grad_floors(want, player)
    for k, g in got.items():
        np.testing.assert_allclose(g, want[k], rtol=1e-3, atol=floors[k], err_msg=k)


@pytest.mark.parametrize("player", PLAYERS)
def test_step_spectral_state_matches_jax(one_step, player):
    _, jstate, _, tstate, _, _ = one_step
    want = flax_to_state_dict({}, jax.tree.map(np.asarray, getattr(jstate, f"spectral_{player}")))
    got = {k: b.numpy() for k, b in getattr(tstate, player).named_buffers()}
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-6, err_msg=k)


def test_step_metrics_match_jax(one_step):
    _, _, jmetrics, _, tmetrics, _ = one_step
    assert set(tmetrics) == set(jmetrics) == set(timg.METRIC_KEYS)
    for k in timg.METRIC_KEYS:
        np.testing.assert_allclose(tmetrics[k], jmetrics[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("player", PLAYERS)
def test_step_params_match_jax(one_step, player):
    cfg, jstate, _, tstate, _, _ = one_step
    want = flax_to_state_dict(jax.tree.map(np.asarray, getattr(jstate, f"params_{player}")), {})
    grads = flax_to_state_dict(_adam_mu(getattr(jstate, f"opt_{player}")), {})
    got = {k: p.detach().numpy() for k, p in getattr(tstate, player).named_parameters()}
    got_grads, floors = _torch_grads(tstate, player), _grad_floors(grads, player)
    for k, p in got.items():
        lr = cfg.au_lr if player == "au" else (
            cfg.env_noise_mapping_lr if k.startswith("env_noise_mapper.") else cfg.im_lr)
        big = np.abs(grads[k]) > 1e-6
        if cfg.reg_param > 0:
            # R1: a few entries whose gradient lies within the gradient test's
            # floor may take the other sign (module docstring)
            flipped = big & (np.sign(grads[k]) != np.sign(got_grads[k]))
            assert flipped.sum() <= MAX_R1_SIGN_FLIPS, (k, int(flipped.sum()))
            assert np.all(np.abs(grads[k][flipped]) <= floors[k]), k
            big &= ~flipped
        np.testing.assert_allclose(p[big], want[k][big], rtol=1e-6, atol=1e-7, err_msg=k)
        assert np.all(np.abs(p[~big] - want[k][~big]) <= 2 * lr), k


def test_step_moves_both_players(one_step):
    _, _, _, tstate, tmetrics, (av, iv) = one_step
    assert tstate.step == 0 and tmetrics["im_trained"] == 1.0
    for player, v in (("au", av), ("im", iv)):
        before = flax_to_state_dict(v["params"], {})
        after = {k: p.detach().numpy() for k, p in getattr(tstate, player).named_parameters()}
        assert any(not np.array_equal(after[k], before[k]) for k in after), player


def test_three_steps_stay_finite_and_n_au_steps_gates_the_impersonator():
    cfg = small_cfg(n_au_steps=2, seed=5)
    batches = [uint8_batch(cfg, seed=s) for s in range(3)]
    au, im = timg.build_models(cfg)
    state = timg.create_state(cfg, au, im, cfg.seed, "cpu")
    im_before = {k: v.clone() for k, v in state.im.state_dict().items()}
    metrics, fake = timg.train_step(state, batches[0])
    # step 0: (0 + 1) % 2 != 0, so the impersonator neither steps nor iterates its u/v
    assert metrics["im_trained"].item() == 0.0
    for k, v in state.im.state_dict().items():
        assert torch.equal(v, im_before[k]), k
    state, history = timg.train_gim_imgs_steps(cfg, iter(batches[1:]), 2, state=state)
    assert [h["im_trained"] for h in history] == [1.0, 0.0]
    assert state.step == 2
    assert all(np.isfinite(v) for h in history for v in h.values())
    assert tuple(fake.shape) == (cfg.batch_size, cfg.n, cfg.img_size, cfg.img_size, 1)
    assert fake.abs().max() <= 1.0
