"""The port's Gaussian game against the JAX package's, on the CPU.

* Step: one ``train_step`` of the port from the JAX players' initial weights
  (carried by the transplant) against the JAX ``make_train_step``, on the
  batch and noise the JAX step draws (recovered from its keys and injected
  into the port), at B=64, m1 n5 k10: the reference's ``mean_std`` stat at
  d=2 and ``mean_std_fc`` with ``hidden_scale 2`` at d=10, each at
  ``reg_param`` 0 and 5.  Compared: the 15 metrics (rtol 1e-5, atol 1e-6),
  each parameter's Adam first moment, i.e. its gradient over 10 (per tensor
  |err| <= 1e-5 max|ref| + a floor of 1e-6 of the player's largest entry),
  and both players' parameters after Adam (per tensor |err| <= 1e-5 max|ref|
  where the gradient is above that floor, else within 2 lr: the noise
  mapper's bias has a gradient of rounding noise, 0 in exact arithmetic, and
  Adam's first step moves it anywhere within lr).  The port's gradients sit
  within 2e-6 of each tensor's largest entry, its parameters within 1e-6.
  ``au_reg`` at reg 5 agrees only when the penalty takes the gradient with
  respect to si as well as real.
* Chunk: ``train_chunk`` of K steps equals K ``train_step`` calls, bit for bit.
* Loop: ``train_gim_gaussian(device="cpu")`` logs every step's scalars and the
  distances every ``save_stats_every`` steps, saves ``model_{step:08d}`` at
  the JAX loop's cadence, and a resume takes the same steps bit for bit
  (players, Adams, generator).
* CLI: the JAX CLI's flags plus ``--device``; ``--device cpu`` writes
  ``args.json``, TensorBoard logs and checkpoints, and ``-r`` resumes.
* Theory: the port's copy gives the JAX package's values.
"""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from optimalstrategiesagainstgenerativeattacks_torch import train_gim_on_gaussians as tcli
from optimalstrategiesagainstgenerativeattacks_torch import theory as ttheory
from optimalstrategiesagainstgenerativeattacks_torch.port.transplant import (
    flax_to_state_dict,
    load_flax,
)
from optimalstrategiesagainstgenerativeattacks_torch.train import gaussian as tg
from optimalstrategiesagainstgenerativeattacks_torch.train.checkpoints import (
    CheckpointIO,
    get_latest_ckpt,
)
from optimalstrategiesagainstgenerativeattacks_torch.utils.config import GaussianGameConfig
from optimalstrategiesagainstgenerativeattacks_tpu import theory as jtheory
from optimalstrategiesagainstgenerativeattacks_tpu.models import gaussian as jmodels
from optimalstrategiesagainstgenerativeattacks_tpu.train import gaussian as jg
from optimalstrategiesagainstgenerativeattacks_tpu.utils import config as jconfig
from test_cli_parity import _flags
from test_torch_loop import _assert_same, _snapshot
from test_torch_train_step import _adam_mu

torch.set_num_threads(1)

STEP_CASES = {
    "mean_std_d2_reg0": dict(src_dim=2),
    "mean_std_d2_reg5": dict(src_dim=2, reg_param=5.0),
    "mean_std_fc_d10_reg0": dict(src_dim=10, au_stat="mean_std_fc", au_hidden_scale=2),
    "mean_std_fc_d10_reg5": dict(src_dim=10, au_stat="mean_std_fc", au_hidden_scale=2,
                                 reg_param=5.0),
}


def _cfg(**kw) -> GaussianGameConfig:
    base = dict(batch_size=64, m=1, n=5, k=10, seed=3)
    base.update(kw)
    return GaussianGameConfig(**base)


@pytest.fixture(scope="module", params=list(STEP_CASES))
def step_case(request):
    cfg = _cfg(**STEP_CASES[request.param])
    jcfg = jconfig.GaussianGameConfig(**dataclasses.asdict(cfg))
    jau = jmodels.get_au(cfg.src_dim, stat_type=cfg.au_stat, hidden_scale=cfg.au_hidden_scale)
    jim = jmodels.get_im(cfg.src_dim)
    jstate, opt_au, opt_im = jg.create_state(jcfg, jau, jim, jax.random.PRNGKey(cfg.seed))
    # the JAX step's draws: split(fold_in(rng, step)) -> (rng, k_batch, k_noise)
    _, k_batch, k_noise = jax.random.split(jax.random.fold_in(jstate.rng, 0), 3)
    batch = {k: np.array(v) for k, v in jg._synth_batch(jcfg, k_batch, None).items()}
    shape = (cfg.batch_size, cfg.n, cfg.src_dim)
    z = np.array(jim.apply({"params": jstate.params_im},
                             method=lambda m: jax.random.normal(m.make_rng("noise"), shape),
                             rngs={"noise": k_noise}))
    new_jstate, jmetrics = jax.jit(jg.make_train_step(jcfg, jau, jim, opt_au, opt_im))(jstate)

    state = tg.create_state(cfg, "cpu")
    load_flax(state.au, jax.tree.map(np.asarray, jstate.params_au), {})
    load_flax(state.im, jax.tree.map(np.asarray, jstate.params_im), {})
    metrics = tg.train_step(state, batch={k: torch.from_numpy(v) for k, v in batch.items()},
                            z=torch.from_numpy(z))
    return (cfg, new_jstate, {k: float(v) for k, v in jmetrics.items()}, state,
            {k: float(v) for k, v in metrics.items()})


def test_step_metrics_match_jax(step_case):
    cfg, _, jmetrics, state, metrics = step_case
    assert state.step == 0
    assert set(metrics) == set(jmetrics) == set(tg.METRIC_KEYS)
    for k in tg.METRIC_KEYS:
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=1e-5, atol=1e-6, err_msg=k)
    if cfg.reg_param > 0:
        assert metrics["au_reg"] > 0.0


@pytest.mark.parametrize("player", ["au", "im"])
def test_step_gradients_and_params_match_jax(step_case, player):
    cfg, jstate, _, state, _ = step_case
    module, opt = getattr(state, player), getattr(state, f"opt_{player}")
    lr = cfg.au_lr if player == "au" else cfg.im_lr
    want_mu = flax_to_state_dict(_adam_mu(getattr(jstate, f"opt_{player}")), {})
    want = flax_to_state_dict(jax.tree.map(np.asarray, getattr(jstate, f"params_{player}")), {})
    got = dict(module.named_parameters())
    assert set(got) == set(want) == set(want_mu)
    floor = 1e-6 * max(np.abs(v).max() for v in want_mu.values())
    for k, p in got.items():
        mu = opt.state[p]["exp_avg"].numpy()
        np.testing.assert_allclose(mu, want_mu[k], rtol=0,
                                   atol=1e-5 * np.abs(want_mu[k]).max() + floor, err_msg=k)
        # Adam's first step moves an entry by lr g / (|g| + eps): where the gradient
        # is rounding noise (the noise mapper's bias, which the noise-mean removal
        # cancels exactly) the move is arbitrary within lr
        big = np.abs(want_mu[k]) > floor
        p = p.detach().numpy()
        np.testing.assert_allclose(p[big], want[k][big], rtol=0,
                                   atol=1e-5 * np.abs(want[k]).max(), err_msg=k)
        assert np.all(np.abs(p[~big] - want[k][~big]) <= 2 * lr), k


def test_chunk_equals_single_steps():
    cfg = _cfg(src_dim=3, reg_param=5.0)
    chunked, single = tg.create_state(cfg, "cpu"), tg.create_state(cfg, "cpu")
    got = tg.train_chunk(chunked, 3)
    want = torch.stack([torch.stack([m[k] for k in tg.METRIC_KEYS])
                        for m in (tg.train_step(single) for _ in range(3))])
    assert got.shape == (3, len(tg.METRIC_KEYS)) and got.dtype == torch.float32
    assert torch.equal(got, want)
    _assert_same(_snapshot(chunked), _snapshot(single))


def _loop_cfg(outdir, **kw):
    base = dict(outdir=str(outdir), n_iters=7, log_every=2, save_stats_every=4, save_every=3,
                src_dim=2, batch_size=32, reg_param=5.0)
    base.update(kw)
    return _cfg(**base)


def test_train_gim_gaussian_logs_saves_and_resumes(tmp_path):
    from optimalstrategiesagainstgenerativeattacks_torch.train.logger import Logger

    cfg = _loop_cfg(tmp_path)
    logger = Logger(str(tmp_path / "logs"), str(tmp_path / "imgs"), str(tmp_path / "tb"))
    state = tg.train_gim_gaussian(cfg, logger=logger, progress=False, device="cpu")
    # chunks of 2 over 7 iterations: steps 0..5 (the remainder is not run, as in JAX)
    assert state.step == 5
    ckpts = tmp_path / "ckpts"
    # a chunk crossing a multiple of save_every saves: after steps 3 (chunk 2-3) and 5
    assert sorted(os.listdir(ckpts)) == ["model_00000003", "model_00000005"]
    assert get_latest_ckpt(str(ckpts)).endswith("model_00000005")
    for category, k, _ in tg.STEP_SCALARS:
        assert [s for s, _ in logger.stats[category][k]] == list(range(6)), (category, k)
    for category, k, _ in tg.STATS_SCALARS:
        assert [s for s, _ in logger.stats[category][k]] == [0, 4], (category, k)
    flat = [v for cat in logger.stats.values() for pts in cat.values() for _, v in pts]
    assert np.all(np.isfinite(flat))
    assert all(v > 0 for _, v in logger.stats["train_losses"]["au_reg"])

    # resume from step 3: steps 4 and 5 again, bit for bit
    resume_cfg = dataclasses.replace(cfg, resume_from_ckpt="ckpts/model_00000003")
    logger = Logger(*(str(tmp_path / d) for d in ("logs2", "imgs2", "tb2")))
    resumed = tg.train_gim_gaussian(resume_cfg, logger=logger, progress=False, device="cpu")
    _assert_same(_snapshot(resumed), _snapshot(state))
    # --pretrained takes the players only: step, Adams and generator start afresh
    fresh = tg.create_state(cfg, "cpu")
    CheckpointIO(str(ckpts)).load(str(ckpts / "model_00000003"), fresh, players_only=True)
    assert fresh.step == -1 and not fresh.opt_au.state


def test_cli_flags_are_the_jax_clis_plus_device():
    jax_flags = _flags("train_gim_on_gaussians")
    port = tcli.build_parser()
    port_flags = {s for a in port._actions for s in a.option_strings}
    assert port_flags - {"--device"} == jax_flags
    defaults = vars(port.parse_args([]))
    assert defaults["device"] == "cuda"
    assert GaussianGameConfig.from_dict(defaults) == GaussianGameConfig()


def test_cli_trains_on_the_cpu_saves_and_resumes(tmp_path):
    out = tmp_path / "out"
    argv = ["--device", "cpu", "-o", str(out), "--n_iters", "6", "--batch_size", "32",
            "--src_dim", "3", "--n", "5", "--log_every", "3", "--save_stats_every", "3",
            "--save_every", "3", "--au_hidden_scale", "2"]
    state = tcli.main(argv)
    assert state.step == 5
    saved = json.loads((out / "args.json").read_text())
    assert saved["device"] == "cpu" and saved["src_dim"] == 3 and saved["au_hidden_scale"] == 2
    assert sorted(os.listdir(out / "ckpts")) == ["model_00000002", "model_00000005"]
    assert any(name.startswith("events.out.tfevents") for name in os.listdir(out / "tb"))
    resumed = tcli.main(argv + ["-r", "ckpts/model_00000002"])
    _assert_same(_snapshot(resumed), _snapshot(state))
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cuda"):
            tcli.main(argv[2:])


def test_theory_matches_jax():
    for m, n, k, d in [(1, 5, 10, 10), (1, 10, 10, 1), (2, 5, 5, 3), (3, 3, 4, 2), (1, 2, 1, 100)]:
        assert ttheory.game_value_mnk(m, n, d, k) == jtheory.game_value_mnk(m, n, d, k)
    for d, rho, delta in [(1, 0.5, 0.2), (10, 2.0, 0.5), (5, 0.1, 1.5)]:
        for fn in ("game_value_rho_delta", "ml_attacker_game_value_rho_delta",
                   "game_value_diff_ml_vs_opt_rho_delta"):
            assert getattr(ttheory, fn)(d, rho, delta) == getattr(jtheory, fn)(d, rho, delta)
    n, v = ttheory.game_value_as_func_of_n(1, 6, 4, 5)
    np.testing.assert_array_equal(v, jtheory.game_value_as_func_of_n(1, 6, 4, 5)[1])
    assert ttheory.game_value_mnk(m=1, n=5, d=10, k=10) == pytest.approx(0.921131, abs=1e-6)

