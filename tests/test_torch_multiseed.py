"""Multi-seed training of the port against the JAX package's, on the CPU.

* ``multiseed_train_step`` against the JAX ``make_multiseed_train_step``
  (``jit(vmap(step))``): S=2, one step from two transplanted states, each
  seed's noise draw recovered from its key and injected, held to the
  tolerances of ``test_torch_train_step.py`` (gradients, spectral state,
  metrics, parameters), seed by seed.
* Seed s of ``multiseed_train_step`` equals a single-seed run at seed s, bit
  for bit (players, Adams, schedulers, generator) over two steps.
* ``set_seed_lr``: two identical seeds at different LRs take first Adam
  updates in the ratio of their LRs; the env-noise mapper keeps its LR and
  moves alike in both; a config with milestones is refused.
* The multi-seed CLI: the JAX CLI's flags and defaults plus ``--device``;
  LR lists of the wrong length refused; a ``--device cpu`` run writes
  ``seed_<s>/args.json`` and checkpoints that the eval restore reads.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from optimalstrategiesagainstgenerativeattacks_torch import train_multiseed_gim_on_imgs as tcli
from optimalstrategiesagainstgenerativeattacks_torch.eval import authentication as teval
from optimalstrategiesagainstgenerativeattacks_torch.port.transplant import flax_to_state_dict
from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
from optimalstrategiesagainstgenerativeattacks_torch.train import multiseed as tms
from optimalstrategiesagainstgenerativeattacks_torch.utils.config import ImageGameConfig
from optimalstrategiesagainstgenerativeattacks_tpu.train import image as jimg
from optimalstrategiesagainstgenerativeattacks_tpu.train import multiseed as jms
from optimalstrategiesagainstgenerativeattacks_tpu.train.state import GameState
from test_cli_parity import _flags
from test_torch_loop import _assert_same, _snapshot, _write_tree
from test_torch_support import (
    init_jax_players,
    jax_build,
    jax_cfg,
    small_cfg,
    torch_state_from,
    uint8_batch,
)
from test_torch_train_step import (
    MAX_R1_SIGN_FLIPS,
    PLAYERS,
    _adam_mu,
    _grad_floors,
    _torch_grads,
)

torch.set_num_threads(1)

S = 2


@pytest.fixture(scope="module")
def one_multistep():
    """(cfg, JAX states after the step, JAX metrics {name: [S]}, port state, port metrics)."""
    cfg = small_cfg(batch_size=4)
    av, iv = init_jax_players(cfg)[2:]
    # seed 1's players: seed 0's, each weight scaled entry by entry (one JAX init, not two)
    rng = np.random.default_rng(1)
    players = [(av, iv)] + [
        tuple({"params": jax.tree.map(lambda x: x * rng.uniform(0.5, 1.5, np.shape(x))
                                      .astype(np.float32), v["params"]),
               "spectral": v["spectral"]} for v in (av, iv))]
    batches = [uint8_batch(cfg, seed=10 + s) for s in range(S)]
    jau, jim = jax_build(cfg)
    opt_au, opt_im, _ = jimg.make_optimizers(jax_cfg(cfg))
    states, zs = [], []
    for s, (av, iv) in enumerate(players):
        rng = jax.random.PRNGKey(7 + s)
        states.append(GameState(
            step=jnp.asarray(-1, jnp.int32), params_au=av["params"], params_im=iv["params"],
            spectral_au=av["spectral"], spectral_im=iv["spectral"],
            opt_au=opt_au.init(av["params"]), opt_im=opt_im.init(iv["params"]), rng=rng))
        # each seed's draw, as the step makes it: split(fold_in(rng, step)), z at the root
        _, k_noise = jax.random.split(jax.random.fold_in(rng, 0))
        shape = (cfg.batch_size, cfg.n, cfg.style_dim)
        zs.append(np.asarray(jim.apply(
            iv, method=lambda m: jax.random.normal(m.make_rng("noise"), shape, jnp.float32),
            rngs={"noise": k_noise})))
    step_fn = jms.make_multiseed_train_step(jax_cfg(cfg), jau, jim, opt_au, opt_im)
    jbatches = jms.stack_batches([{k: jnp.asarray(v) for k, v in b.items()} for b in batches])
    new_jstate, jmetrics, jfake = step_fn(jms.stack_states(states), jbatches)
    assert jfake.shape == (S, cfg.batch_size, cfg.n, 16, 16, 1)

    ms = tms.stack_states([torch_state_from(cfg, av, iv) for av, iv in players])
    metrics, fake = tms.multiseed_train_step(
        ms, tms.stack_batches([{k: torch.from_numpy(v) for k, v in b.items()} for b in batches]),
        z=torch.from_numpy(np.stack(zs)))
    assert tuple(fake.shape) == (S, cfg.batch_size, cfg.n, 16, 16, 1)
    assert all(v.shape == (S,) for v in metrics.values())
    return (cfg, [jms.slice_seed(new_jstate, s) for s in range(S)],
            {k: np.asarray(v) for k, v in jmetrics.items()}, ms,
            {k: v.numpy() for k, v in metrics.items()})


@pytest.mark.parametrize("player", PLAYERS)
def test_multiseed_gradients_match_jax(one_multistep, player):
    _, jstates, _, ms, _ = one_multistep
    for s in range(S):
        want = flax_to_state_dict(_adam_mu(getattr(jstates[s], f"opt_{player}")), {})
        got = _torch_grads(tms.slice_seed(ms, s), player)
        assert set(got) == set(want)
        floors = _grad_floors(want, player)
        for k, g in got.items():
            np.testing.assert_allclose(g, want[k], rtol=1e-3, atol=floors[k],
                                       err_msg=f"seed {s} {k}")


def test_multiseed_spectral_state_and_metrics_match_jax(one_multistep):
    _, jstates, jmetrics, ms, metrics = one_multistep
    for s in range(S):
        for player in PLAYERS:
            want = flax_to_state_dict(
                {}, jax.tree.map(np.asarray, getattr(jstates[s], f"spectral_{player}")))
            got = {k: b.numpy() for k, b in getattr(tms.slice_seed(ms, s), player).named_buffers()}
            assert set(got) == set(want)
            for k, v in got.items():
                np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-6, err_msg=f"{s} {k}")
    assert set(metrics) == set(jmetrics) == set(timg.METRIC_KEYS)
    for k in timg.METRIC_KEYS:
        np.testing.assert_allclose(metrics[k], jmetrics[k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("player", PLAYERS)
def test_multiseed_params_match_jax(one_multistep, player):
    cfg, jstates, _, ms, _ = one_multistep
    for s in range(S):
        jstate, tstate = jstates[s], tms.slice_seed(ms, s)
        want = flax_to_state_dict(jax.tree.map(np.asarray, getattr(jstate, f"params_{player}")), {})
        grads = flax_to_state_dict(_adam_mu(getattr(jstate, f"opt_{player}")), {})
        floors = _grad_floors(grads, player)
        for k, p in getattr(tstate, player).named_parameters():
            p = p.detach().numpy()
            lr = cfg.au_lr if player == "au" else (
                cfg.env_noise_mapping_lr if k.startswith("env_noise_mapper.") else cfg.im_lr)
            big = np.abs(grads[k]) > 1e-6
            # the R1 rule of test_torch_train_step.py: a few entries whose gradient
            # lies within the gradient test's floor may take another Adam step
            off = big & (np.abs(p - want[k]) > 1e-7 + 1e-6 * np.abs(want[k]))
            assert off.sum() <= MAX_R1_SIGN_FLIPS, (s, k, int(off.sum()))
            assert np.all(np.abs(grads[k][off]) <= floors[k]), (s, k)
            big &= ~off
            np.testing.assert_allclose(p[big], want[k][big], rtol=1e-6, atol=1e-7,
                                       err_msg=f"seed {s} {k}")
            assert np.all(np.abs(p[~big] - want[k][~big]) <= 2 * lr), (s, k)


def test_each_seed_equals_its_single_seed_run():
    cfg = small_cfg(milestones=[1], seed=99)
    seeds = [3, 5]
    streams = [[uint8_batch(cfg, seed=100 * s + t) for t in range(2)] for s in seeds]
    ms = tms.create_multiseed_state(cfg, seeds, "cpu")
    assert tms.n_seeds(ms) == 2 and ms.seeds == seeds
    history = []
    for t in range(2):
        metrics, _ = tms.multiseed_train_step(
            ms, tms.stack_batches([streams[i][t] for i in range(2)]))
        history.append(metrics)
    for i, s in enumerate(seeds):
        seed_cfg = dataclasses.replace(cfg, seed=s)
        au, im = timg.build_models(seed_cfg)
        single = timg.create_state(seed_cfg, au, im, s, "cpu")
        single_history = [timg.train_step(single, b)[0] for b in streams[i]]
        _assert_same(_snapshot(tms.slice_seed(ms, i)), _snapshot(single))
        for got, want in zip(history, single_history):
            for k in timg.METRIC_KEYS:
                assert got[k][i].item() == want[k].item(), (s, k)
    restacked = tms.stack_states([tms.slice_seed(ms, i) for i in range(2)])
    assert restacked.seeds == seeds and restacked.states == ms.states


def test_set_seed_lr_scales_each_seeds_updates():
    """Two seeds with the same init and batch differ only in their LRs, so each
    first Adam update is in the ratio of the LRs; the env-noise mapper, whose LR
    is not set, moves alike in both."""
    cfg = small_cfg(seed=5)
    lrs_au, lrs_im = [1e-4, 1e-3], [2e-4, 5e-4]
    ms = tms.create_multiseed_state(cfg, [5, 5], "cpu")
    init = [{p: {k: v.detach().clone() for k, v in getattr(st, p).named_parameters()}
             for p in PLAYERS} for st in ms.states]
    tms.set_seed_lr(ms, "au", lrs_au)
    tms.set_seed_lr(ms, "im", lrs_im)
    for st, au_lr, im_lr in zip(ms.states, lrs_au, lrs_im):
        assert st.sched_au.get_last_lr() == [au_lr]
        assert st.sched_im.get_last_lr() == [im_lr, cfg.env_noise_mapping_lr]
    batch = uint8_batch(cfg, seed=7)
    tms.multiseed_train_step(ms, tms.stack_batches([batch, batch]))
    for player, lrs in (("au", lrs_au), ("im", lrs_im)):
        moved = [{k: p.detach() - init[i][player][k]
                  for k, p in getattr(ms.states[i], player).named_parameters()} for i in range(2)]
        noise = [k for k in moved[0] if k.startswith("env_noise_mapper.")]
        assert bool(noise) == (player == "im")
        for k in noise:
            assert torch.equal(moved[0][k], moved[1][k]), k
        main = [k for k in moved[0] if k not in noise]
        d0 = torch.cat([moved[0][k].ravel() for k in main])
        d1 = torch.cat([moved[1][k].ravel() for k in main])
        mask = d0.abs() > 1e-6
        assert mask.sum() > 100
        np.testing.assert_allclose((d1[mask] / d0[mask]).numpy(), lrs[1] / lrs[0], rtol=2e-2,
                                   err_msg=player)
    # the LRs hold beyond the first step: MultiStepLR without milestones keeps them
    tms.multiseed_train_step(ms, tms.stack_batches([batch, batch]))
    assert [st.opt_au.param_groups[0]["lr"] for st in ms.states] == lrs_au


def test_set_seed_lr_refuses_milestones_and_wrong_lengths():
    ms = tms.create_multiseed_state(small_cfg(milestones=[10]), [1, 2], "cpu")
    with pytest.raises(ValueError, match="milestones"):
        tms.set_seed_lr(ms, "au", [1e-4, 2e-4])
    ms = tms.create_multiseed_state(small_cfg(), [1, 2], "cpu")
    with pytest.raises(ValueError, match="2 seeds"):
        tms.set_seed_lr(ms, "im", [1e-4])
    with pytest.raises(ValueError, match="player"):
        tms.set_seed_lr(ms, "noise", [1e-4, 1e-4])


def test_cli_flags_are_the_jax_clis_plus_device():
    port = tcli.build_parser()
    port_flags = {s for a in port._actions for s in a.option_strings}
    assert port_flags - {"--device"} == _flags("train_multiseed_gim_on_imgs")
    defaults = vars(port.parse_args(["-o", "out", "--dataset_root", "ds", "--seeds", "1"]))
    assert defaults["device"] == "cuda"
    cfg = ImageGameConfig.from_dict(defaults)
    assert (cfg.img_size, cfg.style_dim, cfg.batch_size, cfg.m, cfg.n, cfg.k) == (
        16, 64, 16, 1, 5, 5)
    assert (defaults["n_steps"], defaults["save_every"], defaults["log_every"]) == (2000, 400, 50)


def test_cli_writes_seed_directories_that_the_eval_restore_reads(tmp_path):
    root = _write_tree(tmp_path / "ds", "omniglot")
    out = tmp_path / "out"
    argv = ["--dataset_root", root, "-o", str(out), "--seeds", "2", "3", "--device", "cpu",
            "--n_steps", "3", "--save_every", "2", "--log_every", "1", "--img_size", "16",
            "--style_dim", "32", "--batch_size", "2", "--n", "2", "--k", "2",
            "--ds_n_examples_per_cls", "1", "--compute_dtype", "float32",
            "--au_lrs", "1e-4", "2e-4"]
    with pytest.raises(SystemExit, match="one LR per seed"):
        tcli.main(argv + ["--im_lrs", "1e-4"])
    ms = tcli.main(argv)
    assert [st.step for st in ms.states] == [2, 2]
    assert [st.opt_au.param_groups[0]["lr"] for st in ms.states] == [1e-4, 2e-4]
    for i, s in enumerate((2, 3)):
        seed_dir = out / f"seed_{s}"
        assert sorted(os.listdir(seed_dir / "ckpts")) == ["model_00000002", "model_00000003"]
        saved = json.loads((seed_dir / "args.json").read_text())
        assert saved["seed"] == s and saved["outdir"] == str(seed_dir)
        assert not {"seeds", "au_lrs", "im_lrs"} & set(saved)
        assert saved["device"] == "cpu" and saved["n_steps"] == 3
        ckpt, args = teval.get_exp_args_from_dir(str(seed_dir))
        assert ckpt.endswith("model_00000003")
        au = teval.get_gim_authenticator(ckpt, args, "cpu")
        test = np.random.default_rng(s).uniform(-1, 1, (2, 2, 16, 16, 1)).astype(np.float32)
        with torch.no_grad():
            want = tms.slice_seed(ms, i).au(torch.from_numpy(test), torch.from_numpy(test))
        np.testing.assert_array_equal(au.act(test_sample=test, si_sample=test)[0], want.numpy())
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="cuda"):
            tcli.main(argv[:argv.index("--device")] + argv[argv.index("--device") + 2:])
