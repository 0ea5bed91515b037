"""Several flagship game steps of the port against the JAX reference's.

Both packages start from one transplanted state and take K = 3 steps on K
seeded uint8 batches at the flagship's step settings: ``ImageGameConfig``'s
own optimizer (au / im / noise-mapper lr 1e-6 / 1e-5 / 1e-7, Adam beta
(0, 0.99)), reg 0, img 32 (the flagship's stage count), m1 n5 k5 (its set
sizes), at narrow widths (style 32, B 2).  The start is the port's
initialisation carried into Flax (``state_dict_to_flax``), its instance
norms, attention gammas and ``init_img`` randomised as in the one-step test
(``test_torch_support.randomise_norms_and_gammas``), and carried back into
the port (``torch_state_from``).  Each step's noise is the reference's own
draw, recovered from its key (``split(fold_in(state.rng, step))``, the rng
carried forward) and injected into the port.  One compiled reference step
serves all K steps of a case.

What one step cannot see and K steps can: Adam's second moment after step 1
(with beta1 = 0 the first step is lr * sign(g)), the spectral u/v's second
advance, the noise stream after step 1, and the 32-px stages and n = k = 5
statistics.

**The reference's own spread.**  Past the set std (the one-step test's
docstring) the gradient magnifies f32 rounding about a thousandfold, and
over several steps that grows: an entry whose gradient lies within the
rounding floor takes either sign, Adam moves it 2 lr apart, and the next
steps' gradients start from states that differ by that much.  So a
comparison past the first step is measured against the reference's own
rounding: three more reference trajectories from the same start, the step
compiled at XLA's optimisation level 0 (the same math, fused and ordered
otherwise), and the default compile with every parameter multiplied by
(1 +- 2^-23) (one f32 ulp, random signs, seeds 1 and 2) before each step.
The spread of a quantity is its largest distance from the reference over the
three, per tensor and step; it is 0 where rounding cannot move the result.
The port rounds differently in every op, as a compile of its own, and is held
to twice the spread: two runs that each sit within the spread of the
reference sit within twice it of each other.

Compared after every step (f32):
  * the step counts of both Adams (``count`` against ``step``): equal, t + 1;
  * the metrics: the one-step test's rtol 1e-4 / atol 1e-6 (measured: at
    most 0.03 of it);
  * both players' gradients (with beta1 = 0 the first moment is the step's
    gradient): the one-step test's rule (rtol 1e-3; floors 1e-4 of the
    tensor's largest entry on the authenticator's src encoder and head,
    2e-3 elsewhere, and 1e-6 of the player's largest entry), plus twice the
    spread.  Measured: the authenticator within 0.36 of the one-step rule
    alone; the impersonator over it by 1.12, 5.6 and 13.4 times at steps
    1-3, within 0.48 of it with the spread;
  * Adam's second moment, as the bias-corrected RMS of the gradients so far,
    r = sqrt(nu / (1 - beta2^t)): at step 1 r = |g|, so the gradient's rule
    applies unchanged; later r is an RMS of gradients each held to that rule,
    and |rms(a) - rms(b)| <= rms(a - b), so the same rule holds on r (floors
    from r's largest entries, the spread r's own);
  * both players' spectral u/v: the one-step test's atol 1e-6, plus twice the
    spread (the impersonator's u/v move up to 9.7e-6 apart by step 3, from
    parameters 2 lr apart; measured within 0.72 of the tolerance).
After step K, the parameters, per entry.  Adam's step is lr * u_t with
u_t = g_t / (r_t + eps).  With |g' - g| <= a and |r' - r| <= a_r (the two
tests' tolerances above), |u' - u| <= (a + |u| a_r) / (r + eps - a_r) where
r + eps > a_r; and for any gradients |u_t| <= sqrt((1 - beta2^t) / (1 - beta2))
(nu_t holds at least (1 - beta2) g_t^2), so |u' - u| is at most twice that
(2 at t = 1: the one-step test's 2 lr).  The parameters are held to f32
rounding (rtol 1e-6, atol 1e-7) plus lr times the sum over the steps of the
smaller of the two bounds: tight where the gradient is large against its
tolerance at every step, 2 lr * 4.13 at K = 3 at most.

The bf16 case: the port's bf16 trajectory and the reference's bf16
trajectory as XLA compiles it by default, from the same start with the
reference's bf16 noise, each held against the f32 reference trajectory, as
``test_torch_train_step.py::test_bf16_r1_step_matches_jax`` holds one step.
At every step: the authenticator's gradient over its src encoder and head
(past the set std the env encoder's bf16 gradient is as far from the f32 one
as it is large; the attention f bias's is zero in exact arithmetic), per
tensor the relative (Frobenius) error against the f32 reference, in mean over
the tensors within a factor of 1.5 of the reference's bf16 step's, in max
within a factor of 1 (measured: means 0.062, 0.265, 0.061 against 0.128,
0.353, 0.198; maxima 0.10, 0.47, 0.23 against 0.62, 1.18, 0.94); the
metrics within the card's bf16 kernel bar, atol 1e-2 plus 2^-6 of the value
(measured: within 0.17 of it).

One compile of each reference step serves its K steps; the compiles run
beside the tracing and the steps.
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from optimalstrategiesagainstgenerativeattacks_torch.port.transplant import (
    flax_to_state_dict,
    state_dict_to_flax,
)
from optimalstrategiesagainstgenerativeattacks_torch.train import image as timg
from optimalstrategiesagainstgenerativeattacks_tpu.train import image as jimg
from optimalstrategiesagainstgenerativeattacks_tpu.train.state import GameState
from test_torch_support import (
    jax_build,
    jax_cfg,
    randomise_norms_and_gammas,
    small_cfg,
    torch_state_from,
    uint8_batch,
)

torch.set_num_threads(1)

K = 3
PLAYERS = ("au", "im")
PERTURB_SEEDS = (1, 2)
SPREAD_RUNS = ("jax_opt0",) + tuple(f"jax_ulp{s}" for s in PERTURB_SEEDS)
SPREAD_FACTOR = 2.0
CFG = small_cfg(img_size=32, n=5, k=5)  # ImageGameConfig's optimizer, reg 0


def adam_bound_sum(beta2: float, k: int = K) -> float:
    """S: the sum over steps 1..k of the bound on |u_t| (module docstring)."""
    return sum(np.sqrt((1 - beta2 ** t) / (1 - beta2)) for t in range(1, k + 1))


def start(cfg):
    """(au vars, im vars): the port's initialisation in Flax form, norms and gammas
    randomised."""
    au, im = timg.build_models(cfg)
    timg.create_state(cfg, au, im, 0, "cpu")
    rng = np.random.default_rng(100)
    out = []
    for module in (au, im):
        params, spectral = state_dict_to_flax(
            {k: v.numpy() for k, v in module.state_dict().items()})
        out.append({"params": randomise_norms_and_gammas(params, rng), "spectral": spectral})
    return tuple(out)


def adam_moments(opt_state):
    """({"mu": state dict, "nu": state dict}, [count of each Adam]) of an optax state."""
    found = []

    def walk(x):
        if hasattr(x, "mu") and hasattr(x, "nu"):
            found.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, tuple):
            for v in x:
                walk(v)

    walk(opt_state)
    out = {}
    for name in ("mu", "nu"):
        merged = {}
        for st in found:
            for path, leaf in flatten_dict(getattr(st, name)).items():
                if hasattr(leaf, "shape"):
                    merged[path] = np.asarray(leaf, np.float32)
        out[name] = flax_to_state_dict(unflatten_dict(merged), {})
    return out, [int(st.count) for st in found]


def jax_record(jstate, metrics):
    rec = {"metrics": {k: float(v) for k, v in metrics.items()}}
    for player in PLAYERS:
        moments, counts = adam_moments(getattr(jstate, f"opt_{player}"))
        rec[player] = dict(moments, counts=counts, spectral=flax_to_state_dict(
            {}, jax.tree.map(lambda x: np.asarray(x, np.float32),
                             getattr(jstate, f"spectral_{player}"))))
    return rec


def port_record(tstate, metrics):
    rec = {"metrics": {k: float(v) for k, v in metrics.items()}}
    for player in PLAYERS:
        module, opt = getattr(tstate, player), getattr(tstate, f"opt_{player}")
        named = list(module.named_parameters())
        # copies: the optimizer and the power iteration update these tensors in place
        rec[player] = {
            "mu": {k: opt.state[p]["exp_avg"].numpy().copy() for k, p in named},
            "nu": {k: opt.state[p]["exp_avg_sq"].numpy().copy() for k, p in named},
            "counts": sorted({int(opt.state[p]["step"]) for _, p in named}),
            "spectral": {k: b.numpy().copy() for k, b in module.named_buffers()},
        }
    return rec


def one_ulp(tree, rng):
    return jax.tree.map(lambda x: (np.asarray(x) * (1 + 2.0 ** -23 * rng.choice(
        [-1.0, 1.0], np.shape(x)))).astype(np.float32), tree)


class Reference:
    """The reference game for one config from (av, iv): its start state, its step
    lowered once, and its noise draw."""

    def __init__(self, cfg, av, iv, batch):
        jau, jim = jax_build(cfg)
        jcfg = jax_cfg(cfg)
        opt_au, opt_im, _ = jimg.make_optimizers(jcfg)
        self.state = GameState(
            step=jnp.asarray(-1, jnp.int32), params_au=av["params"], params_im=iv["params"],
            spectral_au=av["spectral"], spectral_im=iv["spectral"],
            opt_au=opt_au.init(av["params"]), opt_im=opt_im.init(iv["params"]),
            rng=jax.random.PRNGKey(7))
        self.lowered = jax.jit(jimg.make_train_step_fn(jcfg, jau, jim, opt_au, opt_im)).lower(
            self.state, {k: jnp.asarray(v) for k, v in batch.items()})
        shape = (cfg.batch_size, cfg.n, cfg.style_dim)
        z_dtype = jnp.bfloat16 if cfg.compute_dtype == "bfloat16" else jnp.float32
        # the reference step's draw: rng, k_noise = split(fold_in(state.rng, step)), z at
        # the impersonator's root in the compute dtype
        self.draw = jax.jit(lambda rng, step: jim.apply(
            iv, method=lambda m: jax.random.normal(m.make_rng("noise"), shape, z_dtype),
            rngs={"noise": jax.random.split(jax.random.fold_in(rng, step))[1]}))


def run_reference(ref, step_fn, batches, perturb_seed=None):
    """K reference steps -> ([record of each step], final state); with ``perturb_seed``
    every parameter is moved by one f32 ulp (random signs) before each step."""
    rng = None if perturb_seed is None else np.random.default_rng(perturb_seed)
    state, records = ref.state, []
    for batch in batches:
        if rng is not None:
            state = state.replace(params_au=one_ulp(state.params_au, rng),
                                  params_im=one_ulp(state.params_im, rng))
        state, metrics, _ = step_fn(state, {k: jnp.asarray(v) for k, v in batch.items()})
        records.append(jax_record(state, metrics))
    return records, state


def run_port(cfg, ref, av, iv, batches):
    """K steps of the port from (av, iv) with the reference's noise of each step ->
    ([record of each step], final state)."""
    tstate, records, rng = torch_state_from(cfg, av, iv), [], ref.state.rng
    for t, batch in enumerate(batches):
        z = np.asarray(ref.draw(rng, t), np.float32)
        rng = jax.random.split(jax.random.fold_in(rng, t))[0]  # the reference carries it
        metrics, _ = timg.train_step(tstate, batch, z=torch.from_numpy(z.copy()))
        records.append(port_record(tstate, metrics))
    return records, tstate


@functools.cache
def cases():
    """{name: ([record of each step], final state)}: the f32 reference ("jax"), the
    reference compiled at XLA's optimisation level 0 ("jax_opt0") and perturbed by one
    ulp before each step ("jax_ulp1", "jax_ulp2"), the port ("port"); the reference's
    bf16 step as XLA compiles it by default ("jax_bf16") and the port's ("port_bf16")."""
    av, iv = start(CFG)
    batches = [uint8_batch(CFG, seed=20 + t) for t in range(K)]
    cfg16 = dataclasses.replace(CFG, compute_dtype="bfloat16")
    # XLA compiles outside the GIL: the f32 compiles run while the bf16 step is
    # traced, and the bf16 compile while the f32 trajectories run
    ref = Reference(CFG, av, iv, batches[0])
    with ThreadPoolExecutor(3) as pool:
        step = pool.submit(ref.lowered.compile)
        step_opt0 = pool.submit(ref.lowered.compile,
                                compiler_options={"xla_backend_optimization_level": 0})
        ref16 = Reference(cfg16, av, iv, batches[0])
        step16 = pool.submit(ref16.lowered.compile)
        out = {"jax": run_reference(ref, step.result(), batches),
               "port": run_port(CFG, ref, av, iv, batches)}
        for seed in PERTURB_SEEDS:
            out[f"jax_ulp{seed}"] = run_reference(ref, step.result(), batches, seed)
        out["jax_opt0"] = run_reference(ref, step_opt0.result(), batches)
        out["port_bf16"] = run_port(cfg16, ref16, av, iv, batches)
        out["jax_bf16"] = run_reference(ref16, step16.result(), batches)
    return out


def records(name):
    return cases()[name][0]


def spread_of(t, get):
    """Twice the reference's own spread of ``get(record)`` at step t: its largest
    distance from the reference over the other compile and the perturbed runs (a
    per-tensor scalar for arrays)."""
    want = get(records("jax")[t])
    return SPREAD_FACTOR * max(float(np.max(np.abs(get(records(name)[t]) - want)))
                               for name in SPREAD_RUNS)


def floors(tensors: dict, player: str) -> dict:
    """The one-step test's absolute floor of each tensor: 1e-4 (the authenticator's
    src encoder and head) or 2e-3 (past the set std) of its largest entry, and at
    least 1e-6 of the player's largest entry."""
    player_max = max(np.abs(w).max() for w in tensors.values())
    return {k: max((2e-3 if player == "im" or k.startswith("encoders.env.") else 1e-4)
                   * np.abs(w).max(), 1e-6 * player_max) for k, w in tensors.items()}


def rms(nu: dict, t: int, beta2: float) -> dict:
    """The bias-corrected RMS of the gradients through step t + 1."""
    return {k: np.sqrt(v / (1 - beta2 ** (t + 1))) for k, v in nu.items()}


def test_trajectory_adam_counts_match_jax():
    want, got = records("jax"), records("port")
    for t in range(K):
        for player in PLAYERS:
            assert got[t][player]["counts"] == [t + 1], (t, player)
            assert set(want[t][player]["counts"]) == {t + 1}, (t, player)


def test_trajectory_metrics_match_jax():
    want, got = records("jax"), records("port")
    for t in range(K):
        assert set(got[t]["metrics"]) == set(want[t]["metrics"]) == set(timg.METRIC_KEYS)
        for k in timg.METRIC_KEYS:
            tol = 1e-6 + 1e-4 * abs(want[t]["metrics"][k])
            assert abs(got[t]["metrics"][k] - want[t]["metrics"][k]) <= tol, (t, k)


@pytest.mark.parametrize("player", PLAYERS)
def test_trajectory_gradients_match_jax(player):
    want, got = records("jax"), records("port")
    for t in range(K):
        ref = want[t][player]["mu"]
        assert set(got[t][player]["mu"]) == set(ref)
        fl = floors(ref, player)
        for k, g in got[t][player]["mu"].items():
            atol = fl[k] + spread_of(t, lambda r: r[player]["mu"][k])
            np.testing.assert_allclose(g, ref[k], rtol=1e-3, atol=atol, err_msg=f"{t} {k}")


@pytest.mark.parametrize("player", PLAYERS)
def test_trajectory_adam_second_moment_matches_jax(player):
    want, got = records("jax"), records("port")
    beta2 = CFG.beta2
    for t in range(K):
        ref = rms(want[t][player]["nu"], t, beta2)
        fl = floors(ref, player)
        for k, r in rms(got[t][player]["nu"], t, beta2).items():
            atol = fl[k] + spread_of(t, lambda rec: rms(
                {k: rec[player]["nu"][k]}, t, beta2)[k])
            np.testing.assert_allclose(r, ref[k], rtol=1e-3, atol=atol, err_msg=f"{t} {k}")


@pytest.mark.parametrize("player", PLAYERS)
def test_trajectory_spectral_state_matches_jax(player):
    want, got = records("jax"), records("port")
    for t in range(K):
        ref = want[t][player]["spectral"]
        assert set(got[t][player]["spectral"]) == set(ref)
        for k, v in got[t][player]["spectral"].items():
            atol = 1e-6 + spread_of(t, lambda r: r[player]["spectral"][k])
            np.testing.assert_allclose(v, ref[k], rtol=0, atol=atol, err_msg=f"{t} {k}")


@functools.cache
def grad_atol(t: int, player: str) -> dict:
    """The gradient test's absolute tolerance of each tensor at step t."""
    want = records("jax")[t][player]["mu"]
    return {k: fl + spread_of(t, lambda r: r[player]["mu"][k])
            for k, fl in floors(want, player).items()}


@functools.cache
def rms_atol(t: int, player: str) -> dict:
    """The second-moment test's absolute tolerance of each tensor's r at step t."""
    beta2 = CFG.beta2
    want = rms(records("jax")[t][player]["nu"], t, beta2)
    return {k: fl + spread_of(t, lambda r: rms({k: r[player]["nu"][k]}, t, beta2)[k])
            for k, fl in floors(want, player).items()}


def update_bound(player: str, k: str, lr: float) -> np.ndarray:
    """Per entry, how far two runs whose gradients and second moments meet those tests'
    tolerances at every step can end apart (module docstring)."""
    beta2, eps = CFG.beta2, 1e-8
    total = 0.0
    for t in range(K):
        rec = records("jax")[t][player]
        g, r = rec["mu"][k], rms({k: rec["nu"][k]}, t, beta2)[k]
        a = 1e-3 * np.abs(g) + grad_atol(t, player)[k]
        a_r = 1e-3 * r + rms_atol(t, player)[k]
        worst = 2 * np.sqrt((1 - beta2 ** (t + 1)) / (1 - beta2))
        with np.errstate(divide="ignore", invalid="ignore"):
            du = (a + np.abs(g) / (r + eps) * a_r) / (r + eps - a_r)
        total = total + lr * np.where(r + eps > a_r, np.minimum(du, worst), worst)
    return total


@pytest.mark.parametrize("player", PLAYERS)
def test_trajectory_params_match_jax(player):
    jstate, tstate = cases()["jax"][1], cases()["port"][1]
    ref = flax_to_state_dict(jax.tree.map(np.asarray, getattr(jstate, f"params_{player}")), {})
    got = {k: p.detach().numpy() for k, p in getattr(tstate, player).named_parameters()}
    assert set(got) == set(ref)
    s = adam_bound_sum(CFG.beta2)
    tight = 0
    for k, p in got.items():
        lr = CFG.au_lr if player == "au" else (
            CFG.env_noise_mapping_lr if k.startswith("env_noise_mapper.") else CFG.im_lr)
        bound = update_bound(player, k, lr)
        assert np.all(bound <= 2 * lr * s * (1 + 1e-6)), k
        tight += int((bound < 0.1 * lr).sum())
        assert np.all(np.abs(p - ref[k]) <= 1e-7 + 1e-6 * np.abs(ref[k]) + bound), k
    assert tight > 0


def test_bf16_trajectory_metrics_match_jax():
    want32, port16 = records("jax"), records("port_bf16")
    for t in range(K):
        for k in timg.METRIC_KEYS:
            ref = want32[t]["metrics"][k]
            assert abs(port16[t]["metrics"][k] - ref) <= 1e-2 + 2.0 ** -6 * abs(ref), (t, k)


def test_bf16_trajectory_au_gradients_match_jax():
    want32, jax16, port16 = records("jax"), records("jax_bf16"), records("port_bf16")
    keys = [k for k in want32[0]["au"]["mu"]
            if not k.startswith("encoders.env.") and not k.endswith("att.conv_f.bias")]
    for t in range(K):
        ref = want32[t]["au"]["mu"]

        def rel_errors(rec):
            return np.array([np.linalg.norm(rec["au"]["mu"][k] - ref[k]) / np.linalg.norm(ref[k])
                             for k in keys])

        port, ref16 = rel_errors(port16[t]), rel_errors(jax16[t])
        assert port.mean() <= 1.5 * ref16.mean(), t
        assert port.max() <= ref16.max(), t
