#!/usr/bin/env python
"""Readings behind ``tests/test_torch_models.py::test_bf16_players_match_jax``.

Under the tests' own JAX set-up (``tests/conftest.py``: CPU, apply under
jit), at the test's config and inputs, prints for the port's bf16 fake and
for the JAX reference's bf16 fake their distance to the f32 reference fake
(max and mean), and the ratio port / reference that the test bounds.  Two
references: XLA's default compile, which may keep fused bf16 intermediates
in f32, and the compile with ``xla_allow_excess_precision`` off, which keeps
every rounding the JAX code writes.  Two ports: the attention core's P
rounded to bf16 before the second product (the port's function), and P
left in f32 (the port before that rounding).

    python scripts/torch_bf16_fake_readings.py
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import conftest  # noqa: E402  (sets the JAX platform before jax is used)

conftest.pytest_configure(None)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from optimalstrategiesagainstgenerativeattacks_torch.kernels import attention as k2  # noqa: E402
from test_torch_models import _apply_as_written  # noqa: E402
from test_torch_support import init_jax_players, jax_build, small_cfg, torch_state_from  # noqa: E402


def _p_in_f32(f, g, h):
    s = torch.bmm(f.float(), g.float().transpose(1, 2))
    return torch.bmm(torch.softmax(s, dim=1).transpose(1, 2), h.float()).to(h.dtype)


def main():
    cfg = small_cfg()  # the test module's fixtures
    _, jim, av, iv = init_jax_players(cfg)
    rng = np.random.default_rng(1)
    s = cfg.img_size

    def imgs(n):
        return rng.uniform(-1, 1, (cfg.batch_size, n, s, s, 1)).astype(np.float32)

    z = rng.standard_normal((cfg.batch_size, cfg.n, cfg.style_dim)).astype(np.float32)
    test, si, leaked = imgs(cfg.n), imgs(cfg.k), imgs(cfg.m)
    cfg16 = small_cfg(compute_dtype="bfloat16")
    _, jim16 = jax_build(cfg16)
    f32_fake = np.asarray(jim.apply(iv, leaked, cfg.n, True, False, z=z))
    refs = {
        "default": np.asarray(jim16.apply(iv, leaked, cfg.n, True, False, z=z)),
        "as_written": np.asarray(_apply_as_written(jim16, iv, leaked, cfg.n, True, False, z=z)),
    }
    rounded = k2.attention_core_ref
    for port, core in (("P bf16", rounded), ("P f32", _p_in_f32)):
        k2.attention_core_ref = core
        state = torch_state_from(cfg16, av, iv)
        with torch.no_grad():
            fake = state.im(torch.from_numpy(leaked).bfloat16(), cfg.n, True,
                            z=torch.from_numpy(z)).float().numpy()
        pe = np.abs(fake - f32_fake)
        for name, ref in refs.items():
            ref = ref.astype(np.float32)
            re = np.abs(ref - f32_fake)
            print(f"port {port:6s} ref {name:10s}  port_err max {pe.max():.6f} mean {pe.mean():.6f}"
                  f"  ref_err max {re.max():.6f} mean {re.mean():.6f}"
                  f"  ratio max {pe.max() / re.max():.4f} mean {pe.mean() / re.mean():.4f}"
                  f"  |port-ref| mean {np.abs(fake - ref).mean():.6f}")
    k2.attention_core_ref = rounded


if __name__ == "__main__":
    main()
