"""Every training and eval loop of the port turns TF32 off before it builds anything:
an f32 conv or matmul on the card is then the exact f32 product that the reference's
CPU compile computes (``ops/precision.py:exact_f32``)."""

from __future__ import annotations

import importlib

import pytest
import torch

from optimalstrategiesagainstgenerativeattacks_torch.ops import precision

PKG = "optimalstrategiesagainstgenerativeattacks_torch"
# (module, loop function, its positional arguments): the loops the CLIs call
LOOPS = [
    ("train.image", "train_gim_imgs", 3),
    ("train.multiseed", "train_multiseed_gim_imgs", 5),
    ("train.gaussian", "train_gim_gaussian", 1),
    ("baselines.training", "train_siamese", 2),
    ("baselines.training", "train_arcface", 2),
    ("eval.authentication", "eval_authentication_task", 8),
]


class Stop(Exception):
    pass


def tf32_on(monkeypatch) -> None:
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)


def test_exact_f32_turns_both_flags_off(monkeypatch):
    tf32_on(monkeypatch)
    precision.exact_f32()
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


@pytest.mark.parametrize("module,name,n_args", LOOPS, ids=[n for _, n, _ in LOOPS])
def test_each_loop_turns_tf32_off_first(monkeypatch, module, name, n_args):
    """The loop's first act: its arguments are all None, so anything it did before
    ``exact_f32`` would raise something else than the spy's Stop."""
    mod = importlib.import_module(f"{PKG}.{module}")
    tf32_on(monkeypatch)

    def spy():
        precision.exact_f32()
        raise Stop

    monkeypatch.setattr(mod, "exact_f32", spy)
    with pytest.raises(Stop):
        getattr(mod, name)(*[None] * n_args)
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
