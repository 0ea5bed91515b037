"""Shared by the head-to-head script's tests: the script as a module, the paths, and
synthetic CSVs in the eval CLI's layout."""

from __future__ import annotations

import csv
import importlib.util
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
DOCS = REPO / "docs" / "hard_head_to_head"
SPEC = importlib.util.spec_from_file_location(
    "torch_hard_head_to_head", REPO / "scripts" / "torch_hard_head_to_head.py")
h2h = importlib.util.module_from_spec(SPEC)
SPEC.loader.exec_module(h2h)


def jax_header() -> list:
    with open(DOCS / "jax_hard_s2_eval_00004999.csv", newline="") as f:
        return next(csv.reader(f))


def write_port_csv(path: Path, aucs: dict) -> None:
    """A CSV in the eval CLI's layout with the given AUC per attacker."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(jax_header())
        for i, (im, auc) in enumerate(aucs.items()):
            w.writerow([i, "gim", im, "ds", "exp", 1, 5, 5, 0.5, 0.5, 0.5, auc])
