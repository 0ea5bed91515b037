#!/usr/bin/env python
"""Where the port's bf16 roundings meet XLA's: the readings of every candidate site.

For each site of the image game's main path (``tests/bf16_sites_support.py``:
the block that makes a bf16 value and the consumer that reads it, built from
the JAX package's modules and from the submodules of the port's players, with
the same weights; ``tests/bf16_sites_jax.py`` compiles and compares them) at
the flagship (32x32x1, style 512) and VoxCeleb (64x64x3, style 512) widths, a
batch of 2, prints the mean absolute error at the consumer's output against
the JAX chain in f32 of:

  jax_default     the JAX chain in bf16 as XLA compiles it by default
  jax_as_written  the same with ``xla_allow_excess_precision`` off
  port_rounded    the port with the site's value rounded to bf16
  port_f32        the port with the site's value kept in f32
  port            the port as it runs

the mean distance of each port reading to the default compile's output, and
the verdict: ``XLA keeps f32`` where the default compile tracks the port with
the value in f32 and the as-written compile the port with it rounded
(``xla_keeps_f32``), else ``both round``.  ``--bias_scales``: the
conv and linear biases drawn at these scales (0: as initialised, with the
instance norms and attention gammas randomised); at 30 the rounding of a value
with a large per-channel offset dominates the chain's error, which is where a
site's rounding shows.  CPU only (JAX and the port):

    python scripts/torch_bf16_sites.py [--configs flagship vox] [--bias_scales 0 30]
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
os.environ["JAX_PLATFORMS"] = "cpu"  # before jax is imported

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")  # wins over a platform plugin's own choice

import bf16_sites_jax as sites  # noqa: E402
import bf16_sites_support as support  # noqa: E402

CONFIGS = {"flagship": support.FLAGSHIP, "vox": support.VOX, "small": support.SMALL}
KEYS = ("jax_default", "jax_as_written", "port_rounded", "port_f32", "port")
TRACK = ("port_rounded", "port_f32", "port")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", nargs="+", default=["flagship", "vox"], choices=list(CONFIGS))
    ap.add_argument("--bias_scales", type=float, nargs="+", default=[0.0, 30.0])
    ap.add_argument("--sites", nargs="+", default=["1", "2", "3", "4", "5"])
    args = ap.parse_args(argv)
    print("| config | bias | site | chain | " + " | ".join(KEYS)
          + " | rounded / f32 / port ~ jax_default | |y| | verdict |")
    print("|---" * (len(KEYS) + 7) + "|")
    for name in args.configs:
        cfg = CONFIGS[name]
        players = cfg.players()
        for scale in args.bias_scales:
            for case in support.cases(cfg):
                if case.site not in args.sites:
                    continue
                t0 = time.perf_counter()
                r = sites.readings(case, cfg, players, bias_scale=scale)
                keeps = sites.xla_keeps_f32(r)
                track = " / ".join(f"{r[f'{k} ~ jax_default']:.2e}" for k in TRACK)
                print(f"| {name} | {scale:g} | {case.site} | {case.name} | "
                      + " | ".join(f"{r[k]:.3e}" for k in KEYS)
                      + f" | {track} | {r['ref']:.3g} | "
                      f"{'XLA keeps f32' if keeps else 'both round'} |"
                      f" <!-- {time.perf_counter() - t0:.1f} s -->", flush=True)


if __name__ == "__main__":
    main()
