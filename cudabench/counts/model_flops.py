"""Model FLOPs of one train step, counted over the frozen reference.

``torch.utils.flop_counter.FlopCounterMode`` over one step of
``cudabench/reference/game.py`` on the ``meta`` device, at the configuration's
shapes: the forward, the backward and, with R1, its double backward, as the
plain reference computes them (nothing recomputed).  So the count reads the
same work whatever a later change does to the program.

The reference keeps the plain form of the convs that the program (and the JAX
package before it) folds: a residual down block's second conv followed by a
2x2 pool, and an up block's first conv of the 2x nearest-upsampled input.
Counted so, each such conv holds 9/4 of the multiply-adds of its folded form
(for a kernel of k taps, 4 k^2 / (k + 1)^2).  ``count`` counts the folded form,
the work the model needs: it swaps those blocks' forwards, for the count alone,
for the stride-2 conv and the stride-2 transposed conv with the folded kernel,
as the program runs them.

The count is cached under ``build/cudabench/`` in the checkout, keyed by a hash
of the reference's sources, this file and the configuration, so it is counted
again whenever any of them changes.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path

import torch
import torch.nn.functional as F

HERE = Path(__file__).resolve().parents[1]
CACHE = HERE.parent / "build" / "cudabench"


def _fold(w: torch.Tensor) -> torch.Tensor:
    """[O, I, k, k] -> [O, I, k + 1, k + 1]: the sum of the kernel's four 2x2 shifts."""
    wp = F.pad(w, (1, 1, 1, 1))
    return wp[..., :-1, :-1] + wp[..., 1:, :-1] + wp[..., :-1, 1:] + wp[..., 1:, 1:]


def _sn_kernel(conv) -> torch.Tensor:
    return conv.weight / torch.dot(conv.u, conv.matrix() @ conv.v)


def _down(conv, x):
    """A conv followed by a 2x2 average pool, as one stride-2 conv."""
    return F.conv2d(x, _fold(_sn_kernel(conv)) * 0.25, conv.bias, stride=2,
                    padding=conv.padding)


def _up(conv, x):
    """A conv of the 2x nearest-upsampled ``x``, as one stride-2 transposed conv."""
    w = _fold(_sn_kernel(conv))
    k = w.shape[-1] - 1
    return F.conv_transpose2d(x, w.flip(-2, -1).transpose(0, 1), conv.bias, stride=2,
                              padding=k - 1 - conv.padding)


def _folded_forwards():
    """{block class: forward} of the blocks whose convs the program folds."""
    from cudabench.reference import models as m

    def res_down(self, x):
        out = _down(self.conv_r2, m.lrelu(self.conv_r1(m.lrelu(x))))
        return self.conv_l1(m.pool2(x)) + out

    def res_up(self, x):
        out = _up(self.conv_r1, m.lrelu(self.in1(x)))
        out = self.conv_r2(m.lrelu(self.in2(out)))
        return m.up2(self.conv_l1(x)) + out

    def ada_up(self, x, style):
        out = m.ada_in(x, self.lin1_mean(style), self.lin1_std(style))
        out = _up(self.conv_r1, m.lrelu(out))
        out = m.ada_in(out, self.lin2_mean(style), self.lin2_std(style))
        out = self.conv_r2(m.lrelu(out))
        return m.up2(self.conv_l1(x)) + out

    return {m.ResBlockDown: res_down, m.ResBlockUp: res_up, m.AdaResBlockUp2: ada_up}


def count(game: dict) -> int:
    """FLOPs of one reference train step at ``game``'s shapes, on the meta device, the
    convs that the program folds counted in their folded form."""
    from torch.utils.flop_counter import FlopCounterMode

    from cudabench.reference.game import Game, train_step

    b, size, ch = game["batch_size"], game["img_size"], game["img_channels"]
    with torch.device("meta"):
        ref = Game(game, None, "meta")
        batch = {key: torch.empty((b, n, size, size, ch), dtype=torch.uint8)
                 for key, n in (("real_sample", game["n"]), ("leaked_sample", game["m"]),
                                ("si_sample", game["k"]))}
        z = torch.empty((b, game["n"], game["style_dim"]))
    swaps = _folded_forwards()
    plain = {cls: cls.forward for cls in swaps}
    counter = FlopCounterMode(display=False)
    try:
        for cls, forward in swaps.items():
            cls.forward = forward
        with counter:
            train_step(ref, batch, z)
    finally:
        for cls, forward in plain.items():
            cls.forward = forward
    return int(counter.get_total_flops())


def _key(game: dict) -> str:
    h = hashlib.sha256(json.dumps(game, sort_keys=True).encode())
    for path in sorted((HERE / "reference").glob("*.py")) + [Path(__file__)]:
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def model_flops(name: str, game: dict) -> int:
    """The count for configuration ``name``, from the cache when it is current."""
    path = CACHE / f"flops-{name}-{_key(game)}.json"
    if path.exists():
        return json.loads(path.read_text())["flops"]
    flops = count(game)
    CACHE.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps({"flops": flops}))
    tmp.replace(path)
    return flops
