#!/usr/bin/env python
"""How closely the bf16 attention kernel rounds P as its plain version does, on the GPU.

For each flagship site of the attention core and the ragged test shapes,
prints two measures against ``attention_core_ref`` (P rounded to bf16 after
the softmax is normalised, as the JAX reference rounds it), on the same
inputs: the largest difference over the largest reference entry, and the
share of bf16 outputs that are exactly equal.  Three cores are held
against it:

* ``kernel``: the tensor-core kernel as built (``ex2.approx`` exponentials);
* ``kernel exp2f``: the same source with ``exp2f`` in place of ``ex2.approx``,
  built beside it: what the approximate exponential costs in exact matches;
* ``unrounded``: the plain core with P left in f32, which a kernel that
  skipped the rounding of P would match instead.

    python scripts/torch_attention_agreement.py
"""

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from optimalstrategiesagainstgenerativeattacks_torch.kernels import attention as k2  # noqa: E402
from optimalstrategiesagainstgenerativeattacks_torch.kernels import build  # noqa: E402

SITES = [(1920, 64, 256, 32), (1280, 64, 256, 32), (128, 64, 256, 32), (640, 64, 128, 16),
         (640, 64, 256, 32), (640, 256, 128, 16), (2, 16, 8, 1), (2, 50, 20, 3)]
EX2_APPROX = 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));'


def exact_exp2_library() -> ctypes.CDLL:
    """attention.cu with exp2f for ex2.approx, built with the port's nvcc flags."""
    src = (build.CSRC_DIR / "attention.cu").read_text()
    if EX2_APPROX not in src:
        raise RuntimeError("attention.cu no longer holds the ex2.approx line this script swaps")
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / "attention_exp2f.cu", out_dir / "libattention_exp2f.so"
    cu.write_text(src.replace(EX2_APPROX, "y = exp2f(x);"))
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.osga_attention_core_fwd.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.osga_attention_core_fwd.restype = ctypes.c_int
    return lib


def run_library(lib, f, g, h):
    out = torch.empty_like(h)
    b, n, cq = f.shape
    err = lib.osga_attention_core_fwd(f.data_ptr(), g.data_ptr(), h.data_ptr(), out.data_ptr(),
                                      b, n, cq, h.shape[2], 1,
                                      torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"exp2f variant failed to launch: error {err}")
    return out


def unrounded(f, g, h):
    p = torch.softmax(torch.bmm(f.float(), g.float().transpose(1, 2)), dim=1)
    return torch.bmm(p.transpose(1, 2), h.float()).to(h.dtype)


def agreement(got, want):
    """(max |got - want| / max |want|, share of exactly equal entries)."""
    d = (got.float() - want.float()).abs()
    return (d.max() / want.float().abs().max()).item(), (d == 0).float().mean().item()


def main():
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    exact = exact_exp2_library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    print("site (B', N, C, CQ): core rel_err share_equal; ...  (against attention_core_ref)")
    for b, n, c, cq in SITES:
        f = (0.5 * torch.randn(b, n, cq, generator=gen, device="cuda")).to(torch.bfloat16)
        g = (0.5 * torch.randn(b, n, cq, generator=gen, device="cuda")).to(torch.bfloat16)
        h = torch.randn(b, n, c, generator=gen, device="cuda").to(torch.bfloat16)
        want = k2.attention_core_ref(f, g, h)
        cores = (("kernel", k2.attention_core_cuda(f, g, h)),
                 ("kernel exp2f", run_library(exact, f, g, h)),
                 ("unrounded", unrounded(f, g, h)))
        print(f"  ({b}, {n}, {c}, {cq}): " + "; ".join(
            "{} {:.3e} {:.5f}".format(name, *agreement(out, want)) for name, out in cores),
            flush=True)


if __name__ == "__main__":
    main()
