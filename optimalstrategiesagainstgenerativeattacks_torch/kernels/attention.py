"""K2: SAGAN self-attention core, a CUDA C++ kernel for Hopper (sm_90a).

Replaces the Pallas TPU kernel ``_attn_kernel`` of
``optimalstrategiesagainstgenerativeattacks_tpu/ops/pallas/attention_pallas.py``
at commit 79a0a33 (launched by ``_run_attn`` under ``self_attention_pallas``).
The kernel source, with the note on what bounds it and how its design
answers, is ``kernels/csrc/attention.cu``: bf16 runs on tensor cores
(``mma.sync``), f32 on a SIMT kernel.

    core(f, g, h)[b, j] = sum_i softmax_i(f[b] g[b]^T)[i, j] h[b, i]

with f, g [B, N, CQ] and h [B, N, C]; the softmax runs over the SOURCE axis
i in f32, P is rounded to h's dtype before the second product (as the JAX
reference's ``nn/blocks.py:SelfAttention`` rounds it; nothing changes in
f32), and the output takes h's dtype.  In standard-attention terms it is
Q = g, K = f, V = h at scale 1.

What bounds it on the card is memory: ``attention_core_bytes`` counts the
bytes it must move, ``attention_core_flops`` its multiply-adds.

The backward is ``attention_core_bwd``: written out in torch ops, as the
Pallas kernel's custom VJP recomputed through jnp rather than a kernel.
"""

from __future__ import annotations

import ctypes

import torch

from optimalstrategiesagainstgenerativeattacks_torch.kernels.build import (
    LaunchCounter,
    load_cuda_library,
)
from optimalstrategiesagainstgenerativeattacks_torch.ops.precision import widen

FWD_LAUNCHES = LaunchCounter("attention_core_fwd")

MAX_TOKENS = 256
MAX_SMEM_BYTES = 232448  # per-block dynamic shared memory on sm_90
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def attention_core_bytes(b: int, n: int, c: int, cq: int, dtype: torch.dtype) -> int:
    """Bytes the core must move: f, g and h read once, the output written once."""
    return b * n * (2 * cq + 2 * c) * dtype.itemsize


def attention_core_flops(b: int, n: int, c: int, cq: int) -> int:
    """Flops of the two products, S = f g^T and P^T h (the softmax not counted)."""
    return 2 * b * n * n * (cq + c)


def _lib():
    lib = load_cuda_library("attention")
    if not getattr(lib, "_osga_typed", False):
        lib.osga_attention_core_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.osga_attention_core_fwd.restype = ctypes.c_int
        lib.osga_attention_core_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.osga_attention_core_smem_bytes.restype = ctypes.c_longlong
        lib.osga_error_string.argtypes = [ctypes.c_int]
        lib.osga_error_string.restype = ctypes.c_char_p
        lib._osga_typed = True
    return lib


def attention_core_cuda(f, g, h):
    """Launch the kernel.  f, g [B, N, CQ], h [B, N, C], contiguous, one dtype."""
    for name, t in (("f", f), ("g", g), ("h", h)):
        if not t.is_cuda:
            raise ValueError(f"attention_core: {name} is not a CUDA tensor")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"attention_core: dtype {t.dtype} not supported")
        if not t.is_contiguous():
            raise ValueError(f"attention_core: {name} must be contiguous")
    if not (f.dtype == g.dtype == h.dtype):
        raise TypeError("attention_core: f, g and h must share one dtype")
    b, n, cq = f.shape
    if g.shape != f.shape or h.shape[:2] != (b, n):
        raise ValueError(f"attention_core: shapes {f.shape}, {g.shape}, {h.shape}")
    if n > MAX_TOKENS:
        raise ValueError(f"attention_core: N={n} > {MAX_TOKENS} tokens")
    c = h.shape[2]
    lib = _lib()
    if lib.osga_attention_core_smem_bytes(n, cq, c, _DTYPE_CODES[h.dtype]) > MAX_SMEM_BYTES:
        raise ValueError(f"attention_core: N={n}, CQ={cq}, C={c} exceed the shared memory")
    out = torch.empty_like(h)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream(h.device).cuda_stream
        err = lib.osga_attention_core_fwd(
            f.data_ptr(), g.data_ptr(), h.data_ptr(), out.data_ptr(),
            b, n, cq, c, _DTYPE_CODES[h.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(
            f"attention_core kernel launch failed: {lib.osga_error_string(err).decode()}"
        )
    FWD_LAUNCHES.add()
    return out


def attention_core_ref(f, g, h):
    """Plain PyTorch version of the kernel: f32 products and softmax, P rounded
    to h's dtype before the second product, output in h's dtype."""
    s = torch.bmm(widen(f), widen(g).transpose(1, 2))  # [B, i, j]
    p = widen(torch.softmax(s, dim=1).to(h.dtype))
    return torch.bmm(p.transpose(1, 2), widen(h)).to(h.dtype)


def attention_core_bwd(f, g, h, dout):
    """Backward of the core in torch ops (recomputes P; not a kernel).

    P = softmax_i(f g^T);  dh = P~ dout;  dP[i, j] = h_i . dout_j, rounded;
    dS = P * (dP - sum_i P * dP);  df = dS g;  dg = dS^T f.

    Two roundings to h's dtype follow the JAX reference's vjp: P~ is P
    rounded, the P of the forward's second product, and dP is rounded, as
    the cotangent of its ``attn.astype(h.dtype)``.  In f32 neither changes
    anything.  Every op is differentiable, so a double backward (the R1
    penalty's) runs through it.
    """
    ff, gf, hf, df_out = widen(f), widen(g), widen(h), widen(dout)
    p = torch.softmax(torch.bmm(ff, gf.transpose(1, 2)), dim=1)
    dh = torch.bmm(widen(p.to(h.dtype)), df_out)
    dp = widen(torch.bmm(hf, df_out.transpose(1, 2)).to(h.dtype))
    ds = p * (dp - (p * dp).sum(dim=1, keepdim=True))
    df = torch.bmm(ds, gf)
    dg = torch.bmm(ds.transpose(1, 2), ff)
    return df.to(f.dtype), dg.to(g.dtype), dh.to(h.dtype)


def _fwd(f, g, h):
    if h.is_cuda:
        return attention_core_cuda(f, g, h)
    if h.device.type == "cpu":
        return attention_core_ref(f, g, h)
    raise ValueError(f"attention_core: no kernel for device {h.device}")


class AttentionCoreFunction(torch.autograd.Function):
    """The attention core with the kernel as forward."""

    @staticmethod
    def forward(ctx, f, g, h):
        ctx.save_for_backward(f, g, h)
        return _fwd(f, g, h)

    @staticmethod
    def backward(ctx, dout):
        return attention_core_bwd(*ctx.saved_tensors, dout)


def attention_core(f, g, h):
    """[B, N, CQ], [B, N, CQ], [B, N, C] -> [B, N, C]; softmax over source tokens."""
    return AttentionCoreFunction.apply(f.contiguous(), g.contiguous(), h.contiguous())
