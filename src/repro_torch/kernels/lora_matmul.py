"""The fused GeoLoRA linear: the wrapper of ``csrc/lora_matmul.cu`` (the
port of ``lora_matmul_pallas``), with its gradient.

``lora_matmul(x, w, a, b)`` computes y = x @ W + (x @ A) @ B for x (M, K),
W (K, N), A (K, r) and B (r, N) in one dtype (bf16 or f32); both products
accumulate in float32 and y comes back in x's dtype.  It is a
``torch.autograd.Function`` in which W and A are frozen (the federation
trains and ships only B):

- dx = dy @ W^T + (dy @ B^T) @ A^T launches the same kernel on
  (dy, W^T, B^T, A^T); the transposes are strided views, never copies;
- dB = (x @ A)^T @ dy, a rank-r product that the JAX package leaves to
  XLA, is ``torch.matmul`` on the f32 bottleneck x @ A that the forward
  kernel wrote beside y.

A tensor on the CPU goes to the plain version ``ref.lora_matmul_ref``; a
CUDA tensor launches the kernel or raises.  ``lora_matmul.launches``
counts kernel launches, forward and dx alike.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import lora_matmul_ref

MAX_RANK = 32                     # kMaxRank of csrc/lora_matmul.cu
_DTYPES = (torch.bfloat16, torch.float32)


def _check(x, w, a, b) -> None:
    if any(t.dim() != 2 for t in (x, w, a, b)):
        raise ValueError("lora_matmul: want x (M, K), w (K, N), a (K, r), "
                         "b (r, N)")
    k, n, r = x.shape[1], w.shape[1], a.shape[1]
    if w.shape[0] != k or a.shape[0] != k or tuple(b.shape) != (r, n) \
            or min(x.shape[0], k, n) < 1:
        raise ValueError(f"lora_matmul: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)} do not chain")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"lora_matmul kernel takes rank 1..{MAX_RANK}; "
                         f"got {r}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (w, a, b)):
        raise TypeError(f"lora_matmul: x, w, a, b must share one dtype of "
                        f"{_DTYPES}; got {x.dtype}, {w.dtype}, {a.dtype}, "
                        f"{b.dtype}")
    for name, t in (("w", w), ("a", a), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"lora_matmul: {name} is on {t.device}, x on "
                             f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("lora_matmul: x must be contiguous (w, a and b may "
                         "be strided)")


def _apply(x, w, a, b, want_xa: bool
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """y, and the f32 bottleneck x @ A when ``want_xa``."""
    if x.device.type == "cpu":
        return (lora_matmul_ref(x, w, a, b),
                x.float() @ a.float() if want_xa else None)
    if x.device.type != "cuda" or x.device.index not in (None, 0):
        raise ValueError(f"lora_matmul: no kernel for {x.device} (the "
                         f"kernels launch on cuda:0)")
    _check(x, w, a, b)
    m, k = x.shape
    n, r = w.shape[1], a.shape[1]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    xa = (torch.empty((m, r), dtype=torch.float32, device=x.device)
          if want_xa else None)
    lib = _build.load("lora_matmul")
    err = lib.lora_matmul_launch(
        x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(), y.data_ptr(),
        None if xa is None else xa.data_ptr(), m, k, n, r, *w.stride(),
        *a.stride(), *b.stride(), int(x.dtype == torch.bfloat16),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch("lora_matmul", err)
    lora_matmul.launches += 1
    return y, xa


class _LoRAMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, a, b):
        y, xa = _apply(x, w, a, b, want_xa=ctx.needs_input_grad[3])
        ctx.save_for_backward(w, a, b, xa)
        return y

    @staticmethod
    def backward(ctx, dy):
        w, a, b, xa = ctx.saved_tensors
        dy = dy.contiguous()
        dx = db = None
        if ctx.needs_input_grad[0]:
            dx, _ = _apply(dy, w.t(), b.t(), a.t(), want_xa=False)
        if ctx.needs_input_grad[3]:
            db = (xa.t() @ dy.float()).to(b.dtype)
        return dx, None, None, db


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """y = x @ W + (x @ A) @ B, differentiable in x and B; see the module
    docstring."""
    if w.requires_grad or a.requires_grad:
        raise ValueError("lora_matmul: W and lora_A are frozen; pass them "
                         "detached")
    return _LoRAMatmul.apply(x, w, a, b)


lora_matmul.launches = 0

__all__ = ["lora_matmul", "lora_matmul_ref", "MAX_RANK"]
