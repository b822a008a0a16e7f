"""Full-sequence (prefill and training) attention: the wrapper of
``csrc/flash_attention.cu`` (the port of ``flash_attention_pallas``), with
its gradient.

``flash_attention(q, k, v, causal=True, window=0, chunk=0)`` takes the
layout
``blockwise_attention`` uses -- q (B, T, H, dh), k (B, S, KV, dh), v (B,
S, KV, dv), query head h reading KV head h // (H // KV) -- and returns
(B, T, H, dv) in q's dtype.  (dh, dv) is one of ``HEAD_DIM_PAIRS``: dh
64, 96 (Phi-3-vision), 128 or 256 with dv == dh, or DeepSeek-V2's MLA
prefill, q.k heads of 192 (128 nope + 64 rope) and v heads of 128; any
other pair raises (K and V are never padded to a wider built case).  The mask is causal, aligned
bottom-right (``k <= q + (S - T)``); with ``window`` > 0 it is
``blockwise_attention``'s sliding kind, which also drops a key that lies
``window`` or more behind the query (``q + (S - T) - k < window``): the
dense family's sliding-window variant and the hybrid family's local
attention.  With ``chunk`` > 0 it is the chunked kind (llama4's local
attention, the MoE family's Llama-4-Scout): a key is visible when it is
causal and lies in the query's chunk of positions, ``k >= qa - qa %
chunk`` with ``qa = q + (S - T)``; ``window`` and ``chunk`` exclude each
other.  With ``causal=False`` it is the Pallas kernel's full mask: every
key 0..S-1 visible to every row, T != S allowed (the audio family's
encoder self-attention and its decoder's cross attention over the
encoder output); a window or a chunk with it raises.  Scores are scaled
by dh^-0.5.

It is a ``torch.autograd.Function``, for the federated round's local
steps.  The Pallas kernel has no backward, so the backward is plain
PyTorch by design: it recomputes the attention through
``ref.flash_attention_ref`` (with the same mask) under autograd and takes the exact gradient
of that (a hand-written backward kernel is queued in ROADMAP.md).

A tensor on the CPU goes to the plain version ``ref.flash_attention_ref``;
a CUDA tensor launches the kernel or raises.  On the card bf16 runs both
products on the tensor cores and f32 on the CUDA cores' FMAs (the source
note says why).  ``flash_attention.launches`` counts kernel launches
(forward only; the backward launches none).
A CUDA tensor on any ``cuda:N`` launches on that card, one card a
process: a launch on a second card raises, because the source's
one-time setup is process-wide (``_build.card``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

_DTYPES = (torch.bfloat16, torch.float32)
#: head dims the kernel is built for with dv == dh
HEAD_DIMS = (64, 96, 128, 256)
#: the (q.k, v) head-dim pairs the kernel is built for
HEAD_DIM_PAIRS = tuple((d, d) for d in HEAD_DIMS) + ((192, 128),)


def _check(q, k, v, window: int, chunk: int = 0,
           causal: bool = True) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: want q (B, T, H, dh), k (B, S, "
                         f"KV, dh) and v (B, S, KV, dv); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, dh = q.shape
    n_kv = k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh or h % n_kv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)}")
    if (dh, v.shape[3]) not in HEAD_DIM_PAIRS:
        raise ValueError(f"flash_attention kernel takes (dh, dv) in "
                         f"{HEAD_DIM_PAIRS}; got ({dh}, {v.shape[3]})")
    for name, n in (("window", window), ("chunk", chunk)):
        if not isinstance(n, int) or n < 0:
            raise ValueError(f"flash_attention: {name} must be an int >= 0 "
                             f"(0: none); got {n!r}")
    if window and chunk:
        raise ValueError(f"flash_attention: window {window} and chunk "
                         f"{chunk} exclude each other")
    if not causal and (window or chunk):
        raise ValueError(f"flash_attention: causal=False (the full mask) "
                         f"takes no window or chunk; got window {window}, "
                         f"chunk {chunk}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one dtype of "
                        f"{_DTYPES}; got {q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             f"and 16-byte aligned (the kernel loads it 16 "
                             f"bytes at a time)")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, window: int, chunk: int) -> torch.Tensor:
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   chunk=chunk)
    card = _build.card(q, "flash_attention")
    _check(q, k, v, window, chunk, causal)
    b, t, h, dh = q.shape
    s, n_kv, dv = k.shape[1], k.shape[2], v.shape[3]
    out = q.new_empty((b, t, h, dv))
    lib = _build.load("flash_attention")
    with card:
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t,
            s, h, n_kv, dh, dv, window, chunk, int(causal),
            float(dh ** -0.5), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("flash_attention", err)
    flash_attention.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk):
        ctx.save_for_backward(q, k, v)
        ctx.mask = dict(causal=causal, window=window, chunk=chunk)
        return _forward(q, k, v, causal, window, chunk)

    @staticmethod
    def backward(ctx, dout):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = flash_attention_ref(*leaves, **ctx.mask)
        return (*torch.autograd.grad(out, leaves, dout), None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    chunk: int = 0) -> torch.Tensor:
    """Causal (``window`` and ``chunk`` 0), sliding-window, chunked or,
    under ``causal=False``, full online-softmax attention,
    differentiable; see the module docstring."""
    return _FlashAttention.apply(q, k, v, bool(causal), window, chunk)


flash_attention.launches = 0

__all__ = ["flash_attention", "flash_attention_ref", "HEAD_DIMS",
           "HEAD_DIM_PAIRS"]
