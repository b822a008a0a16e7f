"""Cosine Gram matrices: the wrapper of ``csrc/gram.cu`` (the port of
``cosine_gram_pallas``), with its gradient.

``cosine_gram(x)`` takes x (B, D), or a stack (K, B, D) of node batches,
in bf16 or f32 and returns the (B, B) / (K, B, B) cosine similarities in
float32, each row scaled by ``rsqrt(max(|x|^2, 1e-8))``.  It is a
``torch.autograd.Function``, because a node's anchor Gram sits inside its
CKA loss.  The Pallas kernel has no backward, so the gradient is the
analytic one of the normalised Gram in plain PyTorch: with n the clamped
row norms and z = x / n, dz = (dG + dG^T) z and
dx = dz / n - x <dz, x> / n^3 (no gradient through the clamp).

A tensor on the CPU goes to the plain version ``ref.cosine_gram_ref``; a
CUDA tensor launches the kernel or raises.  ``cosine_gram.launches``
counts kernel launches.
A CUDA tensor on any ``cuda:N`` launches on that card, one card a
process: a launch on a second card raises, because the source's
one-time setup is process-wide (``_build.card``).

The kernel computes 32 x 32 output tiles (the upper triangle of tile
pairs, each stored twice) with the D contraction split across the CTAs
of a thread-block cluster and the warps of each CTA; bf16 runs on the
tensor cores.  Its split of D is chosen here, in plain Python, by
``gram_plan``, so the CPU tests pin it.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import cosine_gram_ref

EPS = 1e-8
_DTYPES = (torch.bfloat16, torch.float32)

TILE = 32                         # kTile of csrc/gram.cu: rows of a tile side
CHUNK = 128                       # kChunk: columns of D a ring stage holds
WARPS = 4                         # kWarps: a warp takes CHUNK / WARPS columns
TARGET_BLOCKS = 132               # one block per SM of the H100
MAX_SPLITS = 8                    # kMaxSplits: a portable cluster


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def n_tile_pairs(b: int) -> int:
    """Output tiles the kernel computes for one node: pairs I <= J of the
    ceil(b / TILE) row tiles."""
    nt = _cdiv(b, TILE)
    return nt * (nt + 1) // 2


@functools.lru_cache(maxsize=None)
def gram_plan(k: int, b: int, d: int) -> Tuple[int, int]:
    """(n_split, d_split) of the kernel for x (k, b, d): the D
    contraction in n_split contiguous ranges of d_split columns (whole
    CHUNK-wide chunks; the last range ends at d), one CTA each, the
    ranges of one tile one thread-block cluster.  As few ranges as give
    the card TARGET_BLOCKS CTAs in all, at most MAX_SPLITS and at most
    one per chunk."""
    chunks = _cdiv(d, CHUNK)
    want = min(MAX_SPLITS, chunks,
               max(1, _cdiv(TARGET_BLOCKS, k * n_tile_pairs(b))))
    per = _cdiv(chunks, want)
    return _cdiv(chunks, per), per * CHUNK


def n_blocks(k: int, b: int, d: int) -> int:
    """CTAs of the kernel's grid under ``gram_plan``."""
    return k * n_tile_pairs(b) * gram_plan(k, b, d)[0]


def _check(x: torch.Tensor) -> None:
    if x.dim() not in (2, 3) or min(x.shape) < 1:
        raise ValueError(f"cosine_gram: want x (B, D) or (K, B, D); got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"cosine_gram: x must be one of {_DTYPES}; got "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("cosine_gram: x must be contiguous")


def _forward(x: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return cosine_gram_ref(x, EPS)
    card = _build.card(x, "cosine_gram")
    _check(x)
    x3 = x if x.dim() == 3 else x[None]
    k, b, d = x3.shape
    out = torch.empty((k, b, b), dtype=torch.float32, device=x.device)
    n_split, d_split = gram_plan(k, b, d)
    lib = _build.load("gram")
    with card:
        err = lib.gram_launch(
            x3.data_ptr(), out.data_ptr(), k, b, d, EPS,
            int(x.dtype == torch.bfloat16), n_split, d_split,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check_launch("gram", err)
    cosine_gram.launches += 1
    return out if x.dim() == 3 else out[0]


class _CosineGram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _forward(x)

    @staticmethod
    def backward(ctx, dg):
        (x,) = ctx.saved_tensors
        x32 = x.float()
        ssq = (x32 * x32).sum(-1, keepdim=True)
        n = torch.sqrt(ssq.clamp_min(EPS))
        dz = (dg + dg.transpose(-1, -2)) @ (x32 / n)
        radial = x32 * (dz * x32).sum(-1, keepdim=True) / n ** 3
        dx = dz / n - torch.where(ssq > EPS, radial, torch.zeros_like(radial))
        return dx.to(x.dtype)


def cosine_gram(x: torch.Tensor) -> torch.Tensor:
    """Cosine Gram of each (B, D) batch, differentiable; see the module
    docstring."""
    return _CosineGram.apply(x)


cosine_gram.launches = 0

__all__ = ["cosine_gram", "cosine_gram_ref", "gram_plan", "n_blocks",
           "n_tile_pairs"]
