"""The fused GeoLoRA linear: the wrapper of ``csrc/lora_matmul.cu`` (the
port of ``lora_matmul_pallas``), with its gradient.

``lora_matmul(x, w, a, b)`` computes y = x @ W + (x @ A) @ B for x (M, K),
W (K, N), A (K, r) and B (r, N) in one dtype (bf16 or f32); both products
accumulate in float32 and y comes back in x's dtype.  The kernel takes
ranks 1 to 64, the Pallas kernel's range, and raises above.  It is a
``torch.autograd.Function`` in which W and A are frozen (the federation
trains and ships only B):

- dx = dy @ W^T + (dy @ B^T) @ A^T launches the same kernel on
  (dy, W^T, B^T, A^T); the transposes are strided views, never copies;
- dB = (x @ A)^T @ dy, a rank-r product that the JAX package leaves to
  XLA, is ``torch.matmul`` on the f32 bottleneck x @ A that the forward
  kernel wrote beside y.

A node axis: with x (K, M, d_in) and B (K, r, N) the call computes, per
node k, x_k @ W + (x_k @ A) @ B_k in one launch (the node-stacked round:
W and A frozen and shared, each node its own B); y, the bottleneck and
dB gain the same leading K.  The kernel reads A and B at a node stride
each, 0 for a shared operand, so dx = dy_k @ W^T + (dy_k @ B_k^T) @ A^T
is again one launch, with the per-node B_k^T in A's slot.

A tensor on the CPU goes to the plain version ``ref.lora_matmul_ref``; a
CUDA tensor launches the kernel or raises.  ``lora_matmul.launches``
counts kernel launches, forward and dx alike.
A CUDA tensor on any ``cuda:N`` launches on that card, one card a
process: a launch on a second card raises, because the source's
one-time setup is process-wide (``_build.card``).

The bf16 kernel runs on the tensor cores.  Two choices of it are made
here, in plain Python, so the CPU tests pin them: ``tile_plan`` picks the
output tile and the split of the K loop from the shape, and
``layout_flags`` tells the kernel, from strides and addresses, which
orientation each of W and A has and which operands load in 16-byte
chunks.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import lora_matmul_ref

MAX_RANK = 64                     # kMaxRank of csrc/lora_matmul.cu
_DTYPES = (torch.bfloat16, torch.float32)

BM, BK = 64, 64                   # kBM, kBK of csrc/lora_matmul.cu
#: output tile widths the bf16 kernel is built for, widest first
TILE_NS = (64, 32)
TARGET_BLOCKS = 132               # one block per SM of the H100
MAX_SPLITS = 8                    # kMaxSplits: a portable cluster
# a K range shorter than this loses more to its prologue and the cluster's
# reduction than the extra blocks gain (A/B on the H100, PERF.md PR 15)
MIN_RANGE_STEPS = 4
# bits of the kernel's ``flags`` (kVecX .. kRowA of csrc/lora_matmul.cu)
VEC_X, VEC_W, VEC_A, ROW_W, ROW_A = 1, 2, 4, 8, 16


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def tile_plan(m: int, k: int, n: int, nodes: int = 1) -> Tuple[int, int]:
    """(bn, k_split) of the bf16 kernel for x (nodes, m, k) @ W (k, n) (the
    M tiles of every node count, a tile never spanning two nodes): the widest
    BM x bn tile of ``TILE_NS`` whose grid gives every SM a block once the
    K loop is cut into ranges of ``k_split`` (whole BK-wide steps, each
    range a block of the tile's cluster), with as few ranges as that
    needs, at most ``MAX_SPLITS`` and none shorter than ``MIN_RANGE_STEPS``
    steps.  Where no tile gets there (small shapes), the narrowest tile
    with as many ranges as allowed, one step or more each."""
    steps = _cdiv(k, BK)
    for bn in TILE_NS:
        tiles = nodes * _cdiv(m, BM) * _cdiv(n, bn)
        for want in range(1, min(steps, MAX_SPLITS) + 1):
            per = _cdiv(steps, want)
            if want > 1 and per < MIN_RANGE_STEPS:
                break
            if tiles * _cdiv(steps, per) >= TARGET_BLOCKS:
                return bn, per * BK
    return TILE_NS[-1], _cdiv(steps, min(steps, MAX_SPLITS)) * BK


def n_blocks(m: int, k: int, n: int, nodes: int = 1) -> int:
    """Blocks of the bf16 kernel's grid under ``tile_plan``."""
    bn, k_split = tile_plan(m, k, n, nodes)
    return nodes * _cdiv(m, BM) * _cdiv(n, bn) * _cdiv(k, k_split)


def _chunked(t: torch.Tensor, row_dim: int, extent: int) -> bool:
    """Whether t's rows along ``row_dim`` (the other axis contiguous, with
    ``extent`` elements) are whole 16-byte chunks at 16-byte addresses."""
    pitch = t.stride(row_dim)
    return (t.stride(1 - row_dim) == 1 and pitch % 8 == 0 and pitch >= extent
            and extent % 8 == 0 and t.data_ptr() % 16 == 0)


def layout_flags(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                 a_node_stride: int = 0) -> int:
    """The kernel's ``flags``: ROW_W / ROW_A when W's n axis / A's r axis is
    the contiguous one (the forward; dx's transposed views have the loop
    axis contiguous), VEC_* for each operand that cp.async can copy in
    16-byte chunks (the others load element by element).  An operand with
    neither axis contiguous takes the row orientation.  x (M, K) and A
    (K, r) are node 0's; with a node axis x's nodes follow at M K elements
    and A's at ``a_node_stride``, which must keep A's chunks at 16 bytes."""
    k, n, r = x.shape[1], w.shape[1], a.shape[1]
    flags = VEC_X if k % 8 == 0 and x.data_ptr() % 16 == 0 else 0
    for t, extent_n, row, vec in ((w, n, ROW_W, VEC_W), (a, r, ROW_A, VEC_A)):
        if t.stride(1) == 1 or t.stride(0) != 1:          # [k][n] tile
            flags |= row | (vec if _chunked(t, 0, extent_n) else 0)
        elif _chunked(t, 1, k):                           # [n][k] tile
            flags |= vec
    if a_node_stride % 8:
        flags &= ~VEC_A
    return flags


def _node_slice(t: torch.Tensor) -> torch.Tensor:
    """Node 0's matrix of a per-node (K, ., .) operand, else ``t``."""
    return t[0] if t.dim() == 3 else t


def _check(x, w, a, b) -> None:
    nodes = x.shape[0] if x.dim() == 3 else None
    if w.dim() != 2 or x.dim() not in (2, 3) or (nodes is None and (
            a.dim() != 2 or b.dim() != 2)) or (nodes is not None and (
            a.dim() not in (2, 3) or b.dim() not in (2, 3)
            or 3 not in (a.dim(), b.dim()))):
        raise ValueError("lora_matmul: want x (M, K), w (K, N), a (K, r), "
                         "b (r, N), or with a node axis x (nodes, M, K) and "
                         "a per-node a (nodes, K, r) or b (nodes, r, N)")
    for t in (a, b):
        if t.dim() == 3 and t.shape[0] != nodes:
            raise ValueError(f"lora_matmul: x has {nodes} nodes, an operand "
                             f"{t.shape[0]}")
    if nodes is not None and nodes < 1:
        raise ValueError("lora_matmul: no nodes")
    x, a, b = (_node_slice(t) for t in (x, a, b))
    k, n, r = x.shape[1], w.shape[1], a.shape[1]
    if w.shape[0] != k or a.shape[0] != k or tuple(b.shape) != (r, n) \
            or min(x.shape[0], k, n) < 1:
        raise ValueError(f"lora_matmul: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)} do not chain")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"lora_matmul kernel takes rank 1..{MAX_RANK}, the "
                         f"range of the Pallas kernel it ports "
                         f"(repro/kernels/lora_matmul.py); got {r}")
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
    card = _build.card(x, "lora_matmul")
    _check(x, w, a, b)
    nodes = x.shape[0] if x.dim() == 3 else 1
    sa_node, sb_node = (t.stride(0) if t.dim() == 3 else 0 for t in (a, b))
    x0, a0, b0 = (_node_slice(t) for t in (x, a, b))
    m, k = x0.shape
    n, r = w.shape[1], a0.shape[1]
    lead = x.shape[:-1]
    y = torch.empty((*lead, n), dtype=x.dtype, device=x.device)
    xa = (torch.empty((*lead, r), dtype=torch.float32, device=x.device)
          if want_xa else None)
    bf16 = x.dtype == torch.bfloat16
    flags, (bn, k_split) = ((layout_flags(x0, w, a0, sa_node),
                             tile_plan(m, k, n, nodes))
                            if bf16 else (0, (0, 0)))
    lib = _build.load("lora_matmul")
    with card:
        err = lib.lora_matmul_launch(
            x.data_ptr(), w.data_ptr(), a.data_ptr(), b.data_ptr(),
            y.data_ptr(), None if xa is None else xa.data_ptr(), m, k, n, r,
            *w.stride(), *a0.stride(), *b0.stride(), flags, bn, k_split,
            int(bf16), nodes, sa_node, sb_node,
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
            dx, _ = _apply(dy, w.t(), b.transpose(-1, -2),
                           a.transpose(-1, -2), want_xa=False)
        if ctx.needs_input_grad[3]:
            db = (xa.transpose(-1, -2) @ dy.float()).to(b.dtype)
        return dx, None, None, db


def lora_matmul(x: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """y = x @ W + (x @ A) @ B, differentiable in x and B; with x (K, M,
    d_in) and B (K, r, N) per node.  See the module docstring."""
    if w.requires_grad or a.requires_grad:
        raise ValueError("lora_matmul: W and lora_A are frozen; pass them "
                         "detached")
    if x.dim() == 3 and b.dim() != 3:
        raise ValueError("lora_matmul: a node axis takes x (K, M, d_in) and "
                         "b (K, r, N) per node")
    return _LoRAMatmul.apply(x, w, a, b)


lora_matmul.launches = 0

__all__ = ["lora_matmul", "lora_matmul_ref", "MAX_RANK", "tile_plan",
           "n_blocks", "layout_flags"]
