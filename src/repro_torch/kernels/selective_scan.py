"""The diagonal selective scan: the wrapper of ``csrc/selective_scan.cu``
(the port of ``selective_scan_pallas``).

``selective_scan(da, dbx, h0)`` takes da, dbx (B, S, C) in bf16 or f32 and
h0 (B, C) and returns ``(h_all (B, S, C), h_last (B, C))`` in float32,
with h_t = da_t * h_{t-1} + dbx_t from h_{-1} = h0.  Any S >= 1 and C:
nothing is padded.  There is no gradient: the Pallas kernel has none and
serving needs none, so on the card the wrapper raises when an input
requires one (a training path must not drop it quietly).

A tensor on the CPU goes to the plain version ``ref.selective_scan_ref``;
a CUDA tensor launches the kernel or raises.
A CUDA tensor on any ``cuda:N`` launches on that card, one card a
process: a launch on a second card raises, because the source's
one-time setup is process-wide (``_build.card``).

On the card ``scan_plan`` picks one of two designs (the source's note
says why): one pass over S, 4 adjacent columns a thread, when the B x C
columns alone fill the card (Falcon-Mamba's prefill), C is a multiple of
4 and every pointer is 16-byte aligned; else the chained design (the
RG-LRU's C 4,096, and any C or alignment): blocks of 32 channels x 8
sub-chunks of 16 steps, each sub-chunk's pair (prod da, end state from 0)
folded in order from the previous chunk's carry-out, which it waits for,
then each sub-chunk rescanned from its carry-in.  The chained design
takes a zeroed int64 scratch of links and a ticket (``link_words``).
The launch gets the plan -- tile, chunk and ``fold_steps`` -- and
refuses one that names neither of the kernel's designs, so the constants
here and the source's cannot drift apart.
``ref.selective_scan_chunked_ref`` at ``fold_steps`` is the plain twin of
either design's arithmetic, bit for bit.

``selective_scan.launches`` counts wrapper calls that reached the card
(one per layer per prefill); the plain path never counts.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import selective_scan_ref

_DTYPES = (torch.bfloat16, torch.float32)
#: one pass: threads of a block, and the adjacent columns a thread takes
#: (``kPassThreads``, ``kPassCh`` in the source)
PASS_THREADS, PASS_COLUMNS = 256, 4
#: one pass over S when B x ceil(C / PASS_THREADS) reaches this: two blocks
#: a SM of the H100's 132 at one column a thread
ONE_PASS_BLOCKS = 264
#: chained: channels of a block (one a lane), sub-chunks of its chunk (one
#: a warp) and steps of a sub-chunk (``kLanes``, ``kWarps``, ``kSub`` in
#: the source): chunks of 128 steps
LANES, WARPS, SUB = 32, 8, 16


def runs_chained(b: int, c: int, aligned: bool = True) -> bool:
    """Whether the kernel runs the chained design.  It runs one pass only
    when the B x C columns alone fill the card, C is a multiple of
    PASS_COLUMNS and every pointer is 16-byte aligned (``aligned``)."""
    return not (aligned and c % PASS_COLUMNS == 0
                and b * -(-c // PASS_THREADS) >= ONE_PASS_BLOCKS)


def design_plan(chained: bool, b: int, s: int, c: int) -> tuple:
    """(tile, chunk, blocks) of one design at da (b, s, c): blocks of
    ``tile`` channels, each over ``chunk`` steps (s for one pass), and the
    block count b x ceil(c / tile) x ceil(s / chunk)."""
    tile, chunk = (LANES, WARPS * SUB) if chained else (
        PASS_THREADS * PASS_COLUMNS, s)
    return tile, chunk, b * -(-c // tile) * -(-s // chunk)


def scan_plan(b: int, s: int, c: int, aligned: bool = True) -> tuple:
    """(tile, chunk, blocks) of the design the kernel runs at da (b, s, c)
    (``aligned``: every pointer 16-byte aligned)."""
    return design_plan(runs_chained(b, c, aligned), b, s, c)


def fold_steps(chained: bool, s: int) -> int:
    """The steps each of a design's pairs covers -- the ``chunk`` of
    ``ref.selective_scan_chunked_ref`` that computes its bits (s for one
    pass: the sequential version)."""
    return SUB if chained else s


def link_words(chained: bool, b: int, s: int, c: int) -> int:
    """64-bit words of the chained design's zeroed scratch: a link of
    every chunk but the last for each column, then the ticket (0 for one
    pass)."""
    return -(-s // (WARPS * SUB)) * b * c if chained else 0


def _check(da: torch.Tensor, dbx: torch.Tensor, h0: torch.Tensor) -> None:
    if da.dim() != 3 or dbx.shape != da.shape or min(da.shape) < 1:
        raise ValueError(f"selective_scan: want da, dbx (B, S, C) of one "
                         f"shape; got {tuple(da.shape)}, {tuple(dbx.shape)}")
    if h0.shape != (da.shape[0], da.shape[2]):
        raise ValueError(f"selective_scan: want h0 (B, C) = "
                         f"{(da.shape[0], da.shape[2])}; got "
                         f"{tuple(h0.shape)}")
    if not (da.device == dbx.device == h0.device):
        raise ValueError(f"selective_scan: inputs on {da.device}, "
                         f"{dbx.device}, {h0.device}")


def selective_scan(da: torch.Tensor, dbx: torch.Tensor,
                   h0: torch.Tensor) -> tuple:
    """The recurrence over S for every (b, c); see the module docstring."""
    _check(da, dbx, h0)
    if da.device.type == "cpu":
        return selective_scan_ref(da, dbx, h0)
    card = _build.card(da, "selective_scan")
    if da.dtype not in _DTYPES or dbx.dtype != da.dtype:
        raise TypeError(f"selective_scan: da and dbx must share one of "
                        f"{_DTYPES}; got {da.dtype}, {dbx.dtype}")
    if not (da.is_contiguous() and dbx.is_contiguous()):
        raise ValueError("selective_scan: da and dbx must be contiguous")
    if da.requires_grad or dbx.requires_grad or h0.requires_grad:
        raise RuntimeError("selective_scan: the kernel has no gradient; an "
                           "input requires one")
    b, s, c = da.shape
    h0 = h0.float().contiguous()
    # the outputs are fresh allocations, 16-byte aligned
    chained = runs_chained(b, c, all(t.data_ptr() % 16 == 0
                                     for t in (da, dbx, h0)))
    tile, chunk, _ = design_plan(chained, b, s, c)
    h_all = torch.empty((b, s, c), dtype=torch.float32, device=da.device)
    h_last = torch.empty((b, c), dtype=torch.float32, device=da.device)
    n_links = link_words(chained, b, s, c)
    links = (torch.zeros(n_links, dtype=torch.int64, device=da.device)
             if n_links else None)
    lib = _build.load("selective_scan")
    with card:
        err = lib.selective_scan_launch(
            da.data_ptr(), dbx.data_ptr(), h0.data_ptr(), h_all.data_ptr(),
            h_last.data_ptr(), None if links is None else links.data_ptr(),
            n_links, b, s, c, tile, chunk, fold_steps(chained, s),
            int(da.dtype == torch.bfloat16),
            torch.cuda.current_stream(da.device).cuda_stream)
    _build.check_launch("selective_scan", err)
    selective_scan.launches += 1
    return h_all, h_last


selective_scan.launches = 0

__all__ = ["selective_scan", "selective_scan_ref", "scan_plan", "design_plan",
           "runs_chained", "fold_steps", "link_words", "PASS_THREADS",
           "PASS_COLUMNS", "ONE_PASS_BLOCKS", "LANES", "WARPS", "SUB"]
