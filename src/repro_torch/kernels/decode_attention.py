"""Single-token decode attention over the packed KV pool: the wrapper of
``csrc/decode_attention.cu`` (the port of ``decode_attention_pallas``).

``decode_attention(q, k, v, q_pos, kv_pos, window=0, chunk=0)`` takes
q (S, H, dh), k / v (S, C, KV, dh), q_pos (S,) and kv_pos (S, C) int32,
with dh 64, 96, 128 or 256 and 1..16 query heads per KV head, and returns
(S, H, dh) in q's dtype.  An entry is visible when ``kv_pos <= q_pos``
and ``q_pos - kv_pos < window`` (0: the pool length), or with ``chunk``
> 0 when ``kv_pos <= q_pos`` and ``kv_pos >= q_pos - q_pos % chunk``
(llama4's chunked attention over a ring as wide as the chunk); the
kernel turns the chunk into a per-slot window on the card, so the host
never reads q_pos.  A tensor on the CPU goes to the
plain version ``ref.decode_attention_ref``; a CUDA tensor launches the
kernel or raises -- there is no fallback.
A CUDA tensor on any ``cuda:N`` launches on that card, one card a
process: a launch on a second card raises, because the source's
one-time setup is process-wide (``_build.card``).

On the card the pool axis is split across blocks (flash-decoding):
``split_plan`` cuts C into chunks of whole tiles for about two blocks per
SM (each chunk at least 4 x rep positions, so that its f32 partials stay
small beside the K/V it reads), a split pass writes each chunk's
(m, l, acc) to an f32 scratch, and a combine pass merges them; both
launch from one C call.  With one chunk
the split pass writes the output and no combine runs.

``decode_attention.launches`` counts wrapper calls that reached the card
(one per layer per decode step, whatever the number of chunks); the
plain path never counts.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_ref

_DTYPES = (torch.bfloat16, torch.float32)
#: head dims the kernel is built for
HEAD_DIMS = (64, 96, 128, 256)
#: blocks the split pass aims at: two per SM of the H100's 132
TARGET_BLOCKS = 264
#: pool positions a chunk holds at least, per query head of a KV head: a
#: chunk's f32 partials, rep x (dh + 2) values written and read back once,
#: then stay under about half the bf16 K/V it reads (at the hybrid's pool,
#: rep 16 at dh 256, the fastest of 1 to 128 chunks on the H100)
MIN_CHUNK_PER_REP = 4


def tile_len(dh: int) -> int:
    """Pool positions per tile of the kernel (``kTile`` in the source):
    4096 // dh, and 32 at dh 96, whose 4096 // 96 = 42 would not split
    into the 16 rows a sweep of the block covers there."""
    return 32 if dh == 96 else 4096 // dh


def split_len_for(c: int, dh: int, want: int) -> tuple:
    """(n_split, split_len) for about ``want`` chunks of whole tiles: every
    chunk but the last holds split_len // tile_len(dh) whole tiles, the
    last holds at least one whole tile and the ragged tail (a pool shorter
    than one tile is one chunk)."""
    full = max(1, c // tile_len(dh))               # whole tiles (at least 1)
    per = -(-full // max(1, min(want, full)))      # tiles per chunk
    return -(-full // per), per * tile_len(dh)


def split_plan(s_slots: int, n_kv: int, c: int, dh: int, rep: int) -> tuple:
    """(n_split, split_len) the kernel runs with: the chunk count that
    gives at least ``TARGET_BLOCKS`` blocks of (chunk, KV head, slot),
    rounded up to a power of two and capped by the pool's whole tiles and
    by chunks of ``MIN_CHUNK_PER_REP * rep`` positions; 1 when the S x KV
    blocks already fill the card."""
    want = -(-TARGET_BLOCKS // (s_slots * n_kv))
    min_tiles = -(-MIN_CHUNK_PER_REP * rep // tile_len(dh))
    most = max(1, max(1, c // tile_len(dh)) // min_tiles)
    return split_len_for(c, dh, min(1 << (want - 1).bit_length(), most))


def split_bounds(c: int, n_split: int, split_len: int) -> list:
    """The chunk boundaries [0, split_len, ..., C] the kernel uses."""
    return [i * split_len for i in range(n_split)] + [c]


def _check(q, k, v, q_pos, kv_pos, window: int = 0, chunk: int = 0) -> None:
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode_attention: want q (S, H, dh) and k, v "
                         f"(S, C, KV, dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    s_slots, h, dh = q.shape
    c, n_kv = k.shape[1], k.shape[2]
    if k.shape[0] != s_slots or k.shape[3] != dh or h % n_kv:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"match the pool {tuple(k.shape)}")
    if tuple(q_pos.shape) != (s_slots,) or tuple(kv_pos.shape) != (s_slots, c):
        raise ValueError(f"decode_attention: want q_pos ({s_slots},) and "
                         f"kv_pos ({s_slots}, {c}); got "
                         f"{tuple(q_pos.shape)}, {tuple(kv_pos.shape)}")
    if dh not in HEAD_DIMS or not 1 <= h // n_kv <= 16:
        raise ValueError(f"decode_attention kernel takes dh in {HEAD_DIMS} "
                         f"and 1..16 query heads per KV head; got dh {dh}, "
                         f"rep {h // n_kv}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: q, k, v must share one dtype of "
                        f"{_DTYPES}; got {q.dtype}, {k.dtype}, {v.dtype}")
    if q_pos.dtype != torch.int32 or kv_pos.dtype != torch.int32:
        raise TypeError("decode_attention: q_pos and kv_pos must be int32")
    if window < 0 or chunk < 0 or (window and chunk):
        raise ValueError(f"decode_attention: window {window} and chunk "
                         f"{chunk} must be >= 0 and not both set")
    for name, t in (("q", q), ("k", k), ("v", v), ("q_pos", q_pos),
                    ("kv_pos", kv_pos)):
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} is on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be 16-byte "
                             f"aligned (the kernel loads it 16 bytes at a "
                             f"time)")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                     window: int = 0, chunk: int = 0) -> torch.Tensor:
    """Masked single-token attention with scores scaled by dh^-0.5; see
    the module docstring.  ``window`` 0 means un-windowed (masked as
    window = C); ``chunk`` 0 means no chunked rule."""
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, q_pos, kv_pos, window=window,
                                    chunk=chunk)
    card = _build.card(q, "decode_attention")
    _check(q, k, v, q_pos, kv_pos, window, chunk)
    s_slots, h, dh = q.shape
    c, n_kv = k.shape[1], k.shape[2]
    rep = h // n_kv
    n_split, split_len = split_plan(s_slots, n_kv, c, dh, rep)
    out = torch.empty_like(q)
    part = None                    # f32 (m, l, acc) of every chunk
    if n_split > 1:
        part = torch.empty(s_slots * n_kv * n_split * rep * (dh + 2),
                           dtype=torch.float32, device=q.device)
    lib = _build.load("decode_attention")
    with card:
        err = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
            kv_pos.data_ptr(), out.data_ptr(),
            None if part is None else part.data_ptr(), s_slots, c, n_kv,
            rep, dh, window or c, chunk, float(dh ** -0.5),
            int(q.dtype == torch.bfloat16), n_split, split_len,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_launch("decode_attention", err)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0

__all__ = ["decode_attention", "decode_attention_ref", "split_plan",
           "split_len_for", "split_bounds", "tile_len", "TARGET_BLOCKS",
           "MIN_CHUNK_PER_REP", "HEAD_DIMS"]
