"""Absorbed MLA decode over the serving latent pool: the wrapper of
``csrc/mla_decode.cu``, DeepSeek-V2's decode attention.

``mla_decode(q_c, q_rope, c_kv, k_rope, lens, scale)`` takes q_c (S, H,
kvr) (q_nope with ``w_uk`` absorbed), q_rope (S, H, rd), the slot pool's
c_kv (S, C, kvr) and k_rope (S, C, rd) and lens (S,) int32, and returns
(S, H, kvr) in q's dtype: every head of slot s attends over the slot's
latent rows c <= lens[s] with scores ``(q_c . c_kv + q_rope . k_rope) *
scale`` and sums the rows ``c_kv`` themselves (``ref.mla_decode_ref``).
The kernel is built for kvr 512 and rd 64 (DeepSeek-V2's latent) and H a
multiple of 16 up to 128, in bf16 and f32; any other shape raises on the
card.  It replaces no Pallas kernel: the JAX package computes this
attention with the jnp einsums of ``mla_decode_slots``.

A tensor on the CPU goes to the plain version ``ref.mla_decode_ref``; a
CUDA tensor launches the kernel or raises -- there is no fallback.  The
pool axis is split into chunks for about two blocks per SM
(``split_plan``), whose f32 (m, l, acc) a combine pass merges; both
passes launch from one C call and the host never reads ``lens``, so a
decode step that calls this can be captured in a CUDA graph.
``mla_decode.launches`` counts wrapper calls that reached the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mla_decode_ref

_DTYPES = (torch.bfloat16, torch.float32)
#: the latent the kernel is built for: (kv_lora_rank, rope_head_dim)
LATENT = (512, 64)
#: query heads a block of the kernel takes
HEAD_GROUP = 16
#: pool positions per tile of the kernel (BK in the source)
TILE = 32
#: blocks the split pass aims at: two per SM of the H100's 132
TARGET_BLOCKS = 264
#: whole tiles a chunk holds at least: a chunk's f32 partials (16 heads x
#: (512 + 2) values a head group, written and read back) stay under the
#: bf16 latent rows the chunk reads once for all its head groups
MIN_CHUNK_TILES = 8


def split_plan(s_slots: int, h: int, c: int) -> tuple:
    """(n_split, split_len): the chunk count that gives at least
    ``TARGET_BLOCKS`` blocks of (chunk, head group, slot), rounded up to a
    power of two and capped by chunks of ``MIN_CHUNK_TILES`` whole tiles;
    every chunk but the last holds split_len positions (whole tiles), the
    last one the rest.  1 chunk when the pool is shorter than two such
    chunks or the slots' head groups fill the card."""
    want = -(-TARGET_BLOCKS // (s_slots * max(1, h // HEAD_GROUP)))
    full = max(1, c // TILE)                       # whole tiles (at least 1)
    most = max(1, full // MIN_CHUNK_TILES)
    n = min(1 << (want - 1).bit_length(), most)
    per = -(-full // n)                            # tiles a chunk
    return -(-full // per), per * TILE


def _check(q_c, q_rope, c_kv, k_rope, lens) -> None:
    if q_c.dim() != 3 or q_rope.dim() != 3 or c_kv.dim() != 3 \
            or k_rope.dim() != 3:
        raise ValueError(f"mla_decode: want q_c (S, H, kvr), q_rope (S, H, "
                         f"rd), c_kv (S, C, kvr), k_rope (S, C, rd); got "
                         f"{tuple(q_c.shape)}, {tuple(q_rope.shape)}, "
                         f"{tuple(c_kv.shape)}, {tuple(k_rope.shape)}")
    s_slots, h, kvr = q_c.shape
    c, rd = c_kv.shape[1], k_rope.shape[2]
    if (tuple(q_rope.shape[:2]) != (s_slots, h)
            or tuple(c_kv.shape) != (s_slots, c, kvr)
            or tuple(k_rope.shape) != (s_slots, c, rd)
            or tuple(lens.shape) != (s_slots,)):
        raise ValueError(f"mla_decode: shapes do not match: q_c "
                         f"{tuple(q_c.shape)}, q_rope {tuple(q_rope.shape)}, "
                         f"c_kv {tuple(c_kv.shape)}, k_rope "
                         f"{tuple(k_rope.shape)}, lens {tuple(lens.shape)}")
    if (kvr, q_rope.shape[2]) != LATENT or rd != LATENT[1] \
            or h % HEAD_GROUP or not HEAD_GROUP <= h <= 128:
        raise ValueError(f"mla_decode kernel takes kvr {LATENT[0]}, rd "
                         f"{LATENT[1]} and H a multiple of {HEAD_GROUP} up "
                         f"to 128; got kvr {kvr}, rd {rd}, H {h}")
    if q_c.dtype not in _DTYPES or any(t.dtype != q_c.dtype
                                       for t in (q_rope, c_kv, k_rope)):
        raise TypeError(f"mla_decode: q_c, q_rope, c_kv, k_rope must share "
                        f"one dtype of {_DTYPES}; got {q_c.dtype}, "
                        f"{q_rope.dtype}, {c_kv.dtype}, {k_rope.dtype}")
    if lens.dtype != torch.int32:
        raise TypeError("mla_decode: lens must be int32")
    for name, t in (("q_c", q_c), ("q_rope", q_rope), ("c_kv", c_kv),
                    ("k_rope", k_rope), ("lens", lens)):
        if t.device != q_c.device:
            raise ValueError(f"mla_decode: {name} is on {t.device}, q_c on "
                             f"{q_c.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"mla_decode: {name} must be contiguous and "
                             f"16-byte aligned (the kernel loads it 16 bytes "
                             f"at a time)")


def mla_decode(q_c: torch.Tensor, q_rope: torch.Tensor, c_kv: torch.Tensor,
               k_rope: torch.Tensor, lens: torch.Tensor,
               scale: float) -> torch.Tensor:
    """Masked absorbed-MLA attention of one query per slot over its latent
    rows ``c <= lens``; see the module docstring."""
    if q_c.device.type == "cpu":
        return mla_decode_ref(q_c, q_rope, c_kv, k_rope, lens, scale)
    if q_c.device.type != "cuda" or q_c.device.index not in (None, 0):
        raise ValueError(f"mla_decode: no kernel for {q_c.device} (the "
                         f"kernels launch on cuda:0)")
    _check(q_c, q_rope, c_kv, k_rope, lens)
    s_slots, h, kvr = q_c.shape
    c = c_kv.shape[1]
    n_split, split_len = split_plan(s_slots, h, c)
    out = torch.empty_like(q_c)
    part = None                    # f32 (acc, then (m, l)) of every chunk
    if n_split > 1:
        part = torch.empty(s_slots * h * n_split * (kvr + 2),
                           dtype=torch.float32, device=q_c.device)
    lib = _build.load("mla_decode")
    err = lib.mla_decode_launch(
        q_c.data_ptr(), q_rope.data_ptr(), c_kv.data_ptr(),
        k_rope.data_ptr(), lens.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), s_slots, c, h, kvr,
        k_rope.shape[2], float(scale), int(q_c.dtype == torch.bfloat16),
        n_split, split_len, torch.cuda.current_stream(q_c.device).cuda_stream)
    _build.check_launch("mla_decode", err)
    mla_decode.launches += 1
    return out


mla_decode.launches = 0

__all__ = ["mla_decode", "mla_decode_ref", "split_plan", "LATENT",
           "HEAD_GROUP", "TILE", "TARGET_BLOCKS", "MIN_CHUNK_TILES"]
