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
CUDA tensor launches the kernel design ``mla_plan`` names or raises --
there is no fallback from one design to another:

- bf16 with H 64 or 128 (DeepSeek-V2's 128): the wgmma design, built for
  Hopper (the source's note says how).  The grid is G shares x H / 64
  CTAs, fixed by (S, H, C); each CTA reads ``lens`` on the device and
  takes its share of one slot's visible tiles, the slots cut so that no
  share holds more tiles than it must nor fewer than ``WG_LEAST`` where
  it can (``share_plan`` is that arithmetic in Python), and a combine
  pass merges the f32 pieces of slots that more than one share walked
  (none is launched at G == S, every slot one share).
- bf16 with H 16..48 (or 80..112): the mma.sync design, whose pool
  axis is split into chunks for about two blocks per SM (``split_plan``).
- f32: the FMA kernel over the same chunks, which the oracles use.

Both passes launch from one C call and the host never reads ``lens``, so
a decode step that calls this can be captured in a CUDA graph.
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
#: whole tiles a chunk of the mma / fma designs holds at least: it caps
#: the chunk count of short pools.  It does not keep the f32 partials
#: below the rows: each (chunk, head group, slot) block that sees a row
#: writes 16 heads x (512 + 2) values, read back by the combine, and at
#: DeepSeek-V2's pool (H 128, 8 chunks of 544; 33 of the 64 (slot, chunk)
#: pairs see a row) that is 8.7 MB written and 8.7 MB read against ~18.9
#: MB of visible rows (16.8 MB written before empty chunks stopped
#: writing their acc)
MIN_CHUNK_TILES = 8
#: the wgmma design: query heads a CTA (wgmma's M) and pool positions a
#: tile (``WHEADS``, ``WBN`` in the source)
WG_HEADS, WG_TILE = 64, 64
#: CTAs the wgmma design's split pass launches at most: one a SM of the
#: H100's 132 (a CTA holds 226 KB of shared memory)
WG_CTAS = 132
#: the least tiles a share of the wgmma design takes where a slot has
#: them (its cap B is at least this).  A share of a split slot writes a
#: piece of 64 heads x 514 f32 (132 KB) that the combine reads back,
#: more than the 74 KB of a tile, so shares of 1-2 tiles cost more in
#: pieces than they gain in SMs (scripts/mla_plan_sweep.py, PERF.md: one
#: slot at C and seven at 0 take 0.0207 ms at 3, 0.0242 at 1 or 2, 0.0212
#: at 4; DeepSeek-V2's pool is flat from 1 to 6, 0.0284-0.0288)
WG_LEAST = 3
#: the designs ``mla_decode_launch`` takes, by name (its ``Design``)
DESIGNS = {"fma": 0, "mma": 1, "wgmma": 2}


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


def share_budget(s_slots: int, h: int, c: int, least: int) -> int:
    """G, the wgmma design's share budget: as many shares as fill
    ``WG_CTAS`` CTAs of 64 heads, but no more than the slots could use at
    ``least`` tiles a share were every row visible, and one a slot at
    least (a share never crosses a slot).  Slots are cut only where a
    full slot holds at least 2 S tiles; else G = S, every slot one share,
    and the combine pass is not launched.  Its H x S (head, slot) items
    cost more as S grows, and cutting pays only where the longest slot's
    chain of tiles is long (scripts/mla_plan_sweep.py, PERF.md: at S 16
    over C 2,048, 32 tiles, G 66 takes 0.0335 ms against 0.0637 at G =
    S; over C 512, 8 tiles, G = S is best at 0.0232 against 0.0236; at S
    32 over C 1,024 and S 64 over C 128, G = S wins too)."""
    tiles = -(-c // WG_TILE)                       # a full slot's tiles
    if tiles < 2 * s_slots:
        return s_slots
    return max(s_slots, min(WG_CTAS // (h // WG_HEADS),
                            s_slots * -(-tiles // least)))


def mla_plan(dtype: torch.dtype, s_slots: int, h: int, c: int) -> tuple:
    """(design, n_split, split_len) of a call at q_c (s_slots, h, 512) in
    ``dtype`` over a pool of c positions.  bf16 at H 64 or 128 takes the
    wgmma design: n_split is its share budget (``share_budget``) and
    split_len the least tiles a share takes (``WG_LEAST``); other bf16
    head counts the mma design and f32 the FMA kernel, both over
    ``split_plan``'s chunks."""
    if dtype == torch.bfloat16 and h in (WG_HEADS, 2 * WG_HEADS):
        return "wgmma", share_budget(s_slots, h, c, WG_LEAST), WG_LEAST
    return ("mma" if dtype == torch.bfloat16 else "fma"), \
        *split_plan(s_slots, h, c)


def _visible_tiles(lens, c: int) -> list:
    """Tiles of ``WG_TILE`` that each slot's visible rows (c' <= lens, at
    most c) take, at least one (the source's ``slot_tiles``)."""
    return [max(1, -(-(0 if x < 0 else min(x + 1, c)) // WG_TILE))
            for x in lens]


def share_cap(tiles, shares: int, least: int = 1) -> int:
    """The most tiles a share of the wgmma design holds: the least cap B
    of at least ``least`` for which cutting each slot's ``tiles`` into
    ceil(n / B) shares needs at most ``shares`` (>= the slots) in all
    (the source's ``share_cap``: a binary search between max(least,
    ceil(T / G)) and ceil(T / (G - S)), T the tiles of all slots, or max n
    when G == S)."""
    t_all, s_slots = sum(tiles), len(tiles)
    lo = max(least, -(-t_all // shares))
    hi = max(lo, min(max(tiles), -(-t_all // (shares - s_slots)))
             if shares > s_slots else max(tiles))
    while lo < hi:
        mid = (lo + hi) // 2
        if sum(-(-n // mid) for n in tiles) <= shares:
            hi = mid
        else:
            lo = mid + 1
    return lo


def share_plan(lens, c: int, shares: int, least: int = 1) -> list:
    """The wgmma design's work split in Python, integer for integer as
    the source computes it from ``lens`` on the device (``share_cap``
    with ``least``, ``find_share``).  A share never crosses a slot: slot
    s, n visible tiles of ``WG_TILE``, is cut into k = ceil(n / B)
    shares, share j taking tiles [j n / k, (j + 1) n / k); shares are
    numbered slot after slot.
    Returns [(share, slot, first tile, end tile, piece)] in share order;
    piece is -1 where a slot is one share and writes the output itself,
    else the slot's pieces are numbered slot after slot (at most
    ``shares`` in all).  Needs ``shares`` >= the slots."""
    tiles = _visible_tiles(lens, c)
    if shares < len(tiles):
        raise ValueError(f"share_plan: {shares} shares for {len(tiles)} "
                         f"slots (a share never crosses a slot)")
    cap = share_cap(tiles, shares, least)
    segs, g, base = [], 0, 0
    for s, n in enumerate(tiles):
        k = -(-n // cap)
        for j in range(k):
            segs.append((g, s, j * n // k, (j + 1) * n // k,
                         base + j if k > 1 else -1))
            g += 1
        base += k if k > 1 else 0
    return segs


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
    plan = mla_plan(q_c.dtype, q_c.shape[0], q_c.shape[1], c_kv.shape[1])
    out = launch_design(q_c, q_rope, c_kv, k_rope, lens, scale, *plan)
    mla_decode.launches += 1
    return out


def launch_design(q_c: torch.Tensor, q_rope: torch.Tensor,
                  c_kv: torch.Tensor, k_rope: torch.Tensor,
                  lens: torch.Tensor, scale: float, design: str,
                  n_split: int, split_len: int) -> torch.Tensor:
    """One launch of ``design`` (a key of ``DESIGNS``) at the plan
    (n_split, split_len) on checked CUDA inputs, not counted: the body of
    ``mla_decode``, and how a check or the plan sweep times a design or a
    plan that ``mla_plan`` does not pick.  For the wgmma design n_split is
    the share budget G and split_len the least tiles a share.  Raises
    when the launch refuses the design for this shape."""
    s_slots, h, kvr = q_c.shape
    out = torch.empty_like(q_c)
    # f32 scratch: (acc, then (m, l)) of every chunk, or of every piece
    pieces = ((n_split if n_split > s_slots else 0) if design == "wgmma"
              else s_slots * n_split if n_split > 1 else 0)
    part = None
    if pieces:
        part = torch.empty(pieces * h * (kvr + 2), dtype=torch.float32,
                           device=q_c.device)
    lib = _build.load("mla_decode")
    err = lib.mla_decode_launch(
        q_c.data_ptr(), q_rope.data_ptr(), c_kv.data_ptr(),
        k_rope.data_ptr(), lens.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), s_slots, c_kv.shape[1],
        h, kvr, k_rope.shape[2], float(scale), DESIGNS[design], n_split,
        split_len, torch.cuda.current_stream(q_c.device).cuda_stream)
    _build.check_launch("mla_decode", err)
    return out


mla_decode.launches = 0

__all__ = ["mla_decode", "mla_decode_ref", "mla_plan", "share_budget",
           "share_plan", "share_cap", "launch_design", "split_plan",
           "LATENT", "HEAD_GROUP", "TILE", "TARGET_BLOCKS",
           "MIN_CHUNK_TILES", "WG_HEADS", "WG_TILE", "WG_CTAS", "WG_LEAST",
           "DESIGNS"]
