"""GQA and MLA attention: prefill and training through the flash kernel
(which carries a gradient), slot decode through the decode kernel (GQA)
or the absorbed-MLA decode kernel (MLA).

Ports ``make_gqa``, ``_qkv``, ``gqa_forward``, ``init_kv_cache``,
``gqa_decode`` and ``gqa_decode_slots`` from ``repro.models.attention``
for the ``causal`` kind, the ``sliding`` kind with its window (the dense
family's sliding-window variant and the hybrid family's local
attention) and the ``chunked`` kind with its chunk (llama4's local
attention: a key is seen when it is causal and lies in the query's
chunk of ``window`` positions); under the last two the decode cache is
a ring.  The ``full`` kind (the audio family's encoder)
runs the flash kernel's full mask.  Cross attention (the audio
decoder's, over the encoder output): ``gqa_forward(x_cross=)`` projects
K / V from ``x_cross`` and attends under the full mask without RoPE,
``precompute_cross_kv`` gives the cache's cross K / V, and
``gqa_cross_decode`` attends one query a slot over them through the
decode kernel, every entry visible by a constant position table
(``cross_positions``).

Also DeepSeek-V2's multi-head latent attention [arXiv:2405.04434]:
``make_mla``, ``_mla_q``, ``_mla_ckv``, ``mla_forward``,
``init_mla_cache``, ``mla_decode`` and ``mla_decode_slots``, with the
reference's trees and arithmetic.  The prefill up-projects K and V from
the latent ``c_kv`` with ``w_ukv`` (one ``torch.matmul`` over the whole
sequence, where the reference up-projects block by block inside its scan),
broadcasts the rope key over the heads into K's last ``rope_head_dim``
values and runs the causal flash kernel at q.k heads of nope + rope and
v heads of ``v_head_dim`` (192 and 128 at full size); the scores are
scaled by (nope + rope)^-0.5 as in the reference.  The decode keeps the
cache compressed -- per position one latent row of ``kv_lora_rank``
values and one rope key -- and absorbs ``w_uk`` into the query (``q_c``)
and ``w_uv`` into the output, so the ``mla_decode`` kernel attends over
the latent rows themselves.

``decode_step``'s single-position decodes, ``gqa_decode`` and
``mla_decode``, take the reference's cache with one scalar ``len`` for
the whole batch (an int32 tensor on the device, never read to the host)
and run the slot functions' arithmetic and kernels with ``lens`` that
scalar copied to every row.  Where the reference's two paths disagree,
each follows its own: ``mla_decode`` writes at ``len >= C`` over row C -
1 (the reference's ``dynamic_update_slice`` clamps its start), where
``mla_decode_slots`` drops the write (an out-of-bounds scatter).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels import mla_decode as mla_kernel
from repro_torch.models.common import (apply_rope, linear, make_linear,
                                       make_rms_norm, rms_norm)


#: a decode window no position difference reaches (int32's largest): the
#: causal decode's, the reference's ``kv_pos <= q_pos`` with no window
NO_WINDOW = 2 ** 31 - 1


def _mask_spec(kind: str, window: int) -> dict:
    """The flash kernel's mask for a kind and its ``window`` (the
    reference's one width argument): ``{"causal", "window", "chunk"}``,
    window and chunk 0 for causal and full (``causal`` False), ``window``
    (> 0) as the window for sliding or as the chunk for chunked.  Any
    other kind raises."""
    if kind in ("causal", "full"):
        return {"causal": kind == "causal", "window": 0, "chunk": 0}
    if kind == "sliding" and window > 0:
        return {"causal": True, "window": window, "chunk": 0}
    if kind == "chunked" and window > 0:
        return {"causal": True, "window": 0, "chunk": window}
    raise NotImplementedError(
        f"attention kind {kind!r} (window {window}): the port serves the "
        f"causal, full, sliding and chunked masks")


def make_gqa(gen: torch.Generator, cfg: ModelConfig, dtype, *, batch=(),
             device=None) -> dict:
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    d, dh = cfg.d_model, cfg.head_dim
    kw = dict(batch=batch, device=device)
    p = {
        "wq": make_linear(gen, d, h * dh, dtype, **kw),
        "wk": make_linear(gen, d, kvh * dh, dtype, **kw),
        "wv": make_linear(gen, d, kvh * dh, dtype, **kw),
        "wo": make_linear(gen, h * dh, d, dtype, **kw),
    }
    if cfg.qk_norm:
        p["q_norm"] = make_rms_norm(dh, dtype, **kw)
        p["k_norm"] = make_rms_norm(dh, dtype, **kw)
    return p


def _qkv(p: dict, x: torch.Tensor, x_kv: torch.Tensor, cfg: ModelConfig,
         h: int, kvh: int):
    b, t = x.shape[:2]
    s = x_kv.shape[1]
    q = linear(x, p["wq"]).reshape(b, t, h, cfg.head_dim)
    k = linear(x_kv, p["wk"]).reshape(b, s, kvh, cfg.head_dim)
    v = linear(x_kv, p["wv"]).reshape(b, s, kvh, cfg.head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"]["scale"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"]["scale"], cfg.norm_eps)
    return q, k, v


def gqa_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                kind: str = "causal", window: int = 0,
                positions: Optional[torch.Tensor] = None,
                x_cross: Optional[torch.Tensor] = None, rope: bool = True,
                return_kv: bool = False):
    """Full-sequence (prefill or training) attention.  x: (B, T, d_model),
    differentiable (the flash wrapper is an autograd Function).  The
    masks follow sequence order (the flash kernel masks by index), so
    ``positions`` only feeds RoPE and must run 0..T-1 as in prefill.
    With ``x_cross`` (B, S, d_model) K and V come from it and the mask
    is the full one whatever ``kind`` says, S != T allowed (cross
    attention); RoPE applies only when ``rope`` and no ``x_cross``, as in
    the reference."""
    mask = _mask_spec("full" if x_cross is not None else kind, window)
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    b, t = x.shape[:2]
    q, k, v = _qkv(p, x, x if x_cross is None else x_cross, cfg, h, kvh)
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32,
                                 device=x.device)[None].expand(b, t)
    if rope and cfg.rope_theta > 0 and x_cross is None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          **mask)
    y = linear(out.reshape(b, t, h * cfg.head_dim), p["wo"])
    if return_kv:
        return y, {"k": k, "v": v}          # k already rope'd (cache layout)
    return y


def gqa_decode_slots(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig,
                     *, kind: str = "causal",
                     window: int = 0) -> Tuple[torch.Tensor, dict]:
    """One-token decode with PER-SLOT positions (the serving cache pool).

    x: (S, 1, d_model); cache: ``k`` / ``v`` (S, C, KV, dh), ``pos``
    (S, C), ``lens`` (S,) int32.  Slot s writes its new K/V at ring index
    ``lens[s] % C`` (sliding, chunked) or ``min(lens[s], C - 1)`` of the
    linear buffer (causal) and attends at query position ``lens[s]``.
    The causal mask is the reference's, ``kv_pos <= q_pos`` with no
    window: a slot decoding past C (a vlm request, whose admission rule
    counts the text only) overwrites entry C - 1 and still sees entry 0,
    where the kernel's default window (C) would drop it.  The write
    goes IN PLACE into the cache tensors (the pool is updated where it
    lies instead of copied each step); the returned dict holds the same
    tensors and ``lens + 1``.
    """
    if kind == "full":
        raise NotImplementedError("gqa_decode_slots: the full mask decodes "
                                  "through gqa_cross_decode")
    mask = _mask_spec(kind, window)
    del mask["causal"]
    if kind == "causal":
        mask["window"] = NO_WINDOW
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    b = x.shape[0]
    cache_len = cache["k"].shape[1]
    lens = cache["lens"]                                  # (S,) int32
    positions = lens[:, None]                             # (S, 1)
    q, k, v = _qkv(p, x, x, cfg, h, kvh)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    slot = (lens % cache_len if kind != "causal" else
            lens.clamp(max=cache_len - 1)).long()
    rows = torch.arange(b, device=x.device)
    cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
    cache["pos"][rows, slot] = lens
    out = decode_attention(q[:, 0].contiguous(), cache["k"], cache["v"],
                           lens, cache["pos"], **mask)
    new_cache = {"k": cache["k"], "v": cache["v"], "pos": cache["pos"],
                 "lens": lens + 1}
    o = linear(out.reshape(b, 1, h * cfg.head_dim), p["wo"])
    return o, new_cache


#: the position of an empty cache entry: no query position reaches it, so
#: ``kv_pos <= q_pos`` masks it
EMPTY_POS = (2 ** 31 - 1) // 2


def init_kv_cache(batch: int, cache_len: int, n_kv: int, head_dim: int,
                  dtype, device=None) -> dict:
    """An empty single-sequence GQA cache, as the reference's: zero ``k`` /
    ``v`` (B, C, KV, dh), every ``pos`` (B, C) at ``EMPTY_POS`` and the
    scalar ``len`` 0 (a ring when the decode's kind has a window)."""
    shape = (batch, cache_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch, cache_len), EMPTY_POS,
                              dtype=torch.int32, device=device),
            "len": torch.zeros((), dtype=torch.int32, device=device)}


def _batch_lens(length: torch.Tensor, b: int) -> torch.Tensor:
    """A single-position cache's scalar ``len`` as the (B,) int32 ``lens``
    of the slot functions: a contiguous copy on the device (the kernels
    read ``lens`` as B packed int32, not a stride-0 view), no host read."""
    return length.to(torch.int32).expand(b).contiguous()


def gqa_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig, *,
               kind: str = "causal",
               window: int = 0) -> Tuple[torch.Tensor, dict]:
    """One-token decode at ONE position for the whole batch (the
    reference's single-sequence cache).  x: (B, 1, d_model); cache: ``k``
    / ``v`` (B, C, KV, dh), ``pos`` (B, C), ``len`` () int32 on the
    device.  ``gqa_decode_slots`` with every row at ``len``: the new K/V
    go to ring index ``len % C`` (sliding, chunked) or ``min(len, C -
    1)`` of the linear buffer (causal, the reference's clamp), IN PLACE;
    the causal mask is by position only, so past the buffer's end entry
    0 stays visible as in the reference.  Returns (out, the cache's
    tensors with ``len + 1``)."""
    lc = {n: cache[n] for n in ("k", "v", "pos")}
    o, _ = gqa_decode_slots(p, x, dict(lc, lens=_batch_lens(cache["len"],
                                                           x.shape[0])),
                            cfg, kind=kind, window=window)
    return o, dict(lc, len=cache["len"] + 1)


_CROSS_POSITIONS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}


def cross_positions(s_slots: int, n_frames: int,
                    device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The decode kernel's positions for cross attention over a pool of
    ``n_frames`` encoder frames a slot: (q_pos (S,) all E - 1, kv_pos
    (S, E) with kv_pos[s, c] = c), so that ``kv_pos <= q_pos`` and
    ``q_pos - kv_pos < E`` hold for every frame and no entry is masked.
    Built once per (S, E, device) and reused, so a captured graph reads
    fixed addresses."""
    dev = torch.device(device)
    key = (s_slots, n_frames, dev)
    if key not in _CROSS_POSITIONS:
        kv_pos = torch.arange(n_frames, dtype=torch.int32, device=dev)
        _CROSS_POSITIONS[key] = (
            torch.full((s_slots,), n_frames - 1, dtype=torch.int32,
                       device=dev),
            kv_pos[None].expand(s_slots, n_frames).contiguous())
    return _CROSS_POSITIONS[key]


def gqa_cross_decode(p: dict, x: torch.Tensor, cross_cache: dict,
                     cfg: ModelConfig) -> torch.Tensor:
    """Cross attention in decode, one query a slot over the slot's encoder
    K / V: x (S, 1, d_model); ``cross_cache`` ``k`` / ``v`` (S, E, KV,
    dh), precomputed at admission.  Every frame is visible to every
    slot: the decode kernel runs with ``cross_positions``' constant
    table and its default window (E), so no frame is masked and none is
    padded (the reference's blockwise oracle pads E to its block and
    lets the zero keys in; the Pallas kernel and the oracle do not).
    Returns (S, 1, d_model)."""
    h = cfg.n_heads
    b = x.shape[0]
    q = linear(x, p["wq"]).reshape(b, 1, h, cfg.head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"]["scale"], cfg.norm_eps)
    k, v = cross_cache["k"], cross_cache["v"]
    q_pos, kv_pos = cross_positions(b, k.shape[1], x.device)
    out = decode_attention(q[:, 0].contiguous(), k, v, q_pos, kv_pos)
    return linear(out.reshape(b, 1, h * cfg.head_dim), p["wo"])


def precompute_cross_kv(p: dict, x_enc: torch.Tensor,
                        cfg: ModelConfig) -> dict:
    """The cross attention's K / V of the encoder output x_enc (B, E,
    d_model): ``{"k", "v": (B, E, KV, dh)}``, ``k_norm`` applied to K
    when the block has it."""
    kvh = cfg.n_kv_heads
    b, s = x_enc.shape[:2]
    k = linear(x_enc, p["wk"]).reshape(b, s, kvh, cfg.head_dim)
    v = linear(x_enc, p["wv"]).reshape(b, s, kvh, cfg.head_dim)
    if "k_norm" in p:
        k = rms_norm(k, p["k_norm"]["scale"], cfg.norm_eps)
    return {"k": k, "v": v}


# ======================================================================
# DeepSeek-V2 MLA [arXiv:2405.04434]
def make_mla(gen: torch.Generator, cfg: ModelConfig, dtype, *, batch=(),
             device=None) -> dict:
    """MLA's parameters, the reference's tree: a low-rank query
    (``wq_a``, ``q_norm``, ``wq_b``) when ``q_lora_rank`` > 0, else
    ``wq``; the joint KV down-projection ``w_dkv`` (latent and rope key),
    ``kv_norm``, the up-projection ``w_ukv`` (K's nope part and V per
    head) and ``wo``."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qd = m.nope_head_dim + m.rope_head_dim
    kw = dict(batch=batch, device=device)
    p = {}
    if m.q_lora_rank:
        p["wq_a"] = make_linear(gen, d, m.q_lora_rank, dtype, **kw)
        p["q_norm"] = make_rms_norm(m.q_lora_rank, dtype, **kw)
        p["wq_b"] = make_linear(gen, m.q_lora_rank, h * qd, dtype, **kw)
    else:
        p["wq"] = make_linear(gen, d, h * qd, dtype, **kw)
    p["w_dkv"] = make_linear(gen, d, m.kv_lora_rank + m.rope_head_dim,
                             dtype, **kw)
    p["kv_norm"] = make_rms_norm(m.kv_lora_rank, dtype, **kw)
    p["w_ukv"] = make_linear(gen, m.kv_lora_rank,
                             h * (m.nope_head_dim + m.v_head_dim), dtype,
                             **kw)
    p["wo"] = make_linear(gen, h * m.v_head_dim, d, dtype, **kw)
    return p


def _mla_q(p: dict, x: torch.Tensor, cfg: ModelConfig,
           positions: torch.Tensor):
    """(q_nope (B, T, H, nope), rope'd q_rope (B, T, H, rd))."""
    m = cfg.mla
    b, t = x.shape[:2]
    qd = m.nope_head_dim + m.rope_head_dim
    if "wq_a" in p:
        ql = rms_norm(linear(x, p["wq_a"]), p["q_norm"]["scale"],
                      cfg.norm_eps)
        q = linear(ql, p["wq_b"]).reshape(b, t, cfg.n_heads, qd)
    else:
        q = linear(x, p["wq"]).reshape(b, t, cfg.n_heads, qd)
    q_nope, q_rope = q.split([m.nope_head_dim, m.rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_ckv(p: dict, x: torch.Tensor, cfg: ModelConfig,
             positions: torch.Tensor):
    """(normed latent c_kv (B, T, kvr), rope'd k_rope (B, T, rd))."""
    m = cfg.mla
    c_kv, k_rope = linear(x, p["w_dkv"]).split(
        [m.kv_lora_rank, m.rope_head_dim], dim=-1)
    c_kv = rms_norm(c_kv, p["kv_norm"]["scale"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[..., None, :], positions,
                        cfg.rope_theta)[..., 0, :]
    return c_kv, k_rope


def mla_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                positions: Optional[torch.Tensor] = None,
                return_kv: bool = False):
    """Train / prefill MLA, causal, x: (B, T, d_model); differentiable.
    K / V are up-projected from the latent once and attended through the
    flash kernel at (nope + rope, v_head_dim); ``positions`` feed RoPE
    only (the mask is by index) and must run 0..T-1 as in prefill.
    Under ``return_kv`` also returns the cache entries ``{"c_kv": (B, T,
    kvr), "k_rope": (B, T, rd)}``."""
    m = cfg.mla
    b, t = x.shape[:2]
    h = cfg.n_heads
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32,
                                 device=x.device)[None].expand(b, t)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_ckv(p, x, cfg, positions)
    kv = (c_kv @ p["w_ukv"]["w"].to(c_kv.dtype)).reshape(
        b, t, h, m.nope_head_dim + m.v_head_dim)
    k_nope, v = kv.split([m.nope_head_dim, m.v_head_dim], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, t, h, m.rope_head_dim)], dim=-1)
    out = flash_attention(q, k, v.contiguous())
    y = linear(out.reshape(b, t, h * m.v_head_dim), p["wo"])
    if return_kv:
        return y, {"c_kv": c_kv, "k_rope": k_rope}
    return y


def init_mla_cache(batch: int, cache_len: int, cfg: ModelConfig, dtype,
                   device=None) -> dict:
    """An empty single-sequence MLA cache, as the reference's: latents and
    rope keys of ``cache_len`` positions and the scalar ``len``."""
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, cache_len, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, cache_len, m.rope_head_dim),
                                  dtype=dtype, device=device),
            "len": torch.zeros((), dtype=torch.int32, device=device)}


def _write_at(buf: torch.Tensor, lens: torch.Tensor,
              new: torch.Tensor) -> None:
    """``buf[s, lens[s]] = new[s]`` in place, with the reference's rule for
    an index past the buffer (``lens[s] >= C``): the write is dropped, as
    JAX drops an out-of-bounds scatter.  No host read: the row at
    min(lens, C - 1) is rewritten with its own value there."""
    c = buf.shape[1]
    rows = torch.arange(buf.shape[0], device=buf.device)
    idx = lens.clamp(max=c - 1).long()
    keep = (lens < c)[:, None]
    buf[rows, idx] = torch.where(keep, new.to(buf.dtype), buf[rows, idx])


def _write_clamped(buf: torch.Tensor, lens: torch.Tensor,
                   new: torch.Tensor) -> None:
    """``buf[s, min(lens[s], C - 1)] = new[s]`` in place: the reference's
    single-position write, whose ``dynamic_update_slice`` clamps its start
    into the buffer, so at ``len >= C`` row C - 1 is overwritten."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    buf[rows, lens.clamp(max=buf.shape[1] - 1).long()] = new.to(buf.dtype)


def _mla_attend(p: dict, x: torch.Tensor, cache: dict, lens: torch.Tensor,
                cfg: ModelConfig, write) -> torch.Tensor:
    """The absorbed MLA decode of x (S, 1, d_model) at positions ``lens``
    (S,): the new latent and rope key written by ``write(buf, lens, new)``
    into ``c_kv`` / ``k_rope`` in place, ``w_uk`` absorbed into ``q_c``,
    the ``mla_decode`` kernel over the entries ``c <= lens``, ``w_uv``
    and ``wo``."""
    m = cfg.mla
    b, h = x.shape[0], cfg.n_heads
    positions = lens[:, None]                             # (S, 1)
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_new, kr_new = _mla_ckv(p, x, cfg, positions)
    write(cache["c_kv"], lens, c_new[:, 0])
    write(cache["k_rope"], lens, kr_new[:, 0])
    w_ukv = p["w_ukv"]["w"].reshape(m.kv_lora_rank, h,
                                    m.nope_head_dim + m.v_head_dim)
    w_uk = w_ukv[..., :m.nope_head_dim]                   # (kvr, h, nope)
    w_uv = w_ukv[..., m.nope_head_dim:]                   # (kvr, h, v)
    q_c = torch.einsum("bthd,chd->bhc", q_nope, w_uk.to(q_nope.dtype))
    scale = (m.nope_head_dim + m.rope_head_dim) ** -0.5
    o_c = mla_kernel.mla_decode(q_c.contiguous(), q_rope[:, 0].contiguous(),
                                cache["c_kv"], cache["k_rope"], lens, scale)
    out = torch.einsum("bhc,chd->bhd", o_c, w_uv.to(o_c.dtype))
    return linear(out.reshape(b, 1, h * m.v_head_dim), p["wo"])


def mla_decode_slots(p: dict, x: torch.Tensor, cache: dict,
                     cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """Absorbed MLA decode with PER-SLOT positions (the serving pool).
    x: (S, 1, d_model); cache: ``c_kv`` (S, C, kvr), ``k_rope`` (S, C,
    rd), ``lens`` (S,) int32.  Slot s writes its new latent and rope key
    at index ``lens[s]`` of the linear buffer, unclamped (at ``lens ==
    C`` the write is dropped, as in the reference), IN PLACE into the
    cache tensors, and attends at query position ``lens[s]`` over the
    entries ``c <= lens[s]`` through the ``mla_decode`` kernel; the
    returned dict holds the same tensors and ``lens + 1``."""
    lens = cache["lens"]                                  # (S,) int32
    out = _mla_attend(p, x, cache, lens, cfg, _write_at)
    return out, {"c_kv": cache["c_kv"], "k_rope": cache["k_rope"],
                 "lens": lens + 1}


def mla_decode(p: dict, x: torch.Tensor, cache: dict,
               cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """Absorbed MLA decode at ONE position for the whole batch (the
    reference's single-sequence cache): x (B, 1, d_model); cache ``c_kv``
    (B, C, kvr), ``k_rope`` (B, C, rd), ``len`` () int32 on the device.
    As ``mla_decode_slots`` with every row at ``len``, but the write
    clamps: at ``len >= C`` it overwrites row C - 1 and every row is
    visible, as the reference's ``dynamic_update_slice`` and mask ``c <=
    len`` do.  IN PLACE; returns (out, the cache's tensors with ``len +
    1``)."""
    lens = _batch_lens(cache["len"], x.shape[0])
    out = _mla_attend(p, x, cache, lens, cfg, _write_clamped)
    return out, {"c_kv": cache["c_kv"], "k_rope": cache["k_rope"],
                 "len": cache["len"] + 1}


__all__ = ["make_gqa", "gqa_forward", "gqa_decode_slots", "EMPTY_POS",
           "init_kv_cache", "gqa_decode", "cross_positions",
           "gqa_cross_decode", "precompute_cross_kv", "make_mla",
           "mla_forward", "init_mla_cache", "mla_decode_slots", "mla_decode"]
