"""GQA attention: prefill and training through the flash kernel (which
carries a gradient), slot decode through the decode kernel.

Ports ``make_gqa``, ``_qkv``, ``gqa_forward`` and ``gqa_decode_slots`` from
``repro.models.attention`` for the ``causal`` kind, the ``sliding`` kind
with its window (the dense family's sliding-window variant and the
hybrid family's local attention) and the ``chunked`` kind with its chunk
(llama4's local attention: a key is seen when it is causal and lies in
the query's chunk of ``window`` positions); under the last two the
decode cache is a ring.  The ``full`` kind, cross attention and MLA are
later slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import (apply_rope, linear, make_linear,
                                       make_rms_norm, rms_norm)


def _mask_spec(kind: str, window: int) -> dict:
    """The flash / decode kernels' mask for a kind and its ``window``
    (the reference's one width argument): ``{"window", "chunk"}``, both 0
    for causal, ``window`` (> 0) as the window for sliding or as the
    chunk for chunked.  The full mask raises."""
    if kind == "causal":
        return {"window": 0, "chunk": 0}
    if kind == "sliding" and window > 0:
        return {"window": window, "chunk": 0}
    if kind == "chunked" and window > 0:
        return {"window": 0, "chunk": window}
    raise NotImplementedError(
        f"attention kind {kind!r} (window {window}): the port serves the "
        f"causal, sliding and chunked masks; the full mask comes in a "
        f"later slice")


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


def _qkv(p: dict, x: torch.Tensor, cfg: ModelConfig, h: int, kvh: int):
    b, t = x.shape[:2]
    q = linear(x, p["wq"]).reshape(b, t, h, cfg.head_dim)
    k = linear(x, p["wk"]).reshape(b, t, kvh, cfg.head_dim)
    v = linear(x, p["wv"]).reshape(b, t, kvh, cfg.head_dim)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"]["scale"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"]["scale"], cfg.norm_eps)
    return q, k, v


def gqa_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                kind: str = "causal", window: int = 0,
                positions: Optional[torch.Tensor] = None,
                return_kv: bool = False):
    """Full-sequence (prefill or training) attention.  x: (B, T, d_model),
    differentiable (the flash wrapper is an autograd Function).  The
    masks follow sequence order (the flash kernel masks by index), so
    ``positions`` only feeds RoPE and must run 0..T-1 as in prefill."""
    mask = _mask_spec(kind, window)
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    b, t = x.shape[:2]
    q, k, v = _qkv(p, x, cfg, h, kvh)
    if positions is None:
        positions = torch.arange(t, dtype=torch.int32,
                                 device=x.device)[None].expand(b, t)
    if cfg.rope_theta > 0:
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
    linear buffer (causal) and attends at query position ``lens[s]``.  The write
    goes IN PLACE into the cache tensors (the pool is updated where it
    lies instead of copied each step); the returned dict holds the same
    tensors and ``lens + 1``.
    """
    mask = _mask_spec(kind, window)
    h, kvh = cfg.n_heads, cfg.n_kv_heads
    b = x.shape[0]
    cache_len = cache["k"].shape[1]
    lens = cache["lens"]                                  # (S,) int32
    positions = lens[:, None]                             # (S, 1)
    q, k, v = _qkv(p, x, cfg, h, kvh)
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


__all__ = ["make_gqa", "gqa_forward", "gqa_decode_slots"]
