"""The homogeneous transformer, dense and ssm families: init, the
training forward, prefill and slot decode.

Ports ``init_params``, ``_embed_inputs``, ``forward`` (``_forward_impl``),
``prefill``, ``init_cache`` and ``decode_step_slots`` from
``repro.models.transformer`` with the same
parameter and cache trees (layer axis L stacked first), so weights and
caches carried across with ``repro_torch.bridge`` drop in.  The layer stack
is a Python loop over L where JAX scans.  A dense block is pre-norm GQA
attention and SwiGLU; an ssm block (Falcon-Mamba) is one pre-norm Mamba
mixer, whose cache is its recurrent state.  Other families (moe, hybrid,
vlm, audio), MLA, windowed / chunked attention and the single-position
``decode_step`` are later slices and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models.common import (linear, make_linear, make_rms_norm,
                                       make_swiglu, mean_pool, rms_norm,
                                       swiglu, truncated_normal_init)

_SENTINEL = (2 ** 31 - 1) // 2       # position of an empty cache entry


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "ssm") or cfg.mla is not None:
        raise NotImplementedError(
            f"family {cfg.family!r}{' with MLA' if cfg.mla else ''}: the "
            f"port runs the dense and ssm families; the others come in "
            f"later slices")
    if cfg.sliding_window or cfg.attention_chunk:
        raise NotImplementedError(
            "sliding-window and chunked attention come in a later slice")


def _layers(blocks: dict, n: int) -> list:
    """The stacked block tree as n per-layer trees: views, no copy.  One
    ``unbind`` per leaf, so a gradient flows back into the stack once."""
    split = {k: _layers(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in blocks.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


# ======================================================================
# init
def init_params(gen: Union[int, torch.Generator], cfg: ModelConfig, *,
                device=None) -> dict:
    """Random weights with the JAX package's tree.  ``gen`` is a seed or a
    ``torch.Generator`` on ``device`` (default ``cuda``; raises without a
    GPU)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    if isinstance(gen, int):
        gen = torch.Generator(device=dev).manual_seed(gen)
    elif gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device}, params on {dev}")
    dtype = _dtype(cfg)
    d, L = cfg.d_model, (cfg.n_layers,)
    p = {
        "embed": truncated_normal_init(gen, (cfg.vocab_size, d), dtype=dtype,
                                       device=dev),
        "final_norm": make_rms_norm(d, dtype, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = make_linear(gen, d, cfg.vocab_size, dtype, device=dev)
    if cfg.family == "ssm":
        p["blocks"] = {
            "ln": make_rms_norm(d, dtype, batch=L, device=dev),
            "mixer": ssm.make_mamba(gen, cfg, dtype, batch=L, device=dev),
        }
        return p
    p["blocks"] = {
        "ln1": make_rms_norm(d, dtype, batch=L, device=dev),
        "attn": attn.make_gqa(gen, cfg, dtype, batch=L, device=dev),
        "ln2": make_rms_norm(d, dtype, batch=L, device=dev),
        "mlp": make_swiglu(gen, d, cfg.d_ff, dtype, batch=L, device=dev),
    }
    return p


# ======================================================================
# forward
def _embed_inputs(params: dict, batch: dict, cfg: ModelConfig):
    if "inputs_embeds" in batch:                  # the paper's adapter path
        x = batch["inputs_embeds"].to(_dtype(cfg))
    else:
        x = params["embed"][batch["tokens"].long()]
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    return x, positions


def _run_stack(params: dict, x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig, collect: bool = False):
    """The decoder stack over the full sequence (a Python loop where JAX
    scans).  Returns the residual stream and, when ``collect``, each
    layer's rope'd K/V (dense) or final recurrent state (ssm)."""
    kvs = []
    for bp in _layers(params["blocks"], cfg.n_layers):
        if cfg.family == "ssm":
            h = rms_norm(x, bp["ln"]["scale"], cfg.norm_eps)
            h, state = ssm.mamba_forward(bp["mixer"], h, cfg)
            if collect:
                kvs.append(state)
            x = x + h
            continue
        h = rms_norm(x, bp["ln1"]["scale"], cfg.norm_eps)
        h = attn.gqa_forward(bp["attn"], h, cfg, positions=positions,
                             return_kv=collect)
        if collect:
            h, kv = h
            kvs.append(kv)
        x = x + h
        h = rms_norm(x, bp["ln2"]["scale"], cfg.norm_eps)
        x = x + swiglu(bp["mlp"], h)
    return x, kvs


def _head(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits of the final-normed stream."""
    if cfg.tie_embeddings:
        return x @ params["embed"].T.to(x.dtype)
    return linear(x, params["lm_head"])


def _final(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)


def pooled(params: dict, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """``forward``'s ``aux["pooled"]`` without the logits (what the
    federation reads): the mean over tokens of the final-normed stream,
    (B, d_model) in the model dtype."""
    _check_supported(cfg)
    x, positions = _embed_inputs(params, batch, cfg)
    x, _ = _run_stack(params, x, positions, cfg)
    return mean_pool(_final(params, x, cfg))


def forward(params: dict, batch: dict,
            cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """Full-sequence forward -> (logits (B, S, V), {"pooled": (B, d)}).
    ``batch`` holds ``tokens`` or the adapter path's ``inputs_embeds``."""
    _check_supported(cfg)
    x, positions = _embed_inputs(params, batch, cfg)
    x, _ = _run_stack(params, x, positions, cfg)
    x = _final(params, x, cfg)
    return _head(params, x, cfg), {"pooled": mean_pool(x)}


def prefill(params: dict, batch: dict, cfg: ModelConfig,
            cache_len: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """Forward over the prompt, then pack the per-layer caches for decode.
    Returns full-sequence logits (B, S, V) and the cache: for the dense
    family the rope'd K/V with room for ``cache_len`` positions (default
    S + 1024), ``{"k", "v": (L, B, C, KV, dh), "pos": (L, B, C), "len":
    ()}``, empty entries at the position sentinel; for the ssm family the
    stacked final states ``{"h": (L, B, d_inner, N) f32, "conv": (L, B,
    K - 1, d_inner), "len": ()}`` (``cache_len`` is not read)."""
    _check_supported(cfg)
    x, positions = _embed_inputs(params, batch, cfg)
    x, kvs = _run_stack(params, x, positions, cfg, collect=True)
    logits = _head(params, _final(params, x, cfg), cfg)

    b, s = x.shape[:2]
    length = torch.tensor(s, dtype=torch.int32, device=x.device)
    if cfg.family == "ssm":
        return logits, {"h": torch.stack([st["h"] for st in kvs]),
                        "conv": torch.stack([st["conv"] for st in kvs]),
                        "len": length}
    ks, vs = [kv["k"] for kv in kvs], [kv["v"] for kv in kvs]
    target = max(cache_len if cache_len is not None else s + 1024, s)

    def grow(t: torch.Tensor, fill=0) -> torch.Tensor:
        out = t.new_full((t.shape[0], t.shape[1], target) + t.shape[3:], fill)
        out[:, :, :s] = t
        return out

    pos = positions.expand(cfg.n_layers, b, s)
    cache = {"k": grow(torch.stack(ks)), "v": grow(torch.stack(vs)),
             "pos": grow(pos, _SENTINEL), "len": length}
    return logits, cache


# ======================================================================
# decode
def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device=None) -> dict:
    """An empty decode cache for ``batch`` sequences (default ``cuda``);
    for the ssm family zero states, as ``prefill`` shapes them."""
    _check_supported(cfg)
    dev = resolve_device(device)
    if cfg.family == "ssm":
        st = ssm.init_mamba_state(batch, cfg, _dtype(cfg), device=dev)
        c = {k: v.expand(cfg.n_layers, *v.shape).contiguous()
             for k, v in st.items()}
        c["len"] = torch.zeros((), dtype=torch.int32, device=dev)
        return c
    shape = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "pos": torch.full(shape[:3], _SENTINEL, dtype=torch.int32,
                              device=dev),
            "len": torch.zeros((), dtype=torch.int32, device=dev)}


def decode_step_slots(params: dict, cache: dict, batch: dict,
                      cfg: ModelConfig, *,
                      step_mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, dict]:
    """One new token per SLOT, each slot at its own position
    ``cache['len']`` (S,) int32.  batch: ``{'tokens': (S, 1)}``.

    ``step_mask`` (S,) bool freezes masked slots: their position does not
    advance.  Attention writes at a frozen position are idempotent, so
    K/V are written for every slot, as in the JAX package.  A recurrent
    update is not idempotent: a masked slot's ssm ``h`` and ``conv`` keep
    their bits (JAX's ``keep``), so a slot that resumes continues
    exactly.  The cache's K/V/pos, or h/conv, tensors are updated in
    place; the returned cache holds them and the new ``len``.  Returns
    logits (S, 1, V)."""
    _check_supported(cfg)
    x = params["embed"][batch["tokens"].long()]
    lens = cache["len"]
    for i, bp in enumerate(_layers(params["blocks"], cfg.n_layers)):
        if cfg.family == "ssm":
            hs, cs = cache["h"][i], cache["conv"][i]
            h = rms_norm(x, bp["ln"]["scale"], cfg.norm_eps)
            h, new = ssm.mamba_decode(bp["mixer"], h, {"h": hs, "conv": cs},
                                      cfg)
            x = x + h
            _keep(hs, new["h"], step_mask)
            _keep(cs, new["conv"], step_mask)
            continue
        lc = {"k": cache["k"][i], "v": cache["v"][i], "pos": cache["pos"][i],
              "lens": lens}
        h = rms_norm(x, bp["ln1"]["scale"], cfg.norm_eps)
        h, _ = attn.gqa_decode_slots(bp["attn"], h, lc, cfg)
        x = x + h
        h = rms_norm(x, bp["ln2"]["scale"], cfg.norm_eps)
        x = x + swiglu(bp["mlp"], h)
    new_lens = lens + 1 if step_mask is None \
        else torch.where(step_mask, lens + 1, lens)
    logits = _head(params, _final(params, x, cfg), cfg)
    return logits, dict(cache, len=new_lens.to(torch.int32))


def _keep(old: torch.Tensor, new: torch.Tensor,
          step_mask: Optional[torch.Tensor]) -> None:
    """Write ``new`` over the state ``old`` (slot axis 0) in place; a slot
    masked out of ``step_mask`` keeps its old values."""
    if step_mask is None:
        old.copy_(new)
    else:
        m = step_mask.reshape((-1,) + (1,) * (old.dim() - 1))
        torch.where(m, new.to(old.dtype), old, out=old)


__all__ = ["init_params", "forward", "pooled", "prefill", "init_cache",
           "decode_step_slots"]
