"""The homogeneous transformer, dense, vlm, moe, ssm, hybrid and audio
families: init, the training forward, prefill, the single-position
decode and slot decode.

Ports ``Runtime`` (its ``window_override`` and ``remat`` fields),
``init_params``, ``_embed_inputs``, ``forward`` (``_forward_impl``),
``prefill``, ``init_cache``, ``decode_step`` and ``decode_step_slots``
from ``repro.models.transformer`` with the same parameter and cache
trees, so weights and caches carried across with ``repro_torch.bridge``
drop in.  The layer stack is a Python loop where JAX scans; under
``Runtime(remat=True)`` each layer of it is checkpointed
(``torch.utils.checkpoint``, non-reentrant) where the reference wraps
its scan body in ``jax.checkpoint``: a layer's activations are
recomputed in the backward instead of kept, and no value changes.

- dense: pre-norm GQA attention and SwiGLU, the layer axis L stacked
  first.  The mask is causal, or sliding under ``cfg.sliding_window`` or
  ``Runtime(window_override=)`` (the family's sliding-window variant), or
  chunked under ``cfg.attention_chunk`` (llama4); the decode cache is
  then a ring of the window's or chunk's width.
- vlm (Phi-3-vision): the dense stack plus ``adapter``, a linear map of
  the stub vision tower's patch embeddings (``image_embed_dim``) into
  d_model.  A batch with ``image_embeds`` (B, n_img, image_embed_dim)
  gets their adapted rows prepended to the text, positions numbered over
  both; the logits drop the image positions, ``pooled`` keeps them (the
  reference pools before the strip), and ``prefill``'s cache and ``len``
  hold image + text.  Without ``image_embeds`` it is the dense model.
- moe (Llama-4-Scout, DeepSeek-V2): the dense block with the MoE FFN of
  ``models/moe.py`` (capacity routing over the routed experts, plus the
  shared experts) in place of the SwiGLU; ``forward`` returns the
  router's ``load_balance`` and ``router_z``, each the mean over the
  layers (0 for the other families, as in the reference).  Under
  ``cfg.mla`` (DeepSeek-V2) the block's attention is MLA
  (``attention.make_mla`` / ``mla_forward`` / ``mla_decode_slots``,
  always causal) and the decode cache holds the compressed latents:
  ``{"c_kv": (L, B, C, kv_lora_rank), "k_rope": (L, B, C,
  rope_head_dim), "len"}``, a linear buffer indexed by position, with no
  ``pos`` leaf.
- ssm (Falcon-Mamba): one pre-norm Mamba mixer a layer, whose cache is its
  recurrent state.
- hybrid (RecurrentGemma): ``groups`` stacks the repeated block pattern
  (keys ``b0``, ``b1``, ... with the group axis first), ``tail`` lists the
  leftover layers unstacked; a recurrent block is pre-norm RG-LRU and
  SwiGLU, an attention block pre-norm local (sliding, width
  ``cfg.rglru.local_window``) GQA and SwiGLU, its cache a ring.
- audio (Whisper): an encoder-decoder.  The encoder (``enc_blocks``,
  dense blocks, ``n_encoder_layers`` of them) takes a batch's
  ``enc_embeds`` (B, E, encoder_embed_dim) -- the stub conv front end's
  frames -- through ``enc_adapter``, adds the sinusoidal positions and
  runs pre-norm attention under the full mask without RoPE and a
  SwiGLU, then ``enc_norm``.  The decoder (``blocks``: ``ln1``,
  ``self_attn``, ``ln2``, ``cross_attn``, ``ln3``, ``mlp``) embeds the
  tokens plus the sinusoid and runs causal self-attention without RoPE,
  cross attention over the encoder output (its K / V computed once a
  layer, for the attention and the cache alike) and a SwiGLU.  Its
  cache adds ``cross_k`` / ``cross_v`` (L, B, E, KV, dh) to the causal
  K / V; ``len`` counts the text.  A decode step adds the sinusoid's row
  at each slot's position (computed on the device, no table) and
  attends over the cross K / V through the decode kernel with every
  frame visible.  As in the reference, the decode step's self-attention
  ropes q and k when ``cfg.rope_theta`` > 0, where the prefill does not
  (Whisper's is 0).

``decode_step`` is the reference's single-position decode: one scalar
``len`` (an int32 tensor on the device) for the whole batch, as
``prefill`` and ``init_cache`` return it, through ``attention.gqa_decode``
/ ``mla_decode``; ``decode_step_slots`` is the serving pool's, one
position a slot.  MLA outside the moe family raises
``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import rglru
from repro_torch.models import ssm
from repro_torch.models.common import (linear, make_linear, make_rms_norm,
                                       make_swiglu, mean_pool, rms_norm,
                                       sinusoid_rows, sinusoidal_positions,
                                       swiglu, truncated_normal_init)

_SENTINEL = attn.EMPTY_POS           # position of an empty cache entry


@dataclass(frozen=True)
class Runtime:
    """Execution context threaded through model calls, as in the JAX
    package.  The port reads ``window_override`` (force a sliding window of
    that width on the dense family) and ``remat`` (checkpoint every layer
    of the stack: training at longer sequences in less memory, the same
    values); the mesh fields come with the mesh slice."""
    window_override: int = 0
    remat: bool = False


_RT = Runtime()


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _attn_kind(cfg: ModelConfig, rt: Runtime) -> Tuple[str, int]:
    if rt.window_override:
        return "sliding", rt.window_override
    if cfg.sliding_window:
        return "sliding", cfg.sliding_window
    if cfg.attention_chunk:
        return "chunked", cfg.attention_chunk
    return "causal", 0


def _check_supported(cfg: ModelConfig, rt: Optional[Runtime]) -> Runtime:
    """Raise on what the port does not run yet; returns the runtime."""
    if (cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid", "audio")
            or (cfg.mla is not None and cfg.family != "moe")):
        raise NotImplementedError(
            f"family {cfg.family!r}{' with MLA' if cfg.mla else ''}: the "
            f"port runs the dense, vlm, moe (with or without MLA), ssm, "
            f"hybrid and audio families, MLA in the moe family only")
    return rt or _RT


def _layer(rt: Runtime, fn, *args):
    """``fn(*args)``: one layer of a stack, checkpointed under
    ``rt.remat`` when autograd records (the layer's activations are
    recomputed in the backward; the values are the same)."""
    if rt.remat and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return fn(*args)


def _layers(blocks: dict, n: int) -> list:
    """The stacked block tree as n per-layer trees: views, no copy.  One
    ``unbind`` per leaf, so a gradient flows back into the stack once."""
    split = {k: _layers(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in blocks.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


def _hybrid_shape(cfg: ModelConfig) -> Tuple[tuple, int, int]:
    """(block pattern, stacked groups, tail layers)."""
    pat = cfg.rglru.block_pattern
    return (pat,) + divmod(cfg.n_layers, len(pat))


# ======================================================================
# init
def _dense_block(gen, cfg: ModelConfig, dtype, batch, dev) -> dict:
    """Pre-norm attention (MLA under ``cfg.mla``, else GQA) and FFN: the
    MoE FFN for the moe family, else a SwiGLU."""
    d, kw = cfg.d_model, dict(batch=batch, device=dev)
    make_attn = attn.make_mla if cfg.mla is not None else attn.make_gqa
    p = {"ln1": make_rms_norm(d, dtype, **kw),
         "attn": make_attn(gen, cfg, dtype, **kw),
         "ln2": make_rms_norm(d, dtype, **kw)}
    if cfg.family == "moe":
        p["moe"] = moe.make_moe(gen, cfg, dtype, **kw)
    else:
        p["mlp"] = make_swiglu(gen, d, cfg.d_ff, dtype, **kw)
    return p


def _dec_block(gen, cfg: ModelConfig, dtype, batch, dev) -> dict:
    """The audio decoder's block: pre-norm causal self-attention, cross
    attention over the encoder output and a SwiGLU."""
    d, kw = cfg.d_model, dict(batch=batch, device=dev)
    return {"ln1": make_rms_norm(d, dtype, **kw),
            "self_attn": attn.make_gqa(gen, cfg, dtype, **kw),
            "ln2": make_rms_norm(d, dtype, **kw),
            "cross_attn": attn.make_gqa(gen, cfg, dtype, **kw),
            "ln3": make_rms_norm(d, dtype, **kw),
            "mlp": make_swiglu(gen, d, cfg.d_ff, dtype, **kw)}


def _rec_block(gen, cfg: ModelConfig, dtype, batch, dev) -> dict:
    d, kw = cfg.d_model, dict(batch=batch, device=dev)
    return {"ln1": make_rms_norm(d, dtype, **kw),
            "mixer": rglru.make_rglru_block(gen, cfg, dtype, **kw),
            "ln2": make_rms_norm(d, dtype, **kw),
            "mlp": make_swiglu(gen, d, cfg.d_ff, dtype, **kw)}


def init_params(gen: Union[int, torch.Generator], cfg: ModelConfig, *,
                device=None, rt: Optional[Runtime] = None) -> dict:
    """Random weights with the JAX package's tree.  ``gen`` is a seed or a
    ``torch.Generator`` on ``device`` (default ``cuda``; raises without a
    GPU).  On ``device="meta"`` (shapes and dtypes, no memory) the
    generator is a CPU one."""
    _check_supported(cfg, rt)
    dev = resolve_device(device)
    gen_dev = torch.device("cpu") if dev.type == "meta" else dev
    if isinstance(gen, int):
        gen = torch.Generator(device=gen_dev).manual_seed(gen)
    elif gen.device.type != gen_dev.type:
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
    elif cfg.family == "hybrid":
        pat, n_groups, n_tail = _hybrid_shape(cfg)
        block = {"recurrent": _rec_block, "attention": _dense_block}
        p["groups"] = {f"b{i}": block[kind](gen, cfg, dtype, (n_groups,), dev)
                       for i, kind in enumerate(pat)}
        p["tail"] = [block[pat[j % len(pat)]](gen, cfg, dtype, (), dev)
                     for j in range(n_tail)]
    elif cfg.family == "audio":
        p["enc_blocks"] = _dense_block(gen, cfg, dtype,
                                       (cfg.n_encoder_layers,), dev)
        p["blocks"] = _dec_block(gen, cfg, dtype, L, dev)
        p["enc_adapter"] = make_linear(gen, cfg.encoder_embed_dim, d, dtype,
                                       device=dev)
        p["enc_norm"] = make_rms_norm(d, dtype, device=dev)
    else:
        p["blocks"] = _dense_block(gen, cfg, dtype, L, dev)
        if cfg.family == "vlm":
            p["adapter"] = make_linear(gen, cfg.image_embed_dim, d, dtype,
                                       device=dev)
    return p


# ======================================================================
# forward
def _embed_inputs(params: dict, batch: dict, cfg: ModelConfig):
    if "inputs_embeds" in batch:                  # the paper's adapter path
        x = batch["inputs_embeds"].to(_dtype(cfg))
    else:
        x = params["embed"][batch["tokens"].long()]
    if cfg.family == "vlm" and "image_embeds" in batch:
        img = linear(batch["image_embeds"].to(x.dtype), params["adapter"])
        x = torch.cat([img, x], dim=1)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    return x, positions


def _ffn(bp: dict, h: torch.Tensor, cfg: ModelConfig):
    """The block's FFN on its normed stream: (y, (load_balance, router_z))
    for an MoE block, (y, None) for a SwiGLU."""
    if "moe" in bp:
        y, aux = moe.moe_ffn(bp["moe"], h, cfg)
        return y, (aux["load_balance"], aux["router_z"])
    return swiglu(bp["mlp"], h), None


def _attn_block(bp: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, kind: str, window: int, collect: bool):
    """Pre-norm attention (GQA, or MLA under ``cfg.mla``) and the FFN
    (SwiGLU or MoE); returns (x, the cache entry or None -- rope'd K/V,
    or MLA's latent and rope key --, the router's aux values or None)."""
    h = rms_norm(x, bp["ln1"]["scale"], cfg.norm_eps)
    if cfg.mla is not None:
        h = attn.mla_forward(bp["attn"], h, cfg, positions=positions,
                             return_kv=collect)
    else:
        h = attn.gqa_forward(bp["attn"], h, cfg, kind=kind, window=window,
                             positions=positions, return_kv=collect)
    h, kv = h if collect else (h, None)
    x = x + h
    h, aux = _ffn(bp, rms_norm(x, bp["ln2"]["scale"], cfg.norm_eps), cfg)
    return x + h, kv, aux


def _rec_body(bp: dict, x: torch.Tensor, cfg: ModelConfig):
    """Pre-norm RG-LRU and SwiGLU; returns (x, final recurrent state)."""
    h = rms_norm(x, bp["ln1"]["scale"], cfg.norm_eps)
    y, state = rglru.rglru_forward(bp["mixer"], h, cfg)
    x = x + y
    h = rms_norm(x, bp["ln2"]["scale"], cfg.norm_eps)
    return x + swiglu(bp["mlp"], h), state


def _ssm_body(bp: dict, x: torch.Tensor, cfg: ModelConfig):
    """Pre-norm Mamba mixer; returns (x, final state)."""
    h, c = ssm.mamba_forward(bp["mixer"],
                             rms_norm(x, bp["ln"]["scale"], cfg.norm_eps), cfg)
    return x + h, c


def _hybrid_stack(params: dict, cfg: ModelConfig) -> list:
    """The hybrid stack in execution order: (kind, block params, where)
    with ``where`` = (``"b{i}"``, group) for a stacked block and
    (``"tail"``, j) for the j-th tail block."""
    pat, n_groups, _ = _hybrid_shape(cfg)
    per = {f"b{i}": _layers(params["groups"][f"b{i}"], n_groups)
           for i in range(len(pat))}
    out = [(kind, per[f"b{i}"][g], (f"b{i}", g))
           for g in range(n_groups) for i, kind in enumerate(pat)]
    return out + [(pat[j % len(pat)], bp, ("tail", j))
                  for j, bp in enumerate(params["tail"])]


def _run_stack(params: dict, x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig, rt: Runtime, collect: bool = False):
    """The decoder stack over the full sequence (a Python loop where JAX
    scans).  Returns the residual stream, when ``collect`` each layer's
    cache entry in execution order -- rope'd K/V (attention) or the final
    recurrent state (ssm, RG-LRU) -- and each MoE layer's router aux
    values (load_balance, router_z)."""
    caches, auxes = [], []
    if cfg.family == "hybrid":
        for kind, bp, _ in _hybrid_stack(params, cfg):
            if kind == "recurrent":
                x, c = _layer(rt, _rec_body, bp, x, cfg)
            else:
                x, c, _ = _layer(rt, _attn_block, bp, x, positions, cfg,
                                 "sliding", cfg.rglru.local_window, collect)
            caches.append(c)
        return x, caches, auxes
    kind, window = _attn_kind(cfg, rt)
    for bp in _layers(params["blocks"], cfg.n_layers):
        if cfg.family == "ssm":
            x, c = _layer(rt, _ssm_body, bp, x, cfg)
        else:
            x, c, aux = _layer(rt, _attn_block, bp, x, positions, cfg, kind,
                               window, collect)
            if aux is not None:
                auxes.append(aux)
        caches.append(c)
    return x, caches, auxes


def _enc_layer(bp: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = rms_norm(x, bp["ln1"]["scale"], cfg.norm_eps)
    x = x + attn.gqa_forward(bp["attn"], h, cfg, kind="full", rope=False)
    h = rms_norm(x, bp["ln2"]["scale"], cfg.norm_eps)
    return x + swiglu(bp["mlp"], h)


def _encoder_forward(params: dict, batch: dict, cfg: ModelConfig,
                     rt: Runtime = _RT) -> torch.Tensor:
    """The audio encoder over ``batch["enc_embeds"]`` (B, E,
    encoder_embed_dim): the adapter on the frames cast to the model
    dtype, plus the sinusoid, the full-mask stack without RoPE, then
    ``enc_norm``.  Returns (B, E, d_model)."""
    x = linear(batch["enc_embeds"].to(_dtype(cfg)), params["enc_adapter"])
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 x.device).to(x.dtype)[None]
    for bp in _layers(params["enc_blocks"], cfg.n_encoder_layers):
        x = _layer(rt, _enc_layer, bp, x, cfg)
    return rms_norm(x, params["enc_norm"]["scale"], cfg.norm_eps)


def _dec_layer(bp: dict, x: torch.Tensor, enc: torch.Tensor,
               positions: torch.Tensor, cfg: ModelConfig, collect: bool):
    """One audio decoder layer; returns (x, its cache entry or None)."""
    h = rms_norm(x, bp["ln1"]["scale"], cfg.norm_eps)
    h = attn.gqa_forward(bp["self_attn"], h, cfg, kind="causal",
                         positions=positions, rope=False, return_kv=collect)
    h, kv = h if collect else (h, None)
    x = x + h
    h = rms_norm(x, bp["ln2"]["scale"], cfg.norm_eps)
    h, cross = attn.gqa_forward(bp["cross_attn"], h, cfg, x_cross=enc,
                                positions=positions, return_kv=True)
    x = x + h
    h = rms_norm(x, bp["ln3"]["scale"], cfg.norm_eps)
    x = x + swiglu(bp["mlp"], h)
    if collect:
        return x, dict(kv, cross_k=cross["k"], cross_v=cross["v"])
    return x, None


def _audio_stack(params: dict, batch: dict, cfg: ModelConfig, rt: Runtime,
                 collect: bool):
    """The audio model over a batch: the encoder, then the decoder over
    the tokens plus the sinusoid.  Returns the decoder's stream, its
    positions and, when ``collect``, each layer's cache entry: the causal
    K / V and the cross attention's K / V (computed once a layer, for
    the attention and the cache)."""
    enc = _encoder_forward(params, batch, cfg, rt)
    x = params["embed"][batch["tokens"].long()]
    b, s = x.shape[:2]
    x = x + sinusoidal_positions(s, cfg.d_model, x.device).to(x.dtype)[None]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    caches = []
    for bp in _layers(params["blocks"], cfg.n_layers):
        x, c = _layer(rt, _dec_layer, bp, x, enc, positions, cfg, collect)
        if collect:
            caches.append(c)
    return x, positions, caches


def _stream(params: dict, batch: dict, cfg: ModelConfig, rt: Runtime,
            collect: bool = False):
    """The model's residual stream before the final norm, its positions,
    the per-layer cache entries (when ``collect``) and the router's aux
    values (``_run_stack``'s)."""
    if cfg.family == "audio":
        return _audio_stack(params, batch, cfg, rt, collect) + ([],)
    x, positions = _embed_inputs(params, batch, cfg)
    x, caches, auxes = _run_stack(params, x, positions, cfg, rt, collect)
    return x, positions, caches, auxes


def _head(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits of the final-normed stream."""
    if cfg.tie_embeddings:
        return x @ params["embed"].T.to(x.dtype)
    return linear(x, params["lm_head"])


def _final(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)


def _text(x: torch.Tensor, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """The text positions of the stream: a vlm batch's image positions,
    prepended by ``_embed_inputs``, dropped."""
    if cfg.family == "vlm" and "image_embeds" in batch:
        return x[:, batch["image_embeds"].shape[1]:]
    return x


def pooled(params: dict, batch: dict, cfg: ModelConfig, *,
           rt: Optional[Runtime] = None) -> torch.Tensor:
    """``forward``'s ``aux["pooled"]`` without the logits (what the
    federation reads): the mean over tokens of the final-normed stream,
    (B, d_model) in the model dtype."""
    rt = _check_supported(cfg, rt)
    x, _, _, _ = _stream(params, batch, cfg, rt)
    return mean_pool(_final(params, x, cfg))


def forward(params: dict, batch: dict, cfg: ModelConfig, *,
            rt: Optional[Runtime] = None) -> Tuple[torch.Tensor, dict]:
    """Full-sequence forward -> (logits (B, S, V), aux): ``aux["pooled"]``
    (B, d) and the router's f32 scalars ``load_balance`` and ``router_z``,
    each the mean over the MoE layers (0 for the other families).
    ``batch`` holds ``tokens`` or the adapter path's ``inputs_embeds``,
    and for the vlm family optionally ``image_embeds``: the logits are
    the text positions', the pooled mean takes the image's too; for the
    audio family ``tokens`` and ``enc_embeds`` (B, E,
    encoder_embed_dim)."""
    rt = _check_supported(cfg, rt)
    x, _, _, auxes = _stream(params, batch, cfg, rt)
    x = _final(params, x, cfg)
    if auxes:
        lb, rz = (torch.stack(a).mean() for a in zip(*auxes))
    else:
        lb = rz = torch.zeros((), dtype=torch.float32, device=x.device)
    return _head(params, _text(x, batch, cfg), cfg), {
        "load_balance": lb, "router_z": rz, "pooled": mean_pool(x)}


# ======================================================================
# prefill: forward + pack the collected per-layer caches for decode
def _ring_pack(x: torch.Tensor, s: int, w: int, fill=0) -> torch.Tensor:
    """The last min(s, w) entries of x (B, S, ...) in the ring layout of
    width w, the entry of position p at slot p % w; empty slots ``fill``."""
    if s >= w:
        return torch.roll(x[:, s - w:], s % w, dims=1)
    out = x.new_full((x.shape[0], w) + tuple(x.shape[2:]), fill)
    out[:, :s] = x
    return out


def _pack_kv(ks: list, vs: list, positions: torch.Tensor, w: int,
             target: int) -> dict:
    """Per-layer K/V (B, S, KV, dh) -> stacked (n, B, C, KV, dh) K/V and
    (n, B, C) positions: a ring of width ``w`` when w > 0, else a linear
    buffer of ``target`` positions; empty entries at the sentinel."""
    s = ks[0].shape[1]
    n = len(ks)
    if w:
        def put(t, fill=0):
            return _ring_pack(t, s, w, fill)
    else:
        def put(t, fill=0):
            out = t.new_full((t.shape[0], target) + tuple(t.shape[2:]), fill)
            out[:, :s] = t
            return out
    pos = put(positions, _SENTINEL)
    return {"k": torch.stack([put(k) for k in ks]),
            "v": torch.stack([put(v) for v in vs]),
            "pos": pos.expand(n, *pos.shape).contiguous()}


def prefill(params: dict, batch: dict, cfg: ModelConfig,
            cache_len: Optional[int] = None, *,
            rt: Optional[Runtime] = None) -> Tuple[torch.Tensor, dict]:
    """Forward over the prompt, then pack the per-layer caches for decode.
    Returns full-sequence logits (B, S, V) and the cache: for the dense,
    vlm and moe families the rope'd K/V with room for ``cache_len`` positions
    (default S + 1024), ``{"k", "v": (L, B, C, KV, dh), "pos": (L, B, C),
    "len": ()}``, empty entries at the position sentinel -- under a
    sliding window or a chunk a ring of its width (``cache_len`` is then
    not read);
    under ``cfg.mla`` the latents ``{"c_kv": (L, B, C, kv_lora_rank),
    "k_rope": (L, B, C, rope_head_dim), "len": ()}``, grown to
    ``cache_len`` with zeros;
    for the ssm family the stacked final states ``{"h": (L, B, d_inner, N)
    f32, "conv": (L, B, K - 1, d_inner), "len": ()}``; for the hybrid
    family ``{"groups": {"b{i}": ...}, "tail": [...], "len": ()}``, each
    recurrent block's ``{"h": (B, w) f32, "conv": (B, K - 1, w)}`` and each
    attention block's ring of width ``cfg.rglru.local_window``, stacked
    over the groups (leading axis) under ``groups``; for the audio family
    the causal K / V as for dense (a linear buffer) plus the encoder's
    ``cross_k`` / ``cross_v`` (L, B, E, KV, dh), ``len`` the text's
    length."""
    rt = _check_supported(cfg, rt)
    x, positions, caches, _ = _stream(params, batch, cfg, rt, collect=True)
    logits = _head(params, _text(_final(params, x, cfg), batch, cfg), cfg)

    b, s = x.shape[:2]
    length = torch.tensor(s, dtype=torch.int32, device=x.device)
    if cfg.family == "ssm":
        return logits, {"h": torch.stack([st["h"] for st in caches]),
                        "conv": torch.stack([st["conv"] for st in caches]),
                        "len": length}
    target = max(cache_len if cache_len is not None else s + 1024, s)
    if cfg.mla is not None:
        def grow(t):
            out = t.new_zeros((t.shape[0], target) + tuple(t.shape[2:]))
            out[:, :s] = t
            return out
        cache = {name: torch.stack([grow(c[name]) for c in caches])
                 for name in ("c_kv", "k_rope")}
        return logits, dict(cache, len=length)
    if cfg.family in ("dense", "vlm", "moe", "audio"):
        window = 0 if cfg.family == "audio" else _attn_kind(cfg, rt)[1]
        cache = _pack_kv([kv["k"] for kv in caches],
                         [kv["v"] for kv in caches], positions, window,
                         target)
        if cfg.family == "audio":
            for name in ("cross_k", "cross_v"):
                cache[name] = torch.stack([c[name] for c in caches])
        return logits, dict(cache, len=length)
    pat, w = cfg.rglru.block_pattern, cfg.rglru.local_window
    by_block = {}
    tail = []
    for (kind, _, (key, _)), c in zip(_hybrid_stack(params, cfg), caches):
        if key == "tail":
            tail.append(c if kind == "recurrent" else {
                k: v[0] for k, v in _pack_kv([c["k"]], [c["v"]], positions,
                                             w, target).items()})
        else:
            by_block.setdefault(key, []).append(c)
    groups = {}
    for i, kind in enumerate(pat):
        cs = by_block.get(f"b{i}", [])
        if not cs:                      # no whole group: empty stacks
            groups[f"b{i}"] = _empty_block_cache(cfg, kind, 0, b, w,
                                                 x.device)
        elif kind == "recurrent":
            groups[f"b{i}"] = {k: torch.stack([c[k] for c in cs])
                               for k in ("h", "conv")}
        else:
            groups[f"b{i}"] = _pack_kv([c["k"] for c in cs],
                                       [c["v"] for c in cs], positions, w,
                                       target)
    return logits, {"groups": groups, "tail": tail, "len": length}


# ======================================================================
# decode
def _empty_kv(cfg: ModelConfig, lead: tuple, length: int, dev) -> dict:
    shape = lead + (length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "v": torch.zeros(shape, dtype=_dtype(cfg), device=dev),
            "pos": torch.full(shape[:-2], _SENTINEL, dtype=torch.int32,
                              device=dev)}


def _empty_block_cache(cfg: ModelConfig, kind: str, n: Optional[int],
                       batch: int, length: int, dev) -> dict:
    """A hybrid block's empty cache, stacked over ``n`` groups (None: a
    tail block, unstacked)."""
    lead = (batch,) if n is None else (n, batch)
    if kind == "recurrent":
        st = rglru.init_rglru_state(batch, cfg, _dtype(cfg), device=dev)
        return {k: v.expand(*lead, *v.shape[1:]).contiguous()
                for k, v in st.items()}
    return _empty_kv(cfg, lead, length, dev)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None,
               *, rt: Optional[Runtime] = None) -> dict:
    """An empty decode cache for ``batch`` sequences (default ``cuda``), as
    ``prefill`` shapes it: for the dense, vlm and moe families a linear buffer
    of ``cache_len`` or, under a sliding window or a chunk, a ring of
    min(cache_len, its width) -- under ``cfg.mla`` zero latents ``c_kv``
    (L, batch, C, kv_lora_rank) and rope keys ``k_rope`` (L, batch, C,
    rope_head_dim), C as the reference reckons it --; for the ssm family
    zero states; for the hybrid family zero RG-LRU states and rings of
    min(cache_len, local_window); for the audio family the dense cache plus
    zero ``cross_k`` / ``cross_v`` (L, batch, encoder_seq_len, KV, dh)."""
    rt = _check_supported(cfg, rt)
    dev = resolve_device(device)
    if cfg.family == "ssm":
        st = ssm.init_mamba_state(batch, cfg, _dtype(cfg), device=dev)
        c = {k: v.expand(cfg.n_layers, *v.shape).contiguous()
             for k, v in st.items()}
    elif cfg.family == "hybrid":
        pat, n_groups, n_tail = _hybrid_shape(cfg)
        alen = min(cache_len, cfg.rglru.local_window)
        c = {"groups": {f"b{i}": _empty_block_cache(cfg, kind, n_groups,
                                                    batch, alen, dev)
                        for i, kind in enumerate(pat)},
             "tail": [_empty_block_cache(cfg, pat[j % len(pat)], None,
                                         batch, alen, dev)
                      for j in range(n_tail)]}
    else:
        window = _attn_kind(cfg, rt)[1]
        eff_len = min(cache_len, window) if window else cache_len
        if cfg.mla is not None:
            one = attn.init_mla_cache(batch, eff_len, cfg, _dtype(cfg), dev)
            c = {k: one[k].expand(cfg.n_layers, *one[k].shape).contiguous()
                 for k in ("c_kv", "k_rope")}
        else:
            c = _empty_kv(cfg, (cfg.n_layers, batch), eff_len, dev)
        if cfg.family == "audio":
            shape = (cfg.n_layers, batch, cfg.encoder_seq_len,
                     cfg.n_kv_heads, cfg.head_dim)
            for name in ("cross_k", "cross_v"):
                c[name] = torch.zeros(shape, dtype=_dtype(cfg), device=dev)
    c["len"] = torch.zeros((), dtype=torch.int32, device=dev)
    return c


def _block_cache(cache: dict, where: tuple) -> dict:
    """A hybrid block's cache views (slot axis first) in the pool."""
    key, j = where
    if key == "tail":
        return cache["tail"][j]
    return {k: v[j] for k, v in cache["groups"][key].items()}


def _decode_stack(params: dict, cache: dict, x: torch.Tensor,
                  cfg: ModelConfig, rt: Runtime, attend,
                  step_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The decoder stack over one new token a row, x (B, 1, d_model):
    ``attend(p, h, lc, kind, window)`` is the self-attention over the
    layer's cache views ``lc`` (it writes its K/V, or MLA's latent and
    rope key, in place); the ssm and RG-LRU states are written in place
    by ``_keep`` under ``step_mask``.  Returns the stream before the final
    norm."""
    def att_step(x, bp, lc, kind, window):
        h = rms_norm(x, bp["ln1"]["scale"], cfg.norm_eps)
        x = x + attend(bp["attn"], h, lc, kind, window)
        h, _ = _ffn(bp, rms_norm(x, bp["ln2"]["scale"], cfg.norm_eps), cfg)
        return x + h

    if cfg.family == "audio":
        for i, bp in enumerate(_layers(params["blocks"], cfg.n_layers)):
            lc = {n: cache[n][i] for n in ("k", "v", "pos")}
            h = rms_norm(x, bp["ln1"]["scale"], cfg.norm_eps)
            x = x + attend(bp["self_attn"], h, lc, "causal", 0)
            h = rms_norm(x, bp["ln2"]["scale"], cfg.norm_eps)
            x = x + attn.gqa_cross_decode(
                bp["cross_attn"], h, {"k": cache["cross_k"][i],
                                      "v": cache["cross_v"][i]}, cfg)
            h = rms_norm(x, bp["ln3"]["scale"], cfg.norm_eps)
            x = x + swiglu(bp["mlp"], h)
    elif cfg.family == "hybrid":
        for kind, bp, where in _hybrid_stack(params, cfg):
            st = _block_cache(cache, where)
            if kind != "recurrent":
                x = att_step(x, bp, st, "sliding", cfg.rglru.local_window)
                continue
            h = rms_norm(x, bp["ln1"]["scale"], cfg.norm_eps)
            y, new = rglru.rglru_decode(bp["mixer"], h, st, cfg)
            x = x + y
            h = rms_norm(x, bp["ln2"]["scale"], cfg.norm_eps)
            x = x + swiglu(bp["mlp"], h)
            _keep(st["h"], new["h"], step_mask)
            _keep(st["conv"], new["conv"], step_mask)
    else:
        kind, window = _attn_kind(cfg, rt)
        for i, bp in enumerate(_layers(params["blocks"], cfg.n_layers)):
            if cfg.family == "ssm":
                hs, cs = cache["h"][i], cache["conv"][i]
                h = rms_norm(x, bp["ln"]["scale"], cfg.norm_eps)
                h, new = ssm.mamba_decode(bp["mixer"], h,
                                          {"h": hs, "conv": cs}, cfg)
                x = x + h
                _keep(hs, new["h"], step_mask)
                _keep(cs, new["conv"], step_mask)
                continue
            names = ("c_kv", "k_rope") if cfg.mla is not None \
                else ("k", "v", "pos")
            x = att_step(x, bp, {n: cache[n][i] for n in names}, kind,
                         window)
    return x


def decode_step(params: dict, cache: dict, batch: dict, cfg: ModelConfig,
                *, rt: Optional[Runtime] = None) -> Tuple[torch.Tensor, dict]:
    """One new token for every sequence at ONE position, the cache's scalar
    ``len`` (an int32 tensor on the device, as ``prefill`` and
    ``init_cache`` give it; never read to the host).  batch:
    ``{'tokens': (B, 1)}``.  Attention goes through
    ``attention.gqa_decode`` (the decode kernel; the kind and window of
    ``_attn_kind``, sliding over the hybrid's rings) or, under
    ``cfg.mla``, ``attention.mla_decode`` (the ``mla_decode`` kernel,
    whose write at ``len >= C`` clamps to row C - 1 as the reference's
    does); the ssm family runs ``mamba_decode``, the hybrid RG-LRU blocks
    ``rglru_decode``, the audio family the sinusoid's row at ``len``,
    causal self-attention and ``gqa_cross_decode`` over ``cross_k`` /
    ``cross_v``.  The step writes into the cache's tensors IN PLACE (as
    ``decode_step_slots`` does): a caller that wants the old cache clones
    it first.  Returns logits (B, 1, V) and the cache's tensors with
    ``len + 1``."""
    rt = _check_supported(cfg, rt)
    pos = cache["len"]
    x = params["embed"][batch["tokens"].long()]
    if cfg.family == "audio":
        x = x + sinusoid_rows(pos, cfg.d_model).to(x.dtype)

    def attend(p, h, lc, kind, window):
        lc = dict(lc, len=pos)
        if cfg.mla is not None:
            return attn.mla_decode(p, h, lc, cfg)[0]
        return attn.gqa_decode(p, h, lc, cfg, kind=kind, window=window)[0]

    x = _decode_stack(params, cache, x, cfg, rt, attend, None)
    logits = _head(params, _final(params, x, cfg), cfg)
    return logits, dict(cache, len=pos + 1)


def decode_step_slots(params: dict, cache: dict, batch: dict,
                      cfg: ModelConfig, *, rt: Optional[Runtime] = None,
                      step_mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, dict]:
    """One new token per SLOT, each slot at its own position
    ``cache['len']`` (S,) int32.  batch: ``{'tokens': (S, 1)}``.

    ``step_mask`` (S,) bool freezes masked slots: their position does not
    advance.  Attention writes at a frozen position are idempotent, so
    K/V (or MLA's latent and rope key) are written for every slot, as in
    the JAX package.  A recurrent
    update is not idempotent: a masked slot's ssm or RG-LRU ``h`` and
    ``conv`` keep their bits (JAX's ``keep``), so a slot that resumes
    continues exactly (the audio family holds none).  The cache's
    K/V/pos, or h/conv, tensors are updated in place; the returned cache
    holds them and the new ``len``.  Returns logits (S, 1, V)."""
    rt = _check_supported(cfg, rt)
    x = params["embed"][batch["tokens"].long()]
    lens = cache["len"]
    if cfg.family == "audio":
        x = x + sinusoid_rows(lens, cfg.d_model).to(x.dtype)[:, None]

    def attend(p, h, lc, kind, window):
        lc = dict(lc, lens=lens)
        if cfg.mla is not None:
            return attn.mla_decode_slots(p, h, lc, cfg)[0]
        return attn.gqa_decode_slots(p, h, lc, cfg, kind=kind,
                                     window=window)[0]

    x = _decode_stack(params, cache, x, cfg, rt, attend, step_mask)
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


__all__ = ["Runtime", "init_params", "forward", "pooled", "prefill",
           "init_cache", "decode_step", "decode_step_slots"]
