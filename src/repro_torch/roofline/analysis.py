"""The analytic half of ``repro.roofline.analysis``: the bytes a decode
step must move and its memory-bound time, and model FLOPs, from the
config alone, with the H100's figures in place of v5e's.

Not ported: ``roofline_from_compiled`` and its HLO parser, which read
XLA's compiled text; the port has no such artifact.
"""
from __future__ import annotations

#: NVIDIA's published figures for the H100 SXM5 80 GB, the card that
#: ``nvidia-smi`` names "NVIDIA H100 80GB HBM3", at its 700 W limit:
#: dense bf16 tensor-core peak, HBM3 bandwidth, device memory, and
#: NVLink 4's 900 GB/s as the collective term.  Datasheet values, not
#: measurements; a card set below 700 W runs slower under load.
HW = {
    "peak_flops_bf16": 989e12,
    "hbm_bw": 3.35e12,
    "nvlink_bw": 900e9,
    "hbm_bytes": 80 * 2 ** 30,
}

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1,
    "f8e5m2": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}


def _bytes_of(cfg) -> int:
    return _DTYPE_BYTES.get({"float32": "f32", "bfloat16": "bf16",
                             "float16": "f16"}.get(cfg.dtype, cfg.dtype), 2)


def decode_cache_bytes_per_slot(cfg, cache_len: int) -> float:
    """Device bytes ONE slot's decode-state read costs per decode step.

    Attention families re-read the slot's whole KV window every token;
    recurrent families re-read a fixed-size state.  Matches the pool
    layout of ``serve.pool`` / ``models.transformer.init_cache``:

      GQA   : 2 * n_kv * head_dim * min(cache_len, window) per layer
      MLA   : (kv_lora_rank + rope_head_dim) * cache_len per layer
      SSM   : d_inner * (state_dim + conv_kernel) per layer
      hybrid: RG-LRU state for recurrent layers, SWA ring for attention
    """
    b = _bytes_of(cfg)
    d = cfg.d_model
    if cfg.family == "ssm":
        s = cfg.ssm
        d_in = s.expand * d
        return cfg.n_layers * d_in * (s.state_dim + s.conv_kernel) * b
    if cfg.family == "hybrid":
        r = cfg.rglru
        w = r.lru_width or d
        pat = r.block_pattern
        n_att = sum(1 for i in range(cfg.n_layers)
                    if pat[i % len(pat)] == "attention")
        n_rec = cfg.n_layers - n_att
        ring = min(cache_len, r.local_window)
        att = n_att * 2 * cfg.n_kv_heads * cfg.head_dim * ring
        rec = n_rec * w * (1 + r.conv_kernel)
        return (att + rec) * b
    if cfg.mla is not None:
        m = cfg.mla
        return cfg.n_layers * (m.kv_lora_rank + m.rope_head_dim) \
            * cache_len * b
    window = min(cache_len, cfg.sliding_window) if cfg.sliding_window \
        else cache_len
    return cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * window * b


def decode_roofline(cfg, *, n_slots: int, cache_len: int,
                    hw: dict = HW) -> dict:
    """Memory-bound prediction for a batched decode step: each step
    streams every (active) weight once -- amortised over the S slots --
    plus each slot's decode state, at ``hw["hbm_bw"]``.  Returns the
    predicted seconds a step, milliseconds a token and tokens/s at full
    occupancy."""
    param_bytes = cfg.active_param_count * _bytes_of(cfg)
    slot_bytes = decode_cache_bytes_per_slot(cfg, cache_len)
    step_bytes = param_bytes + n_slots * slot_bytes
    step_s = step_bytes / hw["hbm_bw"]
    return {
        "param_bytes": int(param_bytes),
        "cache_bytes_per_slot": int(slot_bytes),
        "step_bytes": int(step_bytes),
        "bytes_per_token": int(step_bytes / max(n_slots, 1)),
        "pred_step_s": step_s,
        "pred_ms_per_token": 1e3 * step_s / max(n_slots, 1),
        "pred_tokens_per_s": n_slots / step_s if step_s else float("inf"),
    }


def model_flops(cfg, shape, *, training: bool) -> float:
    """6 N D (dense) or 6 N_active D (MoE), D the tokens processed; a
    decode step processes ``global_batch`` tokens, one each.  The
    shape's ``kind`` decides, as in the reference (``training`` is taken
    and not read)."""
    n = cfg.active_param_count
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len    # fwd + bwd
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


__all__ = ["HW", "decode_cache_bytes_per_slot", "decode_roofline",
           "model_flops"]
