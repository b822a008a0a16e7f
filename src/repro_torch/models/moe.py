"""Mixture-of-Experts FFN: capacity routing over the routed experts, plus
the shared (always-on) experts as one SwiGLU.

Ports ``_capacity``, ``make_moe``, ``router_scores``, ``_expert_block``
and ``moe_ffn`` from ``repro.models.moe`` without a mesh: expert
parallelism comes with the mesh slice, so a ``mesh=`` or ``ep_axis=``
argument raises ``NotImplementedError``.  The parameter tree is the JAX
package's: ``router.w`` (d, E) in float32 whatever the model dtype,
``experts.{gate,up,down}.w`` stacked on the expert axis, ``shared`` a
SwiGLU of width d_ff_expert x num_shared_experts.

The reference's numerics, step for step:

- the router runs in float32: logits ``x.float() @ w``, softmax, the top
  k, their renormalisation and the dense (T, E) combine matrix;
- each expert e takes the ``capacity`` tokens of highest combine score in
  its column.  Ties are broken by the lower token index, as ``lax.top_k``
  breaks them (``torch.topk`` does not promise an order), so at top-1,
  where every routed score is exactly 1.0, an expert over capacity keeps
  its first tokens.  Selection is a stable descending sort, here and in
  the router;
- the expert runs in x's dtype, ``silu(xg @ wg) * (xg @ wu) @ wd`` times
  the score, and is added into the output at its tokens (distinct within
  one expert, so the add is deterministic), expert by expert in order;
  tokens with a zero score that fill an expert's capacity are computed
  too and add an exact 0;
- the shared experts' SwiGLU is added last.

Shapes stay static -- the capacity is a Python int of T, and nothing reads
a tensor back to the host -- so the decode step that calls this can be
captured in a CUDA graph.  The expert products are ``torch.matmul``: the
JAX package computes them with plain ``jnp`` products, outside any Pallas
kernel.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import make_swiglu, swiglu


def _capacity(t: int, top_k: int, n_experts: int, factor: float) -> int:
    """Per-expert token capacity. The standard formula, floored so tiny
    token counts (decode steps) never drop tokens."""
    cap = int(math.ceil(t * top_k / n_experts * factor))
    return min(t, max(cap, 8))


def _normal(gen: torch.Generator, shape, scale: float, dtype,
            device) -> torch.Tensor:
    """``scale`` times a standard normal, drawn in f32 one matrix (the
    last two axes) at a time and cast into a tensor of ``dtype``: a
    stacked expert leaf never exists in f32 whole (Scout's 12-layer
    leaf would take 32 GB)."""
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    for mat in out.view(-1, *shape[-2:]):
        mat.copy_(torch.randn(tuple(shape[-2:]), generator=gen,
                              device=device).mul_(scale))
    return out


def make_moe(gen: torch.Generator, cfg: ModelConfig, dtype, *, batch=(),
             device=None) -> dict:
    """The MoE FFN's parameters; ``batch`` is the leading stacked-layer
    shape.  The router is kept in float32, as in the reference."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    p = {
        "router": {"w": _normal(gen, (*batch, d, e), d ** -0.5,
                                torch.float32, device)},
        "experts": {
            "gate": {"w": _normal(gen, (*batch, e, d, f), d ** -0.5, dtype,
                                  device)},
            "up": {"w": _normal(gen, (*batch, e, d, f), d ** -0.5, dtype,
                                device)},
            "down": {"w": _normal(gen, (*batch, e, f, d), f ** -0.5, dtype,
                                  device)},
        },
    }
    if m.num_shared_experts:
        p["shared"] = make_swiglu(gen, d, f * m.num_shared_experts, dtype,
                                  batch=batch, device=device)
    return p


def _top(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest values of the last axis and their indices, equal
    values by lower index first (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_scores(p: dict, x: torch.Tensor, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """Routing in float32: the dense per-expert combine scores (B, S, E),
    the chosen experts (B, S, k) and the aux values ``load_balance``
    (Switch-style) and ``router_z``."""
    m = cfg.moe
    logits = x.float() @ p["router"]["w"].float()                # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top(probs, m.top_k)                   # (B, S, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(
        1e-9)                                                    # renormalise
    experts = torch.arange(m.num_experts, device=x.device)
    onehot = (gate_idx[..., None] == experts).float()            # (B, S, k, E)
    scores = (gate_vals[..., None] * onehot).sum(dim=-2)         # (B, S, E)
    frac_tokens = onehot.sum(dim=-2).mean(dim=(0, 1)) / m.top_k  # (E,)
    mean_prob = probs.mean(dim=(0, 1))
    aux = {
        "load_balance": m.num_experts * (frac_tokens * mean_prob).sum(),
        "router_z": (torch.logsumexp(logits, dim=-1) ** 2).mean(),
    }
    return scores, gate_idx, aux


def _expert_block(weights: dict, x_flat: torch.Tensor, scores: torch.Tensor,
                  capacity: int) -> torch.Tensor:
    """Every expert over its ``capacity`` highest-scoring tokens.
    weights leaves (E, ...); x_flat (T, D); scores (T, E) float32.
    Returns the combined (T, D) in x's dtype."""
    y = torch.zeros_like(x_flat)
    for e in range(scores.shape[1]):
        top_s, top_idx = _top(scores[:, e], capacity)            # (C,)
        xg = x_flat[top_idx]                                     # (C, D)
        wg, wu, wd = (weights[n]["w"][e].to(x_flat.dtype)
                      for n in ("gate", "up", "down"))
        h = F.silu(xg @ wg) * (xg @ wu)
        y.index_add_(0, top_idx, (h @ wd) * top_s[:, None].to(x_flat.dtype))
    return y


def moe_ffn(p: dict, x: torch.Tensor, cfg: ModelConfig, *, mesh=None,
            ep_axis: Optional[str] = None, batch_axes: Tuple[str, ...] = ()
            ) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (B, S, D) and the aux values; the B x S tokens are
    routed together, as in the reference without a mesh."""
    if mesh is not None or ep_axis is not None:
        raise NotImplementedError(
            "moe_ffn: expert parallelism over a mesh comes with the mesh "
            "slice; the port runs every expert on one device")
    m = cfg.moe
    b, s, d = x.shape
    scores, _, aux = router_scores(p, x, cfg)
    t = b * s
    capacity = _capacity(t, m.top_k, m.num_experts, m.capacity_factor)
    y = _expert_block(p["experts"], x.reshape(t, d),
                      scores.reshape(t, -1), capacity).reshape(b, s, d)
    if "shared" in p:
        y = y + swiglu(p["shared"], x)
    return y, aux


__all__ = ["make_moe", "router_scores", "moe_ffn"]
