"""Shared building blocks: norms, RoPE, linear (with the GeoLoRA /
GeoDoRA side-cars), SwiGLU MLP, the loss and the pool.

Also the audio family's sinusoidal positions (``sinusoidal_positions``,
and ``sinusoid_rows`` at given positions for the decode step).

Parameters are plain nested dicts of tensors, as in ``repro.models.common``:
every linear is ``{"w": (d_in, d_out)[, "lora_A": (d_in, r), "lora_B":
(r, d_out)[, "dora_m": (d_out,)]]}``.  A linear with side-cars runs the
fused ``lora_matmul`` kernel (``lora_A`` and ``w`` frozen); the GeoDoRA
rescale by ``dora_m / ||W + A B||_col`` stays outside the kernel, as in the
JAX package.

Node-stacked leaves (the round engine's): a per-node leaf carries a
leading node axis K -- ``w`` (K, d_in, d_out), ``lora_B`` (K, r, d_out),
``dora_m`` (K, d_out), a norm's ``scale`` (K, d) -- and x then holds K
node-major groups of rows (leading axis K, or K groups of a flattened
leading axis).  Frozen leaves stay shared.  A linear may also carry the
GeoDoRA norm's W-only terms, precomputed once (``dora_w_terms``): W and A
are frozen and shared, so only the B-terms change from call to call.  Other matrix products run as ``torch.matmul`` in the model
dtype (the JAX package leaves them to XLA); norms and RoPE compute in
float32 and cast back.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.lora_matmul import lora_matmul


def truncated_normal_init(gen: torch.Generator, shape, scale: float = 0.02,
                          dtype=torch.float32, device=None) -> torch.Tensor:
    """``scale`` times a standard normal truncated to [-2, 2], drawn in f32
    from ``gen`` (on ``device``) and cast to ``dtype``."""
    t = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(scale).to(dtype)          # in place: one f32 copy at most


def make_linear(gen: torch.Generator, d_in: int, d_out: int, dtype,
                scale: Optional[float] = None, *, batch=(), device=None) -> dict:
    """``batch`` is the leading stacked-layer shape, e.g. ``(L,)``."""
    scale = scale if scale is not None else d_in ** -0.5
    return {"w": truncated_normal_init(gen, (*batch, d_in, d_out), scale,
                                       dtype, device)}


def add_lora(gen: torch.Generator, lin: dict, rank: int, dtype,
             a_std: float = 1.0) -> dict:
    """Attach GeoLoRA side-cars: ``lora_A`` Gaussian and frozen (shared by
    every node, paper Eq. 4), ``lora_B`` zero.  Stacked leading dims of
    ``w`` carry over."""
    d_in, d_out = lin["w"].shape[-2:]
    batch = tuple(lin["w"].shape[:-2])
    dev = lin["w"].device
    a = torch.randn((*batch, d_in, rank), generator=gen, device=dev)
    return dict(lin, lora_A=(a_std * rank ** -0.5 * a).to(dtype),
                lora_B=torch.zeros((*batch, rank, d_out), dtype=dtype,
                                   device=dev))


def add_dora(lin: dict) -> dict:
    """Attach the GeoDoRA magnitude, initialised to W's column norms."""
    w = lin["w"].float()
    return dict(lin, dora_m=torch.sqrt((w * w).sum(-2)).to(lin["w"].dtype))


DORA_TERMS = ("dora_wsq", "dora_wta", "dora_ata")


def dora_w_terms(w: torch.Tensor, a: torch.Tensor) -> dict:
    """The W-only terms of ``dora_column_norm`` in float32: ||W_j||^2
    (d_out,), W^T A (d_out, r) and A^T A (r, r), keyed by ``DORA_TERMS``
    (leading stacked axes carry over)."""
    w32, a32 = w.float(), a.float()
    return {"dora_wsq": (w32 * w32).sum(-2),
            "dora_wta": torch.einsum("...ij,...ir->...jr", w32, a32),
            "dora_ata": torch.einsum("...ir,...is->...rs", a32, a32)}


def dora_column_norm(w: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     eps: float = 1e-6, terms: Optional[dict] = None
                     ) -> torch.Tensor:
    """||W + A B||_col in float32 without forming A B:
    ||col_j||^2 = ||W_j||^2 + 2 (W^T A B)_jj + (B^T (A^T A) B)_jj.
    ``terms``: the W-only terms from ``dora_w_terms`` (else computed here);
    b (K, r, d_out) gives K norms."""
    terms = terms or dora_w_terms(w, a)
    b32 = b.float()
    cross = torch.einsum("...jr,...rj->...j", terms["dora_wta"], b32)
    bsq = torch.einsum("...rj,...rs,...sj->...j", b32, terms["dora_ata"],
                       b32)
    return torch.sqrt((terms["dora_wsq"] + 2.0 * cross + bsq).clamp_min(eps))


def _by_node(x: torch.Tensor, nodes: int) -> torch.Tensor:
    """x's rows as (nodes, rows per node, d): x's leading axes hold the
    nodes' rows node-major."""
    return x.reshape(nodes, -1, x.shape[-1])


def linear(x: torch.Tensor, lin: dict) -> torch.Tensor:
    """y = x @ W in x's dtype; with side-cars y = x @ W + (x @ A) @ B
    through the ``lora_matmul`` kernel, then under GeoDoRA
    y * dora_m / ||W + A B||_col.  The norm sees W and A detached and B
    live, so B's gradient also flows through it.  Per-node leaves (a
    leading node axis, see the module docstring) run one launch for all
    nodes."""
    w = lin["w"].to(x.dtype)
    lead, d_out = x.shape[:-1], w.shape[-1]
    if "lora_A" not in lin:
        if "dora_m" in lin:
            raise ValueError("linear: dora_m without lora_A / lora_B")
        if w.dim() == 3:                                 # per node
            return (_by_node(x, w.shape[0]) @ w).reshape(*lead, d_out)
        return x @ w
    a = lin["lora_A"].detach().to(x.dtype)
    b = lin["lora_B"].to(x.dtype)
    nodes = b.shape[0] if b.dim() == 3 else 0
    rows = (_by_node(x, nodes) if nodes else x.reshape(-1, x.shape[-1]))
    y = lora_matmul(rows.contiguous(), w, a, b)
    if "dora_m" in lin:
        terms = ({k: lin[k] for k in DORA_TERMS} if DORA_TERMS[0] in lin
                 else None)
        norm = dora_column_norm(w.detach(), a, b, terms=terms).to(x.dtype)
        scale = lin["dora_m"].to(x.dtype) / norm
        y = y * (scale[:, None] if nodes else scale)
    return y.reshape(*lead, d_out)


# ----------------------------------------------------------------------
def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """weight (d,), or (K, d) per node with x's rows node-major."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    if weight.dim() == 2:                                # per node
        nodes = weight.shape[0]
        return (_by_node(y, nodes) * weight.float()[:, None]).reshape(
            x.shape).to(x.dtype)
    return (y * weight.float()).to(x.dtype)


def make_rms_norm(d: int, dtype=torch.float32, *, batch=(),
                  device=None) -> dict:
    return {"scale": torch.ones((*batch, d), dtype=dtype, device=device)}


# ----------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return theta ** (-exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, d_head); positions: (..., S) integer."""
    if theta <= 0:
        return x
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                 # (d/2,)
    angles = positions[..., :, None].float() * freqs             # (..., S, d/2)
    cos = torch.cos(angles)[..., :, None, :]                     # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoid_rows(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings of ``positions`` (any shape,
    integer) -> (*positions.shape, d_model) float32: row p is the
    reference table's row p (``sin`` at the even columns, ``cos`` at the
    odd), computed where it is needed, so a decode step at position p
    reads no table and no position runs past one."""
    dev = positions.device           # no host copy: a CUDA graph captures it
    div = torch.exp(-torch.full((), 10000.0, device=dev).log()
                    * torch.arange(0, d_model, 2, dtype=torch.float32,
                                   device=dev) / d_model)
    ang = positions.float()[..., None] * div
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(
        *positions.shape, d_model)


def sinusoidal_positions(seq_len: int, d_model: int,
                         device=None) -> torch.Tensor:
    """The reference's (seq_len, d_model) float32 table."""
    return sinusoid_rows(torch.arange(seq_len, device=device), d_model)


# ----------------------------------------------------------------------
def make_swiglu(gen: torch.Generator, d_model: int, d_ff: int, dtype, *,
                batch=(), device=None) -> dict:
    kw = dict(batch=batch, device=device)
    return {
        "gate": make_linear(gen, d_model, d_ff, dtype, **kw),
        "up": make_linear(gen, d_model, d_ff, dtype, **kw),
        "down": make_linear(gen, d_ff, d_model, dtype, **kw),
    }


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    g = linear(x, params["gate"])
    u = linear(x, params["up"])
    return linear(F.silu(g) * u, params["down"])


# ----------------------------------------------------------------------
def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy in float32.  logits (..., V); labels (...,)."""
    logits32 = logits.float()
    gold = logits32.gather(-1, labels.long()[..., None])[..., 0]
    return (torch.logsumexp(logits32, dim=-1) - gold).mean()


def mean_pool(x: torch.Tensor) -> torch.Tensor:
    """The paper's Pool(): mean over the token axis -> (..., d_model)."""
    return x.mean(dim=-2)


__all__ = ["truncated_normal_init", "make_linear", "add_lora", "add_dora",
           "DORA_TERMS", "dora_w_terms", "dora_column_norm", "linear", "rms_norm", "make_rms_norm",
           "rope_frequencies", "apply_rope", "sinusoid_rows",
           "sinusoidal_positions", "make_swiglu", "swiglu",
           "cross_entropy_loss", "mean_pool"]
