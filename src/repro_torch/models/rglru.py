"""The RG-LRU recurrent block of the hybrid family (Griffin /
RecurrentGemma, arXiv:2402.19427): init, the full-sequence forward with its
final state, and the O(1) single-token decode.

Ports ``repro.models.rglru`` with the same parameter and state trees:

    r_t = sigmoid(W_a x_t)                 (recurrence gate)
    i_t = sigmoid(W_x x_t)                 (input gate)
    log a_t = -8 softplus(Lambda) r_t
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

The JAX forward runs the recurrence through ``_chunked_diag_scan``; here
it is the ``selective_scan`` kernel with da = a and dbx = the gated input,
both float32 (B, S, lru_width) (its plain version on the CPU), so
``cfg.rglru.chunk`` is not read.  The decode step's recurrence is one
elementwise update and stays plain PyTorch, as in JAX.  ``jax.nn.gelu``
is the tanh approximation, and so is the gate here.

As in ``models.ssm``, the conv state always holds the last conv_kernel - 1
recurrent-branch inputs, zero rows first when the sequence is shorter
(the JAX forward keeps fewer rows then).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.models.common import linear, make_linear
from repro_torch.models.ssm import causal_conv1d

_C = 8.0


def lru_width(cfg: ModelConfig) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def make_rglru_block(gen: torch.Generator, cfg: ModelConfig, dtype, *,
                     batch=(), device=None) -> dict:
    """The JAX package's distributions: ``lam`` (f32) so that the gate at
    r = 1, a = exp(-8 softplus(lam)), is uniform in [0.9^2, 0.999^2] (the
    paper's appendix), ``conv_w`` 0.1 N(0, 1), ``conv_b`` zero.  ``batch`` is a leading stacked shape, e.g. the hybrid's groups."""
    d, w = cfg.d_model, lru_width(cfg)
    kw = dict(batch=batch, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    u = torch.rand((*batch, w), generator=gen, **f32) \
        * (0.999 ** 2 - 0.9 ** 2) + 0.9 ** 2
    conv_w = torch.randn((*batch, cfg.rglru.conv_kernel, w), generator=gen,
                         **f32)
    return {
        "in_gate": make_linear(gen, d, w, dtype, **kw),     # gelu gate branch
        "in_rec": make_linear(gen, d, w, dtype, **kw),      # recurrent branch
        "conv_w": (0.1 * conv_w).to(dtype),
        "conv_b": torch.zeros((*batch, w), dtype=dtype, device=device),
        "w_a": make_linear(gen, w, w, dtype, **kw),         # recurrence gate
        "w_x": make_linear(gen, w, w, dtype, **kw),         # input gate
        "lam": torch.log(torch.expm1(-torch.log(u) / _C)),  # softplus^-1
        "out": make_linear(gen, w, d, dtype, **kw),
    }


def _gates(p: dict, xr: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """a and the gated input sqrt(1 - a^2) (i x), both f32, from the
    post-conv recurrent branch xr."""
    r = torch.sigmoid(linear(xr, p["w_a"]).float())
    i = torch.sigmoid(linear(xr, p["w_x"]).float())
    a = torch.exp(-_C * F.softplus(p["lam"]) * r)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xr.float())
    return a, gated


def _rglru_core(p: dict, xr: torch.Tensor,
                h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """xr: (B, S, w) post-conv recurrent branch -> (h_all, h_last) f32,
    through the scan kernel."""
    a, gated = _gates(p, xr)
    return selective_scan(a.contiguous(), gated.contiguous(), h0)


def rglru_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                  h0: Optional[torch.Tensor] = None,
                  conv0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (y (B, S, D), state).  ``h0`` (B, w) f32 and
    ``conv0`` (B, K - 1, w) continue from an earlier call's state.  The
    state is ``{"h": (B, w) f32, "conv": (B, K - 1, w)}`` in x's dtype."""
    b = x.shape[0]
    w, k = lru_width(cfg), cfg.rglru.conv_kernel
    gate = F.gelu(linear(x, p["in_gate"]), approximate="tanh")
    xr = linear(x, p["in_rec"])
    if conv0 is None:
        conv0 = xr.new_zeros((b, k - 1, w))
    elif conv0.shape != (b, k - 1, w):
        raise ValueError(f"rglru_forward: conv0 must be {(b, k - 1, w)}; "
                         f"got {tuple(conv0.shape)}")
    cat = torch.cat([conv0.to(xr.dtype), xr], dim=1)
    xr_c = causal_conv1d(cat, p["conv_w"], p["conv_b"])[:, k - 1:]
    if h0 is None:
        h0 = torch.zeros((b, w), dtype=torch.float32, device=x.device)
    h_all, h_last = _rglru_core(p, xr_c, h0)
    y = h_all.to(x.dtype) * gate
    state = {"h": h_last, "conv": cat[:, cat.shape[1] - (k - 1):]}
    return linear(y, p["out"]), state


def init_rglru_state(batch: int, cfg: ModelConfig, dtype,
                     device=None) -> dict:
    w = lru_width(cfg)
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.rglru.conv_kernel - 1, w),
                                dtype=dtype, device=device)}


def rglru_decode(p: dict, x: torch.Tensor, state: dict,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """Single-token decode.  x: (B, 1, D); O(1) state update.  Returns y
    (B, 1, D) and a new state; ``state`` is not written."""
    gate = F.gelu(linear(x, p["in_gate"]), approximate="tanh")  # (B, 1, w)
    xr = linear(x, p["in_rec"])
    conv_buf = torch.cat([state["conv"].to(xr.dtype), xr], dim=1)
    xr_c = (conv_buf.float() * p["conv_w"].float()[None]).sum(
        dim=1, keepdim=True) + p["conv_b"].float()
    xr_c = xr_c.to(x.dtype)
    a, gated = _gates(p, xr_c)
    h = a[:, 0] * state["h"] + gated[:, 0]
    y = h.to(x.dtype)[:, None] * gate
    return linear(y, p["out"]), {"h": h, "conv": conv_buf[:, 1:]}


__all__ = ["lru_width", "make_rglru_block", "rglru_forward",
           "init_rglru_state", "rglru_decode"]
