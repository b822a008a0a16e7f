"""The Mamba-1 selective SSM block (Falcon-Mamba): init, the full-sequence
forward with its final state, and the O(1) single-token decode.

Ports ``repro.models.ssm`` with the same parameter and state trees.  The
JAX forward runs the recurrence through ``_chunked_diag_scan``; here it is
the ``selective_scan`` kernel on a (B, S, d_inner * N) view of da and dbx
(its plain version on the CPU), so the chunk length ``cfg.ssm.chunk`` is
not read.  The decode step's recurrence is one elementwise update and
stays plain PyTorch, as in JAX.

One deliberate difference: the conv state always holds the last
conv_kernel - 1 inputs, zero rows first when the sequence is shorter.
The JAX forward keeps ``x_in[:, -(K-1):]``, fewer rows for a prompt
shorter than K - 1, which the serving pool then scatters over a slot's
stale rows; here a slot's decode equals the full-sequence forward.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.selective_scan import selective_scan
from repro_torch.models.common import linear, make_linear


def dt_rank(cfg: ModelConfig) -> int:
    return cfg.ssm.dt_rank or -(-cfg.d_model // 16)


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def make_mamba(gen: torch.Generator, cfg: ModelConfig, dtype, *, batch=(),
               device=None) -> dict:
    """The JAX package's distributions: S4D-real ``a_log`` = log(1..N),
    dt log-uniform in [1e-3, 1e-1] through ``dt_bias = log(expm1(dt))``,
    ``conv_w`` 0.1 N(0, 1), ``dt_proj`` scaled dt_rank^-0.5; ``a_log``,
    ``dt_bias`` and ``d_skip`` in float32.  ``batch`` is the leading
    stacked-layer shape, e.g. ``(L,)``."""
    s = cfg.ssm
    d, di, dtr, n = cfg.d_model, d_inner(cfg), dt_rank(cfg), s.state_dim
    kw = dict(batch=batch, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    a_init = torch.arange(1, n + 1, **f32).expand(*batch, di, n)
    u = torch.rand((*batch, di), generator=gen, **f32)
    lo, hi = math.log(0.001), math.log(0.1)
    dt_init = torch.exp(u * (hi - lo) + lo)
    conv_w = torch.randn((*batch, s.conv_kernel, di), generator=gen, **f32)
    return {
        "in_proj": make_linear(gen, d, 2 * di, dtype, **kw),
        "conv_w": (0.1 * conv_w).to(dtype),
        "conv_b": torch.zeros((*batch, di), dtype=dtype, device=device),
        "x_proj": make_linear(gen, di, dtr + 2 * n, dtype, **kw),
        "dt_proj": make_linear(gen, dtr, di, dtype, scale=dtr ** -0.5, **kw),
        "dt_bias": torch.log(torch.expm1(dt_init)),
        "a_log": torch.log(a_init),                  # A = -exp(a_log)
        "d_skip": torch.ones((*batch, di), **f32),
        "out_proj": make_linear(gen, di, d, dtype, **kw),
    }


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv in float32, cast back to x's dtype.
    x: (B, S, C); w: (K, C); b: (C,).  Output t is
    sum_k x[t - K + 1 + k] * w[k] + b, zero before the sequence."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, k - 1, 0))
    w32 = w.float()
    out = xp[:, 0:s] * w32[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w32[i]
    return (out + b.float()).to(x.dtype)


def mamba_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                  h0: Optional[torch.Tensor] = None,
                  conv0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, D) -> (y (B, S, D), state).  ``h0`` (B, d_inner, N) f32 and
    ``conv0`` (B, K - 1, d_inner) continue from an earlier call's state.
    The state is ``{"h": (B, d_inner, N) f32, "conv": (B, K - 1, d_inner)}``
    in x's dtype.  da, dbx and h_all are (B, S, d_inner, N) f32 each; da
    and dbx are freed before the output contraction."""
    b, s, _ = x.shape
    di, n, k = d_inner(cfg), cfg.ssm.state_dim, cfg.ssm.conv_kernel
    x_in, z = linear(x, p["in_proj"]).chunk(2, dim=-1)
    if conv0 is None:
        conv0 = x_in.new_zeros((b, k - 1, di))
    elif conv0.shape != (b, k - 1, di):
        raise ValueError(f"mamba_forward: conv0 must be {(b, k - 1, di)}; "
                         f"got {tuple(conv0.shape)}")
    x_cat = torch.cat([conv0.to(x_in.dtype), x_in], dim=1)
    x_conv = causal_conv1d(x_cat, p["conv_w"], p["conv_b"])[:, k - 1:]
    x_conv = F.silu(x_conv)

    dtr = dt_rank(cfg)
    dt_low, b_ssm, c_ssm = linear(x_conv, p["x_proj"]).split([dtr, n, n],
                                                             dim=-1)
    dt = F.softplus(linear(dt_low, p["dt_proj"]).float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])                             # (di, N)
    da = (dt[..., None] * a).exp_()                        # (B, S, di, N)
    dbx = (dt * x_conv.float())[..., None] * b_ssm.float()[..., None, :]
    if h0 is None:
        h0 = torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
    h_all, h_last = selective_scan(da.view(b, s, di * n),
                                   dbx.view(b, s, di * n),
                                   h0.reshape(b, di * n))
    del da, dbx
    y = torch.matmul(h_all.view(b, s, di, n),
                     c_ssm.float()[..., None])[..., 0]       # (B, S, di)
    del h_all
    y = y + p["d_skip"] * x_conv.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    state = {"h": h_last.view(b, di, n),
             "conv": x_cat[:, x_cat.shape[1] - (k - 1):]}
    return linear(y, p["out_proj"]), state


def init_mamba_state(batch: int, cfg: ModelConfig, dtype,
                     device=None) -> dict:
    s = cfg.ssm
    return {"h": torch.zeros((batch, d_inner(cfg), s.state_dim),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, s.conv_kernel - 1, d_inner(cfg)),
                                dtype=dtype, device=device)}


def mamba_decode(p: dict, x: torch.Tensor, state: dict,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, dict]:
    """Single-token decode.  x: (B, 1, D); O(1) state update.  Returns y
    (B, 1, D) and a new state; ``state`` is not written."""
    n, dtr = cfg.ssm.state_dim, dt_rank(cfg)
    x_in, z = linear(x, p["in_proj"]).chunk(2, dim=-1)    # (B, 1, di)
    conv_buf = torch.cat([state["conv"].to(x_in.dtype), x_in], dim=1)
    x_conv = (conv_buf.float() * p["conv_w"].float()[None]).sum(
        dim=1, keepdim=True) + p["conv_b"].float()
    x_conv = F.silu(x_conv).to(x.dtype)                    # (B, 1, di)

    dt_low, b_ssm, c_ssm = linear(x_conv, p["x_proj"]).split([dtr, n, n],
                                                             dim=-1)
    dt = F.softplus(linear(dt_low, p["dt_proj"]).float()
                    + p["dt_bias"])[:, 0]                  # (B, di)
    a = -torch.exp(p["a_log"])
    da = torch.exp(dt[..., None] * a)                      # (B, di, N)
    dbx = (dt * x_conv[:, 0].float())[..., None] \
        * b_ssm[:, 0].float()[:, None, :]
    h = da * state["h"] + dbx
    y = torch.matmul(h, c_ssm[:, 0].float()[..., None])[..., 0]
    y = y + p["d_skip"] * x_conv[:, 0].float()
    y = (y * F.silu(z[:, 0].float())).to(x.dtype)[:, None]
    return linear(y, p["out_proj"]), {"h": h, "conv": conv_buf[:, 1:]}


__all__ = ["dt_rank", "d_inner", "make_mamba", "causal_conv1d",
           "mamba_forward", "init_mamba_state", "mamba_decode"]
