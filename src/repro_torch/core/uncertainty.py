"""Latent anchor-proximity (LAP) uncertainty and precision weights (paper
Eq. 6): the port of ``repro.core.uncertainty``.

u(x) = 0.5 (1 - max_j cos(Pool(z_x), Pool(z_aj))) is near 1 for a sample
far from every public anchor.  A node's precision is its mean 1 / u; the
server normalises the precisions into aggregation weights.
"""
from __future__ import annotations

import torch


def _unit_rows(z: torch.Tensor, eps: float) -> torch.Tensor:
    z = z.float()
    return z / torch.sqrt((z * z).sum(-1, keepdim=True).clamp_min(eps))


def lap_uncertainty(pooled_samples: torch.Tensor,
                    pooled_anchors: torch.Tensor,
                    eps: float = 1e-8) -> torch.Tensor:
    """(N, D), (B, D) -> (N,) uncertainties in [0, 1]."""
    sim = _unit_rows(pooled_samples, eps) @ _unit_rows(pooled_anchors, eps).T
    return 0.5 * (1.0 - sim.max(dim=-1).values)


def node_precision(uncertainties: torch.Tensor,
                   floor: float = 1e-3) -> torch.Tensor:
    """Unnormalised p_k = mean_i 1 / u(x_i) over one node's samples."""
    return (1.0 / uncertainties.clamp_min(floor)).mean()


def batched_precisions(pooled_samples: torch.Tensor,
                       pooled_anchors: torch.Tensor) -> torch.Tensor:
    """Node-stacked precisions: (K, N, D), (K, B, D) -> (K,) unnormalised
    p_k, what the round engine uploads (``node_precision`` of
    ``lap_uncertainty`` per node)."""
    sim = _unit_rows(pooled_samples, 1e-8) @ _unit_rows(
        pooled_anchors, 1e-8).transpose(-1, -2)
    u = 0.5 * (1.0 - sim.max(dim=-1).values)
    return (1.0 / u.clamp_min(1e-3)).mean(dim=-1)


def precision_weights(node_precisions: torch.Tensor) -> torch.Tensor:
    """Server: per-node precisions -> aggregation weights summing to 1."""
    p = node_precisions.float().clamp_min(0.0)
    return p / p.sum().clamp_min(1e-12)


def masked_precision_weights(node_precisions: torch.Tensor,
                             mask: torch.Tensor) -> torch.Tensor:
    """Partial participation: only REPORTING nodes (``mask`` (K,) 0/1)
    contribute their precision and the normalisation runs over them, so
    non-reporters get exactly zero weight.  ``precision_weights`` under a
    full mask."""
    p = node_precisions.float().clamp_min(0.0) * mask.float()
    return p / p.sum().clamp_min(1e-12)


def staleness_factor(lag: torch.Tensor, schedule: str = "poly",
                     alpha: float = 1.0,
                     max_staleness: int = None) -> torch.Tensor:
    """FedBuff-style staleness discount f(lag) in [0, 1] for reports that
    arrive ``lag`` rounds after they were computed: ``poly`` (1 +
    lag)^-alpha, or ``cutoff`` 1 while lag <= ``max_staleness`` (which it
    needs) else 0.  Under ``poly``, ``max_staleness`` also gates the
    factor to zero past the bound.  Elementwise over (K,) int lags."""
    lag = lag.float().clamp_min(0.0)
    if schedule == "poly":
        f = torch.pow(1.0 + lag, -float(alpha))
    elif schedule == "cutoff":
        if max_staleness is None:
            raise ValueError("staleness schedule 'cutoff' needs a "
                             "max_staleness bound")
        f = torch.ones_like(lag)
    else:
        raise ValueError(f"unknown staleness schedule {schedule!r}")
    if max_staleness is not None:
        f = f * (lag <= float(max_staleness)).float()
    return f


def stale_precision_weights(node_precisions: torch.Tensor,
                            lag: torch.Tensor, mask: torch.Tensor,
                            schedule: str = "poly", alpha: float = 1.0,
                            max_staleness: int = None) -> torch.Tensor:
    """The async server step's weights: p_k f(lag_k) over the DELIVERED
    reports (``mask`` (K,) 0/1), normalised over them.  All zero when
    nothing is delivered (or everything staled out): the caller keeps the
    previous global value.  ``masked_precision_weights`` at lag 0."""
    f = staleness_factor(lag, schedule, alpha, max_staleness)
    p = node_precisions.float().clamp_min(0.0) * mask.float() * f
    s = p.sum()
    return torch.where(s > 0.0, p / s.clamp_min(1e-12),
                       torch.zeros_like(p))


__all__ = ["lap_uncertainty", "node_precision", "batched_precisions",
           "precision_weights", "masked_precision_weights",
           "staleness_factor", "stale_precision_weights"]
