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


__all__ = ["lap_uncertainty", "node_precision", "batched_precisions",
           "precision_weights"]
