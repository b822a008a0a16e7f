"""Gram matrices and kernel alignment (paper Eqs. 1-2): the port of
``repro.core.cka``.

Each node pools its anchor activations, forms the B x B cosine Gram
(Eq. 1) and minimises 1 - CKA(G_k, G_bar) against the server's consensus
(Eq. 2); only Grams cross the wire.  ``cosine_gram`` runs the ``gram``
kernel on the card (differentiable); CKA is the paper's uncentered
tr(X Y^T) / (|X|_F |Y|_F), with Kornblith's double centring under
``center=True``.
"""
from __future__ import annotations

import torch

# Eq. 1: (B, D) -> (B, B), or (K, B, D) -> (K, B, B), in float32
from repro_torch.kernels.gram import cosine_gram


def _center(g: torch.Tensor) -> torch.Tensor:
    n = g.shape[-1]
    h = torch.eye(n, dtype=g.dtype, device=g.device) - 1.0 / n
    return h @ g @ h


def cka(gx: torch.Tensor, gy: torch.Tensor, *, center: bool = False,
        eps: float = 1e-12) -> torch.Tensor:
    """Eq. 2: CKA(X, Y) = tr(X Y^T) / (||X||_F ||Y||_F), over the last two
    axes (a stack of K Grams gives K values)."""
    gx, gy = gx.float(), gy.float()
    if center:
        gx, gy = _center(gx), _center(gy)
    dims = (-2, -1)
    num = (gx * gy).sum(dims)
    den = torch.sqrt((gx * gx).sum(dims).clamp_min(eps)) * \
        torch.sqrt((gy * gy).sum(dims).clamp_min(eps))
    return num / den.clamp_min(eps)


def geo_alignment_loss(pooled_anchors: torch.Tensor,
                       consensus_gram: torch.Tensor, *,
                       center: bool = False) -> torch.Tensor:
    """Eq. 3's regulariser 1 - CKA(G_k, G_bar); the consensus is a
    constant (detached).  Anchors (K, B, D) of K nodes give K losses."""
    return 1.0 - cka(cosine_gram(pooled_anchors), consensus_gram.detach(),
                     center=center)


def consensus_gram(node_grams: torch.Tensor, mask: torch.Tensor = None,
                   fallback: torch.Tensor = None) -> torch.Tensor:
    """Server: G_bar = mean_k G_k over (K, B, B).  With a participation
    ``mask`` (K,) the mean runs over the REPORTING nodes only (Eq. 2 over
    whichever nodes upload this round); ``fallback`` (B, B) is returned
    when the mask selects none (an async round with no fresh-enough
    delivery keeps the previous consensus).  No branch on a value: the
    captured round runs it."""
    if mask is None:
        return node_grams.mean(dim=0)
    m = mask.float()
    num = (m[:, None, None] * node_grams.float()).sum(dim=0)
    mean = num / m.sum().clamp_min(1.0)
    if fallback is None:
        return mean
    return torch.where(m.sum() > 0.0, mean, fallback.float())


def pairwise_cka(grams: torch.Tensor, *, center: bool = False,
                 eps: float = 1e-12) -> torch.Tensor:
    """(K, B, B) -> (K, K) CKA between every pair of node geometries."""
    g = grams.float()
    if center:
        g = _center(g)
    num = torch.einsum("aij,bij->ab", g, g)
    norms = torch.sqrt((g * g).sum(dim=(-1, -2)).clamp_min(eps))
    return num / (norms[:, None] * norms[None, :]).clamp_min(eps)


def mean_offdiag_cka(grams: torch.Tensor, *, center: bool = False,
                     mask: torch.Tensor = None) -> torch.Tensor:
    """Mean off-diagonal pairwise CKA: the round's cross-modality
    alignment metric.  With a participation ``mask`` (K,) only pairs of
    REPORTING nodes count (0.0 when fewer than two report)."""
    k = grams.shape[0]
    pair = pairwise_cka(grams, center=center)
    if mask is None:
        return (pair.sum() - torch.trace(pair)) / max(k * (k - 1), 1)
    m = mask.float()
    w = m[:, None] * m[None, :] * (1.0 - torch.eye(k, dtype=torch.float32,
                                                   device=m.device))
    return (pair * w).sum() / w.sum().clamp_min(1.0)


__all__ = ["cosine_gram", "cka", "geo_alignment_loss", "consensus_gram",
           "pairwise_cka", "mean_offdiag_cka"]
