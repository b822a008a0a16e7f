"""Frozen per-modality tokenizer stubs (the paper's phi_m): the port of
``repro.data.tokenizers``.

A deterministic frozen random featurizer maps raw modality vectors to L
tokens of width d_m, keeping the latent class geometry (a smooth map of
the raw space).  Tokenizers are never trained and never shipped.  The
weights are drawn once, from a generator seeded by the seed and the
modality name (``synthetic.stream``), and kept as tensors: ``w1``, ``b1``
and ``w2``, which parity tests overwrite with the reference's.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.data.synthetic import stream


class FrozenTokenizer:
    """phi_m: raw (N, d_raw) -> tokens (N, L, d_m), in float32."""

    def __init__(self, modality: str, d_raw: int, n_tokens: int, d_out: int,
                 seed: int = 0, device=None):
        dev = resolve_device(device)
        self.d_out = d_out
        g = stream(dev, seed, "tokenizer", modality)
        self.w1 = torch.randn((d_raw, n_tokens, d_out), generator=g,
                              device=dev) * d_raw ** -0.5
        self.b1 = 0.1 * torch.randn((n_tokens, d_out), generator=g,
                                    device=dev)
        self.w2 = torch.randn((d_out, d_out), generator=g,
                              device=dev) * d_out ** -0.5

    def __call__(self, raw: torch.Tensor) -> torch.Tensor:
        h = torch.einsum("nd,dlo->nlo", raw.float(), self.w1) + self.b1
        return torch.tanh(h) @ self.w2

    def padded_weights(self, width: int):
        """(w1, b1, w2) zero-padded to token width ``width`` >= d_out, for
        the node-stacked round (one program over tokenizers of several
        widths).  The padding is exact: padded channels see 0 through tanh
        and padded rows and columns of w2 add 0, so the first d_out
        channels match the unpadded tokenizer and the rest are 0."""
        pad = width - self.d_out
        if pad < 0:
            raise ValueError(f"width {width} < d_out {self.d_out}")
        f = torch.nn.functional.pad
        return (f(self.w1, (0, pad)), f(self.b1, (0, pad)),
                f(self.w2, (0, pad, 0, pad)))


def default_tokenizers(modality_dims: dict, d_raw: int, n_tokens: int = 16,
                       seed: int = 0, device=None) -> dict:
    """One frozen tokenizer per modality at its published embedding width
    (``configs.fedmm_base.MODALITY_TOKENIZER_DIMS``)."""
    return {m: FrozenTokenizer(m, d_raw, n_tokens, d, seed=seed,
                               device=device)
            for m, d in modality_dims.items()}


__all__ = ["FrozenTokenizer", "default_tokenizers"]
