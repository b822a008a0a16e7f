"""Synthetic unpaired multimodal task with a shared latent concept space:
the port of ``repro.data.synthetic.SyntheticMultimodal``.

``n_classes`` concepts are prototypes in a latent space; a sample of class
c in modality m is an independent draw around prototype c pushed through
a fixed map of that modality.  Nodes hold one modality each and never
share samples; the public anchor set holds a few unpaired draws per class
per modality.  A ``corrupt`` node's data is latent-free noise.

The math is the JAX package's; the random numbers are not.  JAX's
threefry streams and its ``hash()``-seeded modality maps cannot be
reproduced, so every stream here is a ``torch.Generator`` on the task's
device, seeded from the task seed and a stable digest of names
(``stream``).  Parity tests carry the reference's prototypes, maps and
draws across instead of re-seeding.

``sample_stacked`` is the node-stacked round's draw, the counterpart of
the reference's ``sample_in_scan``.  The reference draws inside its
compiled round from carried JAX keys, which torch cannot reproduce.  Here
the draws are staged instead: E steps x k nodes are drawn on the device
before the round, each node from its own generator in the order the
sequential round's ``_draw`` calls it, and the round (a CUDA graph on the
card) reads them from its input buffers.  Drawing inside the graph
(``CUDAGraph.register_generator_state``) was the other way.  Staging was
chosen because it keeps one draw code for both rounds and both devices,
so the stacked and the sequential round see bit-identical batches on the
CPU and on the card, and a parity test can hand either the reference's
draws; a generator registered with a graph advances by the graph's
whole offset at each replay, which only the card can test.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Optional, Tuple

import torch

from repro_torch import resolve_device


def stream(device, seed: int, *names) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` and ``names`` through
    SHA-256, the same in every process (unlike Python's ``hash()``)."""
    key = "/".join(str(p) for p in (seed, *names)).encode()
    digest = int.from_bytes(hashlib.sha256(key).digest()[:8], "little")
    return torch.Generator(device=device).manual_seed(digest % 2 ** 63)


class SyntheticMultimodal:
    def __init__(self, n_classes: int = 8,
                 modalities: Tuple[str, ...] = ("image", "text", "genetics",
                                                "tabular"), *,
                 d_latent: int = 32, d_raw: int = 64, noise: float = 0.25,
                 seed: int = 0, device=None):
        dev = resolve_device(device)
        self.n_classes, self.modalities = n_classes, tuple(modalities)
        self.d_latent, self.d_raw, self.noise = d_latent, d_raw, noise
        self.prototypes = torch.randn((n_classes, d_latent), device=dev,
                                      generator=stream(dev, seed, "protos"))
        #: fixed modality maps (w (d_latent, d_raw), b (d_raw,))
        self.maps: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
        for m in self.modalities:
            g = stream(dev, seed, "modality", m)
            w = torch.randn((d_latent, d_raw), generator=g, device=dev)
            b = torch.randn((d_raw,), generator=g, device=dev)
            self.maps[m] = (w * d_latent ** -0.5, 0.3 * b)

    def _view(self, latent: torch.Tensor, modality: str,
              out_noise: torch.Tensor) -> torch.Tensor:
        w, b = self.maps[modality]
        return torch.tanh(latent @ w + b) + out_noise

    def sample(self, gen: torch.Generator, modality: str, n: int, *,
               corrupt: bool = False, paired: Optional[str] = None):
        """-> raw (n, d_raw), labels (n,), raw2.  ``corrupt`` draws pure
        noise with random labels.  With ``paired`` (a bridge node's second
        modality) raw2 is the same clean latent and output-noise draws
        pushed through that modality's map (else None)."""
        dev = self.prototypes.device
        labels = torch.randint(0, self.n_classes, (n,), generator=gen,
                               device=dev)
        latent = self.prototypes[labels] + self.noise * torch.randn(
            (n, self.d_latent), generator=gen, device=dev)
        out_noise = 0.05 * torch.randn((n, self.d_raw), generator=gen,
                                       device=dev)
        raw2 = None if paired is None else self._view(latent, paired,
                                                      out_noise)
        if corrupt:
            raw = torch.randn((n, self.d_raw), generator=gen, device=dev)
            labels = torch.randint(0, self.n_classes, (n,), generator=gen,
                                   device=dev)
            return raw, labels, raw2
        return self._view(latent, modality, out_noise), labels, raw2

    def sample_stacked(self, gens, modalities, n: int, steps: int, *,
                       corrupt, paired) -> dict:
        """``steps`` batches for each of k nodes: node j draws ``steps``
        consecutive ``sample`` calls from ``gens[j]`` in its modality
        ``modalities[j]``, with ``corrupt[j]`` and ``paired[j]`` (its second
        modality or None).  Returns ``{"raw": (steps, k, n, d_raw),
        "labels": (steps, k, n)}`` and, when any node is paired, ``"raw2"``,
        holding the node's own raw where it is not."""
        draws = [[self.sample(g, m, n, corrupt=c, paired=p)
                  for _ in range(steps)]
                 for g, m, c, p in zip(gens, modalities, corrupt, paired)]
        out = {"raw": torch.stack([torch.stack([d[0] for d in node])
                                   for node in draws], 1),
               "labels": torch.stack([torch.stack([d[1] for d in node])
                                      for node in draws], 1)}
        if any(p is not None for p in paired):
            out["raw2"] = torch.stack([torch.stack([
                d[0] if d[2] is None else d[2] for d in node])
                for node in draws], 1)
        return out

    def anchor_set(self, gen: torch.Generator, n_per_class: int = 4
                   ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """Public anchors: for each modality, ``n_per_class`` independent
        (unpaired) draws per class, class-sorted so Gram rows correspond
        across modalities at the concept level."""
        dev = self.prototypes.device
        labels = torch.arange(self.n_classes, device=dev).repeat_interleave(
            n_per_class)
        out = {}
        for m in self.modalities:
            latent = self.prototypes[labels] + self.noise * torch.randn(
                (labels.shape[0], self.d_latent), generator=gen, device=dev)
            noise = 0.05 * torch.randn((labels.shape[0], self.d_raw),
                                       generator=gen, device=dev)
            out[m] = (self._view(latent, m, noise), labels)
        return out


__all__ = ["SyntheticMultimodal", "stream"]
