"""PyTorch + CUDA port of ``repro`` for NVIDIA Hopper (H100).

The package mirrors the JAX package's module paths (``configs``,
``models``, ``kernels``, ``core``, ``optim``, ``data``, ``serve``) so
each function has an obvious counterpart, and keeps its parameter trees:
nested dicts of tensors with the layer axis L stacked first and ``None``
where a leaf sits in the other half of a GeoLoRA partition, so weights
and states carried across with ``bridge`` drop in unchanged.

It imports ``torch`` and nothing of JAX or of ``repro``.  Entry points
(``SequentialFederation``, ``ServeEngine``, ``init_params``,
``init_pool_cache``) take an explicit ``device``; left as None they run
on ``cuda`` and raise where there is no GPU, so a run never carries on
quietly on the CPU.  On the card the kernels in ``csrc/`` always run --
attention, the GeoLoRA linear with its side-cars, the anchor Grams; a
tensor on the CPU goes to the kernel's plain PyTorch version in
``kernels/ref.py``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda`` and raises
    when no GPU is visible (pass ``device="cpu"`` to run on the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on cuda by default and no GPU "
                           "is visible; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


__all__ = ["resolve_device"]
