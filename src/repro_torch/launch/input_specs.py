"""Abstract inputs for every (architecture x input shape): the port of
``repro.launch.input_specs`` without the mesh's ``PartitionSpec``s (they
come with ``shardings.py``).

Where the reference returns ``jax.ShapeDtypeStruct``s, the port returns
tensors on ``device="meta"``: shapes and dtypes, no memory.
``train_4k`` feeds the federated round step (tokens, labels, anchors and
the consensus Gram), ``prefill_32k`` the prefill, ``decode_32k`` /
``long_500k`` one decode step against a cache of ``seq_len`` positions.
The modality front ends are stubs: vlm batches carry CLIP-width patch
embeddings, audio batches the encoder's frames.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs import InputShape, ModelConfig
from repro_torch.core import lora as lora_mod
from repro_torch.models import transformer as T

ANCHORS = 32            # public anchor set size B (the Gram is 32 x 32)
ANCHOR_LEN = 128        # anchor token length

META = torch.device("meta")


def _f(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def runtime_for(cfg: ModelConfig, shape: InputShape) -> T.Runtime:
    """The runtime a shape runs under: ``long_500k`` puts the dense and vlm
    families without a window of their own under a sliding window of
    8,192 (the flagged variant); train shapes remat every layer."""
    window = 0
    if shape.name == "long_500k" and cfg.family in ("dense", "vlm") \
            and not cfg.sliding_window:
        window = 8192
    return T.Runtime(window_override=window, remat=(shape.kind == "train"))


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def skip_reason(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    if shape.name in cfg.skip_shapes:
        return cfg.long_context_variant or "skipped per config"
    return None


def train_batch_specs(cfg: ModelConfig, shape: InputShape,
                      k_nodes: int = 1):
    """(batch, gbar) of the round step for ``k_nodes`` nodes (the mesh's
    node count in the reference): the global batch's tokens and labels
    (text only for vlm, beside its patch embeddings; beside the encoder
    frames for audio, with per-node anchor frames), per-node anchors
    (K, ANCHORS, ANCHOR_LEN) and the consensus Gram."""
    b, s = shape.global_batch, shape.seq_len
    dt = _dtype(cfg)
    batch = {}
    if cfg.family == "vlm":
        n_img = cfg.n_image_tokens
        batch["tokens"] = _f((b, s - n_img), torch.int32)
        batch["labels"] = _f((b, s - n_img), torch.int32)
        batch["image_embeds"] = _f((b, n_img, cfg.image_embed_dim), dt)
    elif cfg.family == "audio":
        batch["tokens"] = _f((b, s), torch.int32)
        batch["labels"] = _f((b, s), torch.int32)
        batch["enc_embeds"] = _f((b, cfg.encoder_seq_len,
                                  cfg.encoder_embed_dim), dt)
        batch["anchor_enc_embeds"] = _f(
            (k_nodes, ANCHORS, cfg.encoder_seq_len, cfg.encoder_embed_dim),
            dt)
    else:
        batch["tokens"] = _f((b, s), torch.int32)
        batch["labels"] = _f((b, s), torch.int32)
    batch["anchors"] = _f((k_nodes, ANCHORS, ANCHOR_LEN), torch.int32)
    return batch, _f((ANCHORS, ANCHORS), torch.float32)


def serve_batch_specs(cfg: ModelConfig, shape: InputShape) -> dict:
    """The prefill batch of a prefill shape, else one decode step's."""
    b, s = shape.global_batch, shape.seq_len
    dt = _dtype(cfg)
    if shape.kind != "prefill":
        return {"tokens": _f((b, 1), torch.int32)}
    batch = {}
    if cfg.family == "vlm":
        batch["tokens"] = _f((b, s - cfg.n_image_tokens), torch.int32)
        batch["image_embeds"] = _f((b, cfg.n_image_tokens,
                                    cfg.image_embed_dim), dt)
    elif cfg.family == "audio":
        batch["tokens"] = _f((b, s), torch.int32)
        batch["enc_embeds"] = _f((b, cfg.encoder_seq_len,
                                  cfg.encoder_embed_dim), dt)
    else:
        batch["tokens"] = _f((b, s), torch.int32)
    return batch


def abstract_cache(cfg: ModelConfig, shape: InputShape,
                   rt: T.Runtime) -> dict:
    """The decode cache of ``shape`` (``global_batch`` sequences,
    ``seq_len`` positions) on the meta device."""
    return T.init_cache(cfg, shape.global_batch, shape.seq_len, device=META,
                        rt=rt)


def abstract_params(cfg: ModelConfig, lora_spec=None) -> dict:
    """The parameter tree, with ``lora_spec``'s side-cars when given, on
    the meta device (the random draws come from a CPU generator and
    allocate nothing)."""
    p = T.init_params(torch.Generator().manual_seed(0), cfg, device=META)
    if lora_spec is not None:
        p = lora_mod.attach_lora(torch.Generator().manual_seed(1), p,
                                 lora_spec)
    return p


__all__ = ["ANCHORS", "ANCHOR_LEN", "runtime_for", "skip_reason",
           "train_batch_specs", "serve_batch_specs", "abstract_cache",
           "abstract_params"]
