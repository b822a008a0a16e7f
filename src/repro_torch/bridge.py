"""numpy <-> torch parameter trees, for weights carried across from the
JAX package, and the loaders that carry a reference federation's state
into the port's (``load_federation_state`` for the sequential round,
``load_engine_state`` for the node-stacked one).

Trees are nested dicts / lists / tuples with array leaves; ``None``
leaves (how ``core/lora.py`` partitions frozen from trainable leaves)
pass through unchanged.  bf16 has no numpy dtype of its own, so it
travels as the uint16 bit pattern the JAX checkpoints use: a leaf whose
dtype is named ``bfloat16`` (``ml_dtypes``, as ``np.asarray`` of a JAX
array gives it) is viewed as 16-bit integers and reinterpreted as
``torch.bfloat16`` -- no rounding, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_map


def _map(fn, tree):
    return tree_map(lambda x: None if x is None else fn(x), tree)


def _leaf_to_torch(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def _leaf_to_numpy(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes          # only needed when bf16 goes back to numpy
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree, device) -> object:
    """Nested numpy (or anything ``np.asarray`` takes) -> tensors on
    ``device``, structure and ``None`` leaves kept."""
    dev = torch.device(device)
    return _map(lambda x: _leaf_to_torch(x, dev), tree)


def params_to_numpy(tree) -> object:
    """Tensors -> numpy on the host; bf16 comes back as
    ``ml_dtypes.bfloat16`` (the dtype JAX reads)."""
    return _map(_leaf_to_numpy, tree)


def load_federation_state(fed, state: dict) -> None:
    """Overwrite the state of the port's ``SequentialFederation`` ``fed``
    with a reference federation's, given as numpy (``np.asarray`` of the
    JAX arrays), so both start a round from the same numbers.  ``fed``
    must be built from the same ``FederationConfig`` values and model
    config.  ``state`` holds:

    - ``frozen`` / ``frozen_bridge`` (None without bridge nodes): the
      frozen parameter trees, base weights with ``lora_A``;
    - ``nodes``: per node ``{"trainable", "opt_state"}``;
    - ``tokenizers``: per modality ``(w1, b1, w2)``;
    - ``anchor_tokens`` and ``synthetic_anchor_tokens``: per modality;
    - ``prototypes`` and ``modality_maps`` (per modality ``(w, b)``): the
      task's draws;
    - ``gbar``: the consensus Gram.

    bf16 leaves arrive bit for bit (``params_from_numpy``)."""
    if len(state["nodes"]) != len(fed.nodes):
        raise ValueError(f"{len(state['nodes'])} reference nodes, "
                         f"{len(fed.nodes)} in the port")
    _load_substrate(fed, state)
    for node, ref in zip(fed.nodes, state["nodes"]):
        node["trainable"] = params_from_numpy(ref["trainable"], fed.device)
        node["opt_state"] = params_from_numpy(ref["opt_state"], fed.device)


def load_engine_state(fed, state: dict) -> None:
    """Overwrite the state of the port's node-stacked ``Federation`` with a
    reference ``Federation``'s, given as numpy.  Both must be built from the
    same ``FederationConfig`` values, model config and ``width_bucketing``,
    so the bucket layouts agree.  ``state`` holds what
    ``load_federation_state`` reads, without ``nodes``, plus the bucketed
    state: ``trains`` and ``opts`` (tuples per bucket of node-stacked trees,
    the reference's ``_trains`` / ``_opts``) and ``server_m`` (its
    ``_server_m``, None when server momentum is off).

    With ``participation`` (the reference's ``plan_meta`` of its active
    plan) and ``part`` (its ``_part_state``) the sampler state crosses
    too: the port installs the plan and takes ``prev_p``, ``offline``,
    ``countdown``, ``lag`` and ``quarantined`` (under ``ctl`` for an
    async plan) and the async report buffer ``buf`` (``shipped``,
    ``gram``, ``prec``).  The reference's RNG keys have no counterpart
    (the sampler's included: the port's generator starts from the plan
    seed): a parity test feeds the port its draws.  The port's per-bucket
    statics and node views are rebuilt from the new substrate and
    state.  A federation on a mesh keeps its own rows of the buckets."""
    _load_substrate(fed, state)
    trains = tuple(params_from_numpy(tr, fed.device)
                   for tr in state["trains"])
    if len(trains) != len(fed._trains):
        raise ValueError(f"{len(trains)} reference buckets, "
                         f"{len(fed._trains)} in the port")
    fed._trains = fed.engine._local(trains)
    fed._opts = fed.engine._local(tuple(params_from_numpy(op, fed.device)
                                        for op in state["opts"]))
    fed._server_m = params_from_numpy(state["server_m"], fed.device)
    if state.get("part") is not None:
        _load_part_state(fed, state["participation"], state["part"])
    fed._refresh_statics()
    fed._views_stale = True


def _load_part_state(fed, meta: dict, part: dict) -> None:
    """The reference's sampler state into the port's, in place (the
    captured graphs read these tensors); its ``key`` is dropped."""
    from repro_torch.core.participation import plan_from_meta
    from repro_torch.tree import copy_into

    fed._ensure_participation(plan_from_meta(meta))
    ours = fed._part_state
    theirs = dict(part)
    if "ctl" in theirs:
        theirs["ctl"] = {k: v for k, v in theirs["ctl"].items()
                         if k != "key"}
    else:
        theirs = {k: v for k, v in theirs.items() if k != "key"}
    copy_into(ours, params_from_numpy(theirs, fed.device))


def _load_substrate(fed, state: dict) -> None:
    """Frozen trees, tokenizers, anchors, the task's draws and the
    consensus Gram."""
    def t(tree):
        return params_from_numpy(tree, fed.device)

    fed.frozen = t(state["frozen"])
    fed.frozen_bridge = t(state["frozen_bridge"])
    for m, (w1, b1, w2) in state["tokenizers"].items():
        tok = fed.tokenizers[m]
        tok.w1, tok.b1, tok.w2 = t(w1), t(b1), t(w2)
    fed.anchor_tokens = t(state["anchor_tokens"])
    fed.synthetic_anchor_tokens = t(state["synthetic_anchor_tokens"])
    fed.task.prototypes = t(state["prototypes"])
    fed.task.maps = {m: tuple(t(wb)) for m, wb
                     in state["modality_maps"].items()}
    fed.gbar = t(state["gbar"])


__all__ = ["params_from_numpy", "params_to_numpy", "load_federation_state",
           "load_engine_state"]
