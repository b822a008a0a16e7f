"""Tree checkpoints in the JAX package's format (numpy .npz + a JSON
header), so files go both ways between ``repro.checkpoint`` and the port.

The format: one archive member ``leaf_<i>`` per leaf and a ``__meta__``
member holding ``{"treedef", "dtypes", "step", "n_leaves",
"user_meta"}``.  Leaves are numbered in JAX's flattening order -- dict
keys SORTED, lists and tuples in order, ``None`` an empty subtree -- which
is not the insertion order ``repro_torch.tree`` walks, so this module
flattens on its own.  bf16 leaves are stored as their uint16 bit pattern
with the dtype named ``bfloat16``.  ``load_checkpoint`` takes its
structure from ``like`` and never parses ``treedef`` (neither does the
JAX package's), so the string the port writes there only describes the
tree for a reader.  Writes are atomic (a tmp file, then ``os.replace``):
a crash mid-save never corrupts the previous checkpoint.

Leaves may be tensors on any device, numpy arrays or Python scalars.
Loaded leaves come back as tensors on the device of ``like``'s leaf where
that is a tensor, else as numpy arrays.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

_BF16 = "bfloat16"


class CheckpointError(RuntimeError):
    """A checkpoint file is unreadable — truncated, bit-flipped, or not a
    checkpoint at all.  Message always carries the path and, where known,
    expected-vs-found sizes, so an operator can tell a half-written file
    from a wrong path at a glance."""


def _leaves(tree) -> List[Any]:
    """The leaves in JAX's flattening order (sorted dict keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _unflatten(like, it: Iterator):
    if isinstance(like, dict):
        done = {k: _unflatten(like[k], it) for k in sorted(like)}
        return {k: done[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, it) for v in like)
    return None if like is None else next(it)


def _describe(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_describe(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        return "(" + ", ".join(_describe(v) for v in tree) + ")"
    return "None" if tree is None else "*"


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """(array to store, dtype name) of one leaf; bf16 as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
        if arr.dtype.name == _BF16:
            return np.ascontiguousarray(arr).view(np.uint16), _BF16
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str, like):
    if isinstance(like, torch.Tensor):
        if dtype == _BF16:
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, order="C"))
        return t.to(like.device)
    if dtype == _BF16:
        import ml_dtypes          # only needed when bf16 goes back to numpy
        return arr.view(ml_dtypes.bfloat16)
    return arr


def jax_key_layout(seed: int) -> np.ndarray:
    """The uint32 (2,) words of ``jax.random.PRNGKey(seed)`` (threefry):
    ``[seed >> 32, seed & 0xFFFFFFFF]`` for a seed in [0, 2**64).  The port
    draws with torch generators; it writes such leaves so its files carry
    the JAX package's leaf set, and never reads them back."""
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    dtype=np.uint32)


def save_checkpoint(path: str, tree, step: int = 0,
                    meta: Dict[str, Any] = None) -> None:
    """``meta`` is an optional JSON-serialisable dict stored alongside the
    tree; read it back with ``read_meta``."""
    arrays, metas = {}, []
    for i, leaf in enumerate(_leaves(tree)):
        arrays[f"leaf_{i}"], dt = _to_numpy(leaf)
        metas.append(dt)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    header = {"treedef": _describe(tree), "dtypes": metas, "step": step,
              "n_leaves": len(metas), "user_meta": meta or {}}
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    os.close(fd)
    try:
        np.savez(tmp, __meta__=json.dumps(header), **arrays)
        src = tmp if tmp.endswith(".npz") else tmp + ".npz"
        if not os.path.exists(src):      # np.savez appends .npz
            src = tmp
        os.replace(src, path)
    finally:
        for f in (tmp, tmp + ".npz"):
            if os.path.exists(f):
                os.remove(f)


def _open_checkpoint(path: str):
    """np.load with the opaque failure modes translated into
    ``CheckpointError``: a truncated download / half-copied file raises
    zipfile or struct errors deep inside numpy; a bit-flipped member
    raises on CRC or on json decode.  All of them become one clear error
    carrying the path and the on-disk vs expected sizes."""
    try:
        found = os.path.getsize(path)
    except OSError as e:
        raise CheckpointError(f"checkpoint {path!r}: {e}") from e
    try:
        data = np.load(path, allow_pickle=False)
    except Exception as e:
        raise CheckpointError(
            f"checkpoint {path!r} is not a readable .npz archive "
            f"({found} bytes on disk): {type(e).__name__}: {e} — the "
            f"file is truncated, corrupt, or not a checkpoint") from e
    return data, found


def _read_header(data, path: str, found: int) -> Dict[str, Any]:
    try:
        if "__meta__" not in data:
            raise KeyError("__meta__")
        return json.loads(str(data["__meta__"]))
    except Exception as e:
        data.close()
        raise CheckpointError(
            f"checkpoint {path!r} ({found} bytes on disk) has no readable "
            f"__meta__ header: {type(e).__name__}: {e} — the archive is "
            f"corrupt or was not written by save_checkpoint") from e


def read_meta(path: str) -> Dict[str, Any]:
    """User metadata stored by ``save_checkpoint(..., meta=...)`` (empty
    dict for checkpoints written before meta support existed).  Raises
    ``CheckpointError`` on a truncated/corrupt file."""
    data, found = _open_checkpoint(path)
    with data:
        return _read_header(data, path, found).get("user_meta", {})


def load_checkpoint(path: str, like) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (shape-checked).  Structure
    mismatches raise ``ValueError`` (wrong checkpoint for this state);
    unreadable files — truncated, bit-flipped, not an archive — raise
    ``CheckpointError`` with the path and expected-vs-found sizes."""
    data, found = _open_checkpoint(path)
    with data:
        meta = _read_header(data, path, found)
        leaves_like = _leaves(like)
        n_expected = meta["n_leaves"]
        if len(leaves_like) != n_expected:
            raise ValueError(
                f"checkpoint has {n_expected} leaves, target structure "
                f"has {len(leaves_like)}")
        stored = [k for k in data.files if k.startswith("leaf_")]
        if len(stored) != n_expected:
            raise CheckpointError(
                f"checkpoint {path!r} ({found} bytes on disk) is "
                f"truncated: header promises {n_expected} leaves, archive "
                f"holds {len(stored)}")
        out = []
        for i, (ref_leaf, dt) in enumerate(zip(leaves_like, meta["dtypes"])):
            try:
                arr = data[f"leaf_{i}"]
            except Exception as e:
                raise CheckpointError(
                    f"checkpoint {path!r}: leaf_{i} of {n_expected} is "
                    f"unreadable ({found} bytes on disk): "
                    f"{type(e).__name__}: {e} — truncated or bit-flipped "
                    f"archive member") from e
            if hasattr(ref_leaf, "shape") \
                    and tuple(arr.shape) != tuple(ref_leaf.shape):
                expected = int(np.prod(tuple(ref_leaf.shape)))
                raise CheckpointError(
                    f"checkpoint {path!r}: leaf {i} has shape "
                    f"{tuple(arr.shape)} ({arr.size} elements), expected "
                    f"{tuple(ref_leaf.shape)} ({expected} elements) — "
                    f"truncated write or a checkpoint from a different "
                    f"state structure")
            out.append(_from_numpy(arr, dt, ref_leaf))
    return _unflatten(like, iter(out)), meta["step"]


__all__ = ["save_checkpoint", "load_checkpoint", "read_meta",
           "jax_key_layout", "CheckpointError"]
