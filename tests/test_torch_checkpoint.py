"""The port's checkpoint module against ``repro.checkpoint``, in one
process: the same npz + JSON format, so a file written by either package
loads in the other bit for bit, with leaves numbered in JAX's flattening
order (dict keys sorted), bf16 as its uint16 bits, and the same errors
for truncated, bit-flipped and non-archive files."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro_torch.checkpoint import (CheckpointError,  # noqa: E402
                                    load_checkpoint, read_meta,
                                    save_checkpoint)
from repro_torch.tree import tree_leaves  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32, "bool": torch.bool}


def _leaf(rng, shape, dtype: str) -> torch.Tensor:
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if dtype == "int32":
        return (x * 1000).to(torch.int32)
    if dtype == "bool":
        return x > 0
    return x.to(DTYPES[dtype])


def _tree(dtype: str, seed: int = 0) -> dict:
    """Nested dicts (keys inserted out of sorted order) and a list, with a
    None leaf, a scalar and a ragged shape."""
    rng = np.random.default_rng(seed)
    return {"zeta": _leaf(rng, (3, 5), dtype),
            "alpha": {"w": _leaf(rng, (2, 7), dtype), "skip": None,
                      "b": _leaf(rng, (), dtype)},
            "mid": [_leaf(rng, (4,), dtype),
                    {"y": _leaf(rng, (1, 2, 3), dtype),
                     "x": _leaf(rng, (6,), dtype)}]}


def _bits(t) -> np.ndarray:
    """A leaf's bits as numpy, bf16 as uint16 (either package's leaf)."""
    if isinstance(t, torch.Tensor):
        t = t.cpu()
        return (t.view(torch.int16).numpy().view(np.uint16)
                if t.dtype == torch.bfloat16 else t.numpy())
    arr = np.asarray(t)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


def _jax_tree(tree):
    return jax.tree_util.tree_map(lambda t: jnp.asarray(_bits(t)).view(
        jnp.bfloat16) if t.dtype == torch.bfloat16 else jnp.asarray(
        t.numpy()), tree, is_leaf=lambda x: isinstance(x, torch.Tensor))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_roundtrip_keeps_structure_and_bits(tmp_path, dtype):
    tree = _tree(dtype)
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, tree, step=11, meta={"who": "port", "n": [1, 2]})
    back, step = load_checkpoint(path, tree)
    assert step == 11
    assert read_meta(path) == {"who": "port", "n": [1, 2]}
    assert list(back) == list(tree) and back["alpha"]["skip"] is None
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_jax_written_file_loads_in_port_bit_exact(tmp_path, dtype):
    tree = _tree(dtype, seed=1)
    jtree = _jax_tree(tree)
    path = str(tmp_path / "j.npz")
    jckpt.save_checkpoint(path, jtree, step=3, meta={"from": "jax"})
    back, step = load_checkpoint(path, tree)
    assert step == 3 and read_meta(path) == {"from": "jax"}
    jleaves = jax.tree_util.tree_leaves(jtree)          # JAX's leaf order
    with np.load(path) as data:
        for i, jl in enumerate(jleaves):
            assert np.array_equal(_bits(data[f"leaf_{i}"]), _bits(jl))
    for a, b in zip(tree_leaves(back), tree_leaves(tree)):
        assert a.dtype == b.dtype
        assert np.array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_written_file_loads_in_jax_bit_exact(tmp_path, dtype):
    tree = _tree(dtype, seed=2)
    jtree = _jax_tree(tree)
    path = str(tmp_path / "p.npz")
    save_checkpoint(path, tree, step=5, meta={"from": "port"})
    back, step = jckpt.load_checkpoint(path, jtree)
    assert step == 5 and jckpt.read_meta(path) == {"from": "port"}
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jtree)):
        assert a.dtype == b.dtype
        assert np.array_equal(_bits(a), _bits(b))
    with np.load(path) as data:
        header = json.loads(str(data["__meta__"]))
    assert header["n_leaves"] == len(jax.tree_util.tree_leaves(jtree))
    assert header["dtypes"] == [str(x.dtype)
                                for x in jax.tree_util.tree_leaves(jtree)]


def _corrupt(path: str, how: str) -> str:
    with open(path, "rb") as fh:
        blob = bytearray(fh.read())
    if how == "truncated":
        blob = blob[:len(blob) // 3]
    elif how == "bit-flipped":
        # flip bytes inside the first stored leaf (past its local header)
        i = blob.index(b"leaf_0.npy") + 200
        for j in range(i, i + 8):
            blob[j] ^= 0xFF
    else:
        blob = b"not a checkpoint at all\n" * 10
    out = f"{path}.{how}.npz"
    with open(out, "wb") as fh:
        fh.write(bytes(blob))
    return out


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("how", ["truncated", "bit-flipped", "non-archive"])
def test_unreadable_files_raise_checkpoint_error_like_jax(tmp_path, how,
                                                          writer):
    tree = {"a": torch.arange(4096, dtype=torch.float32),
            "b": torch.ones((3,), dtype=torch.int32)}
    path = str(tmp_path / "ok.npz")
    if writer == "port":
        save_checkpoint(path, tree)
    else:
        jckpt.save_checkpoint(path, _jax_tree(tree))
    bad = _corrupt(path, how)
    with pytest.raises(CheckpointError, match=os.path.basename(bad)):
        load_checkpoint(bad, tree)
    with pytest.raises(jckpt.CheckpointError,
                       match=os.path.basename(bad)):
        jckpt.load_checkpoint(bad, _jax_tree(tree))


def test_wrong_structure_raises_value_error(tmp_path):
    path = str(tmp_path / "s.npz")
    save_checkpoint(path, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(path, {"a": torch.ones(3), "b": torch.ones(2)})
    # same leaf count, another shape: a checkpoint of another state
    with pytest.raises(CheckpointError, match="shape"):
        load_checkpoint(path, {"a": torch.ones(4)})


def test_missing_file_and_failed_save_leave_no_partial_file(tmp_path):
    with pytest.raises(CheckpointError, match="nowhere"):
        read_meta(str(tmp_path / "nowhere.npz"))
    path = str(tmp_path / "keep.npz")
    save_checkpoint(path, {"a": torch.ones(3)}, step=1)
    with pytest.raises(TypeError):          # meta is not JSON-serialisable
        save_checkpoint(path, {"a": torch.zeros(3)}, step=2,
                        meta={"bad": object()})
    back, step = load_checkpoint(path, {"a": torch.zeros(3)})
    assert step == 1 and torch.equal(back["a"], torch.ones(3))
    assert sorted(os.listdir(tmp_path)) == ["keep.npz"]
