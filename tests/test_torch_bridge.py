"""The numpy <-> torch bridge, the port's import boundary, and its device
rule (entry points run on cuda unless told otherwise, and raise without a
GPU)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import bridge  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401


ROOT = Path(__file__).resolve().parents[1]


def test_roundtrip_keeps_bf16_bits_and_none_leaves():
    x = np.random.default_rng(0).standard_normal((3, 5)).astype(np.float32)
    tree = {"a": {"w": np.asarray(jnp.asarray(x, jnp.bfloat16)),
                  "lora_B": None},
            "b": [x, np.arange(4, dtype=np.int32)],
            "c": (np.float32(2.5),)}
    t = bridge.params_from_numpy(tree, "cpu")
    assert t["a"]["lora_B"] is None
    assert t["a"]["w"].dtype == torch.bfloat16
    assert t["b"][1].dtype == torch.int32 and isinstance(t["c"], tuple)
    # bf16 travels bit for bit: the same 16-bit pattern on both sides
    np.testing.assert_array_equal(
        t["a"]["w"].view(torch.int16).numpy(),
        tree["a"]["w"].view(np.uint16).view(np.int16))
    back = bridge.params_to_numpy(t)
    assert back["a"]["lora_B"] is None
    assert back["a"]["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(back["a"]["w"].view(np.uint16),
                                  tree["a"]["w"].view(np.uint16))
    np.testing.assert_array_equal(back["b"][0], x)
    np.testing.assert_array_equal(back["b"][1], tree["b"][1])
    # and JAX reads it back unchanged
    np.testing.assert_array_equal(
        np.asarray(jax.device_put(back["a"]["w"]).astype(jnp.float32)),
        np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)))


def test_port_imports_neither_jax_nor_repro():
    """Every module of the port, and chip_smoke.py, imports without
    loading JAX or any module of the JAX package (checked in a fresh
    interpreter, since this one has both loaded)."""
    mods = sorted(
        "repro_torch." + str(p.relative_to(ROOT / "src" / "repro_torch")
                             .with_suffix("")).replace(os.sep, ".")
        .replace(".__init__", "")
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    assert "repro_torch.serve.engine" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_entry_points_raise_without_a_gpu(monkeypatch):
    """With no device given and no GPU visible, the entry points raise
    instead of carrying on quietly on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import ServeConfig, ServeEngine, init_pool_cache
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("fedmm-small").with_(
        n_layers=1, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, dtype="float32")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(0, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_pool_cache(cfg, 2, 8)
    params = init_params(0, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(params, cfg, ServeConfig(n_slots=2, cache_len=8))
    eng = ServeEngine(params, cfg, ServeConfig(n_slots=2, cache_len=8),
                      device="cpu")
    assert eng.state["cache"]["k"].device.type == "cpu"
