"""The port's RG-LRU block (``repro_torch.models.rglru``) against
``repro.models.rglru`` in one process, on ``reduced(recurrentgemma-9b)``
(d_model 256, lru_width 256, conv kernel 4, f32), with the same weights
(JAX init -> numpy -> ``bridge``) and the same numpy inputs:

- the block's init tree (keys, shapes, dtypes; ``lam`` in f32) and the
  port's own init distribution (a at r = 1 in [0.9^2, 0.999^2]);
- the full-sequence forward and its final state, one decode step, and a
  forward continued from ``h0`` / ``conv0`` (1e-4 of max(1, |value|));
- the port's own forward against its own step-by-step decode, and the
  state's stability over a long input (``tests/test_mixers.py``'s two
  RG-LRU tests on the port).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import rglru  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401


ARCH = "recurrentgemma-9b"
REL = 1e-4


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else x, np.float64)


def _close(got, want, rel=REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= rel, err


@pytest.fixture(scope="module")
def block():
    jcfg, tcfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    jp = jrglru.make_rglru_block(jax.random.PRNGKey(3), jcfg, jnp.float32)
    return jcfg, tcfg, jp, bridge.params_from_numpy(jax.device_get(jp),
                                                    "cpu")


def _x(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def test_init_tree_matches_jax(block):
    jcfg, tcfg, jp, _ = block
    ours = rglru.make_rglru_block(torch.Generator().manual_seed(0), tcfg,
                                  torch.float32)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_t = dict(jax.tree_util.tree_leaves_with_path(
        bridge.params_to_numpy(ours)))
    assert set(flat_t) == {p for p, _ in flat_j}
    for path, leaf in flat_j:
        assert flat_t[path].shape == leaf.shape, path
        assert flat_t[path].dtype == leaf.dtype, path
    lam = flat_t[next(p for p, _ in flat_j
                      if "lam" in jax.tree_util.keystr(p))]
    a = np.exp(-8.0 * np.log1p(np.exp(lam)))      # the gate at r = 1
    assert ((a >= 0.9 ** 2 - 1e-6) & (a <= 0.999 ** 2 + 1e-6)).all()
    assert rglru.lru_width(tcfg) == jrglru.lru_width(jcfg) == 256


def test_forward_and_state_match_jax(block):
    jcfg, tcfg, jp, tp = block
    x = _x(1, (2, 21, tcfg.d_model))
    jy, js = jrglru.rglru_forward(jp, jnp.asarray(x), jcfg)
    ty, ts = rglru.rglru_forward(tp, torch.from_numpy(x), tcfg)
    _close(ty, jy)
    _close(ts["h"], js["h"])
    _close(ts["conv"], js["conv"])
    assert ts["h"].dtype == torch.float32


def test_decode_step_matches_jax(block):
    jcfg, tcfg, jp, tp = block
    x = _x(2, (3, 1, tcfg.d_model))
    st = {"h": _x(3, (3, 256)), "conv": _x(4, (3, 3, 256))}
    jy, js = jrglru.rglru_decode(jp, jnp.asarray(x),
                                 {k: jnp.asarray(v) for k, v in st.items()},
                                 jcfg)
    ty, ts = rglru.rglru_decode(tp, torch.from_numpy(x),
                                {k: torch.from_numpy(v)
                                 for k, v in st.items()}, tcfg)
    _close(ty, jy)
    for k in ("h", "conv"):
        _close(ts[k], js[k])


def test_forward_continues_from_h0_conv0(block):
    """A forward from an earlier call's state: against JAX with the same
    h0 / conv0, and against the port's own forward over the whole
    sequence."""
    jcfg, tcfg, jp, tp = block
    x = _x(5, (2, 17, tcfg.d_model))
    h0, conv0 = _x(6, (2, 256)), _x(7, (2, 3, 256))
    jy, js = jrglru.rglru_forward(jp, jnp.asarray(x), jcfg,
                                  h0=jnp.asarray(h0), conv0=jnp.asarray(conv0))
    ty, ts = rglru.rglru_forward(tp, torch.from_numpy(x), tcfg,
                                 h0=torch.from_numpy(h0),
                                 conv0=torch.from_numpy(conv0))
    _close(ty, jy)
    _close(ts["h"], js["h"])
    _close(ts["conv"], js["conv"])
    xt = torch.from_numpy(x)
    y_full, s_full = rglru.rglru_forward(tp, xt, tcfg)
    y1, s1 = rglru.rglru_forward(tp, xt[:, :6], tcfg)
    y2, s2 = rglru.rglru_forward(tp, xt[:, 6:], tcfg, h0=s1["h"],
                                 conv0=s1["conv"])
    _close(torch.cat([y1, y2], 1), y_full, 1e-5)
    _close(s2["h"], s_full["h"], 1e-5)
    with pytest.raises(ValueError, match="conv0"):
        rglru.rglru_forward(tp, xt, tcfg, conv0=torch.zeros(2, 2, 256))


def test_short_prompt_conv_state_keeps_k_minus_1_rows(block):
    """A sequence shorter than conv_kernel - 1: the state holds zero rows
    first, so decode from it equals the forward over the whole sequence
    (the port's deliberate difference from JAX, as in ``models.ssm``)."""
    _, tcfg, _, tp = block
    x = torch.from_numpy(_x(8, (1, 4, tcfg.d_model)))
    _, s1 = rglru.rglru_forward(tp, x[:, :2], tcfg)
    assert s1["conv"].shape == (1, 3, 256)
    assert float(s1["conv"][:, 0].abs().max()) == 0.0
    y_full, _ = rglru.rglru_forward(tp, x, tcfg)
    st, ys = s1, []
    for t in (2, 3):
        y, st = rglru.rglru_decode(tp, x[:, t:t + 1], st, tcfg)
        ys.append(y)
    _close(torch.cat(ys, 1), y_full[:, 2:], 1e-5)


def test_port_forward_equals_port_decode(block):
    """``tests/test_mixers.py``: the step-by-step decode from the empty
    state equals the full-sequence forward."""
    _, tcfg, _, tp = block
    x = torch.from_numpy(_x(9, (2, 10, tcfg.d_model)))
    y_full, _ = rglru.rglru_forward(tp, x, tcfg)
    st = rglru.init_rglru_state(2, tcfg, torch.float32, device="cpu")
    ys = []
    for t in range(10):
        y, st = rglru.rglru_decode(tp, x[:, t:t + 1], st, tcfg)
        ys.append(y)
    _close(torch.cat(ys, 1), y_full)


def test_state_stays_bounded(block):
    """``tests/test_mixers.py``: the gate keeps a < 1, so the state stays
    bounded over a long, large input."""
    _, tcfg, _, tp = block
    x = torch.from_numpy(_x(10, (1, 256, tcfg.d_model), 5.0))
    y, st = rglru.rglru_forward(tp, x, tcfg)
    assert bool(torch.isfinite(y).all())
    assert float(st["h"].abs().max()) < 1e3
