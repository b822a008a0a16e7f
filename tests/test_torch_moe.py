"""The port's MoE FFN (``repro_torch.models.moe``) against
``repro.models.moe`` in one process, on ``reduced(llama4-scout-17b-a16e)``
(d 256, 4 experts top-1 plus 1 shared, d_ff_expert 256), in f32, with the
same weights (JAX ``make_moe`` -> numpy -> ``bridge``) and numpy inputs:

- ``_capacity`` on the reference's own cases and a grid;
- ``router_scores``: combine scores, chosen experts and both aux values;
- ``moe_ffn`` at capacity factor 1.25 and 0.5 (where some expert is first
  shown to be over capacity, so the tie order decides which tokens it
  drops), at T <= 8 (capacity = T), and under the reduced DeepSeek-V2's
  top-2 ``MoEConfig`` on the same GQA model (the router's tie order at
  k > 1); routed indices equal, outputs within 1e-5 of max |y|;
- the selection on equal scores keeps the lowest indices, as
  ``lax.top_k`` does;
- ``bridge`` carries Scout's bf16 tree with its f32 router both ways bit
  for bit, and the port's own init gives the same tree;
- a mesh or expert-parallel axis raises.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401


REL = 1e-5
ARCH = "llama4-scout-17b-a16e"


def _configs(**moe_over):
    jcfg, tcfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    if moe_over:
        jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe, **moe_over))
        tcfg = tcfg.with_(moe=dataclasses.replace(tcfg.moe, **moe_over))
    return jcfg, tcfg


def _top2():
    """The reduced DeepSeek-V2's MoEConfig (top-2) on Scout's GQA model."""
    jcfg, tcfg = _configs()
    deep = jreduced(jget_config("deepseek-v2-236b")).moe
    assert deep.top_k == 2
    return (jcfg.with_(moe=deep),
            tcfg.with_(moe=reduced(get_config("deepseek-v2-236b")).moe))


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _configs()
    jp = jmoe.make_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    return jp, bridge.params_from_numpy(jax.device_get(jp), "cpu")


def _x(seed, b, s, d=256):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _close(got, want, rel=REL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(1e-30, np.abs(want).max())
    assert err <= rel, err


@pytest.mark.parametrize("t,k,e,f", [
    (65536, 6, 160, 1.25), (2, 2, 4, 1.25), (100, 1, 16, 1.25),
    (8, 1, 16, 1.25), (8448, 1, 16, 1.25), (48, 1, 4, 0.5), (37, 2, 4, 0.75),
    (1, 1, 4, 1.25)])
def test_capacity_matches_reference(t, k, e, f):
    """The reference's cases (``tests/test_mixers.py``), decode at 8 slots
    (capacity 8 = T: no drops), Scout's prefill and the drop cases."""
    assert moe._capacity(t, k, e, f) == jmoe._capacity(t, k, e, f)


@pytest.mark.parametrize("top2", [False, True], ids=["top1", "top2"])
def test_router_scores_match_jax(top2):
    jcfg, tcfg = _top2() if top2 else _configs()
    jp = jmoe.make_moe(jax.random.PRNGKey(1), jcfg, jnp.float32)
    tp = bridge.params_from_numpy(jax.device_get(jp), "cpu")
    x = _x(2, 2, 24)
    js, ji, jaux = jmoe.router_scores(jp, jnp.asarray(x), jcfg)
    ts, ti, taux = moe.router_scores(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(ts, js)
    for key in ("load_balance", "router_z"):
        _close(taux[key], jaux[key])
    assert ts.dtype == torch.float32


def _over_capacity(tp, x, cfg) -> int:
    """Tokens routed to the busiest expert beyond its capacity."""
    _, idx, _ = moe.router_scores(tp, torch.from_numpy(x), cfg)
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.moe.num_experts)
    t = x.shape[0] * x.shape[1]
    cap = moe._capacity(t, cfg.moe.top_k, cfg.moe.num_experts,
                        cfg.moe.capacity_factor)
    return int(counts.max()) - cap


@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_moe_ffn_matches_jax(weights, factor):
    """48 tokens (B 2 x S 24): at factor 0.5 the busiest expert is over
    its capacity of 8, so which of its tokens it keeps is the tie order's
    choice (every routed score is exactly 1.0 at top-1)."""
    jcfg, tcfg = _configs(capacity_factor=factor)
    jp, tp = weights
    x = _x(3, 2, 24)
    if factor < 1:
        assert _over_capacity(tp, x, tcfg) > 0
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    ty, taux = moe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    _close(ty, jy)
    _close(taux["load_balance"], jaux["load_balance"])
    _, ji, _ = jmoe.router_scores(jp, jnp.asarray(x), jcfg)
    _, ti, _ = moe.router_scores(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("b,s", [(1, 6), (2, 4), (8, 1)])
def test_moe_ffn_at_most_8_tokens_matches_jax(weights, b, s):
    """T <= 8 (8 slots x 1 token is the decode step): capacity = T, so
    no expert drops a token."""
    jcfg, tcfg = _configs()
    assert moe._capacity(b * s, 1, 4, 1.25) == b * s
    jp, tp = weights
    x = _x(4 + b, b, s)
    jy, _ = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    ty, _ = moe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    _close(ty, jy)


@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_moe_ffn_top2_matches_jax(factor):
    jcfg, tcfg = _top2()
    jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe,
                                              capacity_factor=factor))
    tcfg = tcfg.with_(moe=dataclasses.replace(tcfg.moe,
                                              capacity_factor=factor))
    jp = jmoe.make_moe(jax.random.PRNGKey(5), jcfg, jnp.float32)
    tp = bridge.params_from_numpy(jax.device_get(jp), "cpu")
    x = _x(6, 2, 20)
    if factor < 1:
        assert _over_capacity(tp, x, tcfg) > 0
    jy, _ = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    ty, _ = moe.moe_ffn(tp, torch.from_numpy(x), tcfg)
    _close(ty, jy)


def test_equal_scores_keep_the_lowest_indices():
    """On ties the selection keeps the lowest indices, as ``lax.top_k``
    does (``torch.topk`` on the CPU gives [4, 7, 5] here); an expert over
    capacity with all-equal scores keeps its first tokens."""
    col = [0., 1., 1., 0., 1., 1., 0., 1.]
    vals, idx = moe._top(torch.tensor(col), 3)
    jv, ji = jax.lax.top_k(jnp.asarray(col), 3)
    assert idx.tolist() == np.asarray(ji).tolist() == [1, 2, 4]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    d, f = 4, 2
    w = {n: {"w": torch.ones((1,) + shape)} for n, shape in
         (("gate", (d, f)), ("up", (d, f)), ("down", (f, d)))}
    y = moe._expert_block(w, torch.ones((10, d)), torch.ones((10, 1)), 4)
    assert (y[:4] != 0).all() and (y[4:] == 0).all()


def test_bridge_carries_scout_bf16_tree_with_f32_router():
    """Scout's tree in bf16 (the f32 router inside) crosses from JAX and
    back bit for bit, and the port's own init has its keys, shapes and
    dtypes."""
    jcfg, tcfg = _configs()
    jcfg, tcfg = jcfg.with_(dtype="bfloat16"), tcfg.with_(dtype="bfloat16")
    jp = jax.device_get(JT.init_params(jax.random.PRNGKey(0), jcfg))
    tp = bridge.params_from_numpy(jp, "cpu")
    assert tp["blocks"]["moe"]["router"]["w"].dtype == torch.float32
    assert tp["blocks"]["moe"]["experts"]["gate"]["w"].dtype == torch.bfloat16
    back = bridge.params_to_numpy(tp)
    jl = jax.tree_util.tree_leaves_with_path(jp)
    bl = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jl:
        assert bl[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(bl[path].view(np.uint8),
                                      np.asarray(leaf).view(np.uint8))
    own = bridge.params_to_numpy(TT.init_params(0, tcfg, device="cpu"))
    assert {jax.tree_util.keystr(p): (x.shape, x.dtype) for p, x in
            jax.tree_util.tree_leaves_with_path(own)} == \
        {jax.tree_util.keystr(p): (np.asarray(x).shape, np.asarray(x).dtype)
         for p, x in jl}


def test_mesh_and_expert_axis_raise(weights):
    _, tcfg = _configs()
    x = torch.zeros((1, 2, 256))
    for kw in ({"mesh": object()}, {"ep_axis": "model"}):
        with pytest.raises(NotImplementedError):
            moe.moe_ffn(weights[1], x, tcfg, **kw)
