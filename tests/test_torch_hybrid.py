"""The port's hybrid family (RecurrentGemma) and the dense family's
sliding-window variant (``Runtime(window_override=)``) against
``repro.models.transformer`` in one process, with the same weights (JAX
init -> numpy -> ``bridge``) and the same numpy tokens, in f32:

- hybrid: ``reduced(recurrentgemma-9b)`` cut to 5 layers -- one stacked
  (recurrent, recurrent, attention) group and a tail of two recurrent
  blocks -- with its local window of 64 and prompts of up to 80 tokens,
  so the ring wraps: the init tree, ``forward``, ``pooled``, the
  ``prefill`` cache leaf by leaf (``groups`` stacked, ``tail`` a list),
  ``init_cache``, and ``decode_step_slots`` over a pool of slots at
  different depths with a ``step_mask`` that freezes one slot;
- windowed dense: ``reduced(fedmm-base)`` under ``window_override`` 16
  with prompts of up to 40 tokens: ``forward``, the prefill ring and
  ``decode_step_slots`` the same way.

Tolerance 1e-4 of max(1, |value|); positions and lengths exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.pool import init_pool_cache as jinit_pool  # noqa: E402
from repro.serve.pool import scatter_slot as jscatter  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve.pool import init_pool_cache, scatter_slot  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401


REL = 1e-4
J_FORWARD = jax.jit(JT.forward, static_argnums=(2, 3))
J_PREFILL = jax.jit(JT.prefill, static_argnums=(2, 3),
                    static_argnames="cache_len")
J_DECODE = jax.jit(JT.decode_step_slots, static_argnums=(3, 4))
#: name -> (arch, config override, window_override, prompt lengths,
#: cache_len)
MODELS = {"hybrid": ("recurrentgemma-9b", {"n_layers": 5}, 0, (80, 50, 17),
                     96),
          "windowed dense": ("fedmm-base", {}, 16, (40, 23, 9), 48)}


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else x, np.float64)


def _close(got, want, rel=REL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= rel, err


def _leaves(tree):
    """{path string: numpy leaf} of a JAX or a port tree."""
    tree = bridge.params_to_numpy(tree) if not isinstance(
        jax.tree_util.tree_leaves(tree)[0], jax.Array) else tree
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _assert_same_tree(got, want):
    """Leaf by leaf: positions and lengths exact, the rest to REL."""
    g, w = _leaves(got), _leaves(want)
    assert set(g) == set(w), set(g) ^ set(w)
    for path, leaf in w.items():
        assert g[path].shape == leaf.shape, path
        if leaf.dtype.kind in "iub":
            np.testing.assert_array_equal(g[path], leaf, err_msg=path)
        else:
            _close(g[path], leaf)


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    arch, over, window, lens, cache_len = MODELS[request.param]
    jcfg = jreduced(jget_config(arch)).with_(**over)
    tcfg = reduced(get_config(arch)).with_(**over)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(len(request.param))
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in lens]
    return dict(name=request.param, jcfg=jcfg, tcfg=tcfg, jp=jp,
                tp=bridge.params_from_numpy(jax.device_get(jp), "cpu"),
                jrt=JT.Runtime(window_override=window),
                trt=TT.Runtime(window_override=window), prompts=prompts,
                cache_len=cache_len)


def test_init_tree_matches_jax(model):
    """Same keys, shapes and dtypes (the hybrid's ``tail`` a list)."""
    got = TT.init_params(0, model["tcfg"], device="cpu", rt=model["trt"])
    g, w = _leaves(got), _leaves(model["jp"])
    assert {k: (v.shape, v.dtype) for k, v in g.items()} == \
        {k: (v.shape, v.dtype) for k, v in w.items()}
    if model["name"] == "hybrid":
        assert isinstance(got["tail"], list) and len(got["tail"]) == 2
        assert got["groups"]["b0"]["mixer"]["lam"].dtype == torch.float32


def test_forward_and_pooled_match_jax(model):
    toks = np.stack([model["prompts"][0]] * 2)
    toks[1] = toks[1][::-1]
    jl, jaux = J_FORWARD(model["jp"], {"tokens": jnp.asarray(toks)},
                         model["jcfg"], model["jrt"])
    tl, taux = TT.forward(model["tp"], {"tokens": torch.from_numpy(toks)},
                          model["tcfg"], rt=model["trt"])
    _close(tl, jl)
    _close(taux["pooled"], jaux["pooled"])
    _close(TT.pooled(model["tp"], {"tokens": torch.from_numpy(toks)},
                     model["tcfg"], rt=model["trt"]), jaux["pooled"])


def test_prefill_cache_matches_jax_leaf_by_leaf(model):
    """The longest prompt: longer than the window, so the ring has
    wrapped; every cache leaf equal (positions exactly)."""
    toks = model["prompts"][0][None]
    jl, jc = J_PREFILL(model["jp"], {"tokens": jnp.asarray(toks)},
                       model["jcfg"], model["jrt"],
                       cache_len=model["cache_len"])
    tl, tc = TT.prefill(model["tp"], {"tokens": torch.from_numpy(toks)},
                        model["tcfg"], cache_len=model["cache_len"],
                        rt=model["trt"])
    _close(tl, jl)
    _assert_same_tree(tc, jc)


def test_init_cache_matches_jax(model):
    jc = JT.init_cache(model["jcfg"], 3, model["cache_len"], model["jrt"])
    tc = TT.init_cache(model["tcfg"], 3, model["cache_len"], device="cpu",
                       rt=model["trt"])
    _assert_same_tree(tc, jc)


def test_decode_step_slots_with_step_mask_matches_jax(model):
    """Slots at different depths (rings wrapped, partly filled), one
    frozen by ``step_mask`` on the second step: logits, every pool leaf
    and the per-slot positions agree after three steps."""
    jcfg, tcfg, jp, tp = (model[k] for k in ("jcfg", "tcfg", "jp", "tp"))
    cache_len, n_slots = model["cache_len"], 4
    jpool = jinit_pool(jcfg, n_slots, cache_len, model["jrt"])
    tpool = init_pool_cache(tcfg, n_slots, cache_len, device="cpu",
                            rt=model["trt"])
    for slot, toks in enumerate(model["prompts"]):
        _, jc = J_PREFILL(jp, {"tokens": jnp.asarray(toks)[None]}, jcfg,
                          model["jrt"], cache_len=cache_len)
        _, tc = TT.prefill(tp, {"tokens": torch.from_numpy(toks)[None]},
                           tcfg, cache_len=cache_len, rt=model["trt"])
        jpool = jscatter(jpool, jc, jnp.asarray(slot, jnp.int32))
        scatter_slot(tpool, tc, slot)
    rng = np.random.default_rng(7)
    for step in range(3):
        mask = np.array([True, step != 1, True, True])
        toks = rng.integers(0, jcfg.vocab_size, (n_slots, 1)).astype(np.int32)
        jl, jpool = J_DECODE(jp, jpool, {"tokens": jnp.asarray(toks)}, jcfg,
                             model["jrt"], step_mask=jnp.asarray(mask))
        tl, tpool = TT.decode_step_slots(
            tp, tpool, {"tokens": torch.from_numpy(toks)}, tcfg,
            rt=model["trt"], step_mask=torch.from_numpy(mask))
        _close(tl, jl)
    _assert_same_tree(tpool, jpool)
    lens = [len(p) for p in model["prompts"]] + [0]
    np.testing.assert_array_equal(tpool["len"].numpy(),
                                  [n + 3 - (i == 1) for i, n in
                                   enumerate(lens)])


def test_hybrid_layer_order_and_window():
    """The hybrid stack runs group by group, then the tail; every
    attention block masks with the local window whatever
    ``window_override`` says (as in the reference)."""
    cfg = reduced(get_config("recurrentgemma-9b")).with_(n_layers=5)
    p = TT.init_params(0, cfg, device="cpu")
    kinds = [(k, w) for k, _, w in TT._hybrid_stack(p, cfg)]
    assert kinds == [("recurrent", ("b0", 0)), ("recurrent", ("b1", 0)),
                     ("attention", ("b2", 0)), ("recurrent", ("tail", 0)),
                     ("recurrent", ("tail", 1))]
    toks = {"tokens": torch.arange(70, dtype=torch.int32)[None] % 512}
    a = TT.forward(p, toks, cfg)[0]
    b = TT.forward(p, toks, cfg, rt=TT.Runtime(window_override=8))[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
