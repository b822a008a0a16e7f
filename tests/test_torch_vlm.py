"""The port's vlm family (Phi-3-vision: the dense stack plus ``adapter``,
image patch embeddings prepended to the text) against ``repro.models``
and the JAX ``ServeEngine`` in one process, on the CPU.  Weights are the
JAX init carried across with ``bridge.params_from_numpy``; tokens and
image embeddings come from numpy seeds.  Two configurations:
``reduced(phi-3-vision-4.2b)`` (dh 64, 8 image tokens of width 64) and a
dh-96 variant (d_model 192, 2 heads of 96: Phi-3-vision's head dim), so
the plain flash and decode versions run at 96 against JAX's
``blockwise_attention`` and ``kernels/ref.py``.

- ``init_params`` builds the reference's tree (``adapter`` included) and
  it round-trips through ``bridge``;
- ``forward``'s logits (image positions dropped) and ``pooled`` (image
  positions kept), ``prefill``'s logits, ``len`` = image + text and its
  cache leaves, three ``decode_step_slots`` steps (one slot writing at
  C - 1 past the pool's end): f32, 1e-4 absolute on logits (max |logit|
  ~4; the two frameworks sum in other orders), 1e-5 on the cache and
  ``pooled``;
- ``ServeEngine`` with ``image_embeds`` extras: greedy tokens, states
  and ``stats`` identical to the JAX engine's; a request whose image +
  text + max_new passes ``cache_len`` while text + max_new + 1 does not
  decodes as JAX's (writes at C - 1); one whose image + text outgrows
  ``cache_len`` fails at the scatter in both packages;
- serve snapshots refuse requests with extras in both packages.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve.pool import init_pool_cache as jinit_pool  # noqa: E402
from repro.serve.pool import scatter_slot as jscatter  # noqa: E402
from repro.serve.scheduler import FifoScheduler as JFifo  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve import (Request, ServeConfig,  # noqa: E402
                               ServeEngine)
from repro_torch.serve.pool import (init_pool_cache,  # noqa: E402
                                    scatter_slot)
from repro_torch.serve.scheduler import FifoScheduler  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401

ARCH = "phi-3-vision-4.2b"
#: the reduced config, and its dh-96 variant
OVER = {"dh64": {}, "dh96": dict(d_model=192, n_heads=2, n_kv_heads=2,
                                 head_dim=96)}
J_INIT = jax.jit(JT.init_params, static_argnums=1)
J_FORWARD = jax.jit(JT.forward, static_argnums=2)
J_PREFILL = jax.jit(JT.prefill, static_argnums=2, static_argnames="cache_len")
J_DECODE = jax.jit(JT.decode_step_slots, static_argnums=3)
LOGIT_TOL, STATE_TOL = 1e-4, 1e-5
SCFG = ServeConfig(n_slots=3, cache_len=64, block_steps=4, max_new_tokens=6)


def _model(over):
    jcfg = jreduced(jget_config(ARCH)).with_(**over)
    tcfg = reduced(get_config(ARCH)).with_(**over)
    jp = J_INIT(jax.random.PRNGKey(0), jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp,
                tp=bridge.params_from_numpy(jax.device_get(jp), "cpu"))


@pytest.fixture(scope="module")
def models():
    return {k: _model(v) for k, v in OVER.items()}


def _inputs(cfg, b, n_text, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, n_text)).astype(np.int32)
    img = rng.standard_normal((b, cfg.n_image_tokens, cfg.image_embed_dim))
    return toks, img.astype(np.float32)


def _jbatch(toks, img):
    return {"tokens": jnp.asarray(toks), "image_embeds": jnp.asarray(img)}


def _tbatch(toks, img):
    return {"tokens": torch.from_numpy(toks),
            "image_embeds": torch.from_numpy(img)}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), atol=tol, rtol=0)


# ----------------------------------------------------------------------
# the model
def test_init_tree_matches_jax_and_round_trips(models):
    """``init_params`` gives the reference's tree -- the dense blocks plus
    ``adapter`` (image_embed_dim, d_model) -- in keys, shapes and dtypes,
    and the JAX weights come back bit for bit through the bridge."""
    m = models["dh64"]

    def spec(tree):
        return {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
                for p, x in jax.tree_util.tree_leaves_with_path(tree)}
    port = bridge.params_to_numpy(TT.init_params(0, m["tcfg"], device="cpu"))
    assert spec(port) == spec(m["jp"])
    assert spec(port)["['adapter']['w']"] == ((64, 256), "float32")
    back = bridge.params_to_numpy(m["tp"])
    for (p, want), got in zip(jax.tree_util.tree_leaves_with_path(m["jp"]),
                              jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(got, np.asarray(want),
                                      err_msg=jax.tree_util.keystr(p))


@pytest.mark.parametrize("which", list(OVER))
def test_forward_and_pooled_match_jax(models, which):
    """Logits of the text positions only (the image's dropped) and
    ``pooled`` over image + text, as the reference; the port's
    ``pooled()`` is ``forward``'s and differs from the text's own mean."""
    m = models[which]
    toks, img = _inputs(m["tcfg"], 2, 12, seed=1)
    jl, ja = J_FORWARD(m["jp"], _jbatch(toks, img), m["jcfg"])
    tl, ta = TT.forward(m["tp"], _tbatch(toks, img), m["tcfg"])
    assert tuple(tl.shape) == (2, 12, m["tcfg"].vocab_size)
    _close(tl, jl, LOGIT_TOL)
    _close(ta["pooled"], ja["pooled"], STATE_TOL)
    pooled = TT.pooled(m["tp"], _tbatch(toks, img), m["tcfg"])
    _close(pooled, ja["pooled"], STATE_TOL)
    text_only = TT.pooled(m["tp"], {"tokens": torch.from_numpy(toks)},
                          m["tcfg"])
    assert (pooled - text_only).abs().max() > 1e-3


@pytest.mark.parametrize("which", list(OVER))
def test_prefill_counts_the_image_and_packs_its_kv(models, which):
    """``prefill``: logits of the text, ``len`` = image + text, and the
    K / V / pos leaves over both, grown to ``cache_len`` with the
    sentinel, as the reference's."""
    m = models[which]
    toks, img = _inputs(m["tcfg"], 1, 10, seed=2)
    jl, jc = J_PREFILL(m["jp"], _jbatch(toks, img), m["jcfg"], cache_len=32)
    tl, tc = TT.prefill(m["tp"], _tbatch(toks, img), m["tcfg"], cache_len=32)
    _close(tl, jl, LOGIT_TOL)
    assert int(tc["len"]) == int(jc["len"]) == 10 + m["tcfg"].n_image_tokens
    assert sorted(tc) == sorted(jc)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape
        _close(tc[name], jc[name], STATE_TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    empty = TT.init_cache(m["tcfg"], 2, 32, device="cpu")
    want = JT.init_cache(m["jcfg"], 2, 32)
    assert {k: tuple(v.shape) for k, v in empty.items()} == \
        {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("which", list(OVER))
def test_three_decode_steps_match_jax(models, which):
    """Two slots prefilled with image + text (18 and 22 positions) in a
    pool of C 24, then three ``decode_step_slots`` steps: slot 1 reaches
    lens 24 = C on the third, where both packages write at C - 1 and
    attend over every entry.  Logits and the pool's leaves each step."""
    m = models[which]
    jcfg, tcfg, c = m["jcfg"], m["tcfg"], 24
    jpool, tpool = jinit_pool(jcfg, 2, c), init_pool_cache(tcfg, 2, c, "cpu")
    for slot, n_text in enumerate((10, 14)):
        toks, img = _inputs(tcfg, 1, n_text, seed=3 + slot)
        _, jcache = J_PREFILL(m["jp"], _jbatch(toks, img), jcfg, cache_len=c)
        _, tcache = TT.prefill(m["tp"], _tbatch(toks, img), tcfg, cache_len=c)
        jpool = jscatter(jpool, jcache, slot)
        scatter_slot(tpool, tcache, slot)
    rng = np.random.default_rng(5)
    for step in range(3):
        toks = rng.integers(0, tcfg.vocab_size, (2, 1)).astype(np.int32)
        jl, jpool = J_DECODE(m["jp"], jpool, {"tokens": jnp.asarray(toks)},
                             jcfg)
        tl, tpool = TT.decode_step_slots(
            m["tp"], tpool, {"tokens": torch.from_numpy(toks)}, tcfg)
        _close(tl, jl, LOGIT_TOL)
        for name in ("k", "v"):
            _close(tpool[name], jpool[name], STATE_TOL)
        np.testing.assert_array_equal(tpool["pos"].numpy(),
                                      np.asarray(jpool["pos"]))
    np.testing.assert_array_equal(tpool["len"].numpy(), [21, 25])
    np.testing.assert_array_equal(np.asarray(jpool["len"]), [21, 25])
    # the writes past the end went to C - 1: its position is the last one
    assert int(tpool["pos"][0, 1, c - 1]) == 24


# ----------------------------------------------------------------------
# the engine
def _reqs(cfg, text_lens, seed=7, max_new=None):
    out = []
    for i, n in enumerate(text_lens):
        toks, img = _inputs(cfg, 1, n, seed=seed + i)
        out.append(Request(rid=i, tokens=tuple(int(t) for t in toks[0]),
                           max_new=max_new,
                           extras=(("image_embeds", img[0]),)))
    return out


def _jreqs(reqs):
    return [JRequest(**dataclasses.asdict(r)) for r in reqs]


def _tokens(recs, reqs):
    return {r.rid: [int(t) for t in recs[r.rid].tokens] for r in reqs}


def _both(m, scfg, reqs):
    eng = ServeEngine(m["tp"], m["tcfg"], scfg, device="cpu")
    jeng = JServeEngine(m["jp"], m["jcfg"],
                        JServeConfig(**dataclasses.asdict(scfg)))
    return eng, eng.serve(reqs), jeng, jeng.serve(_jreqs(reqs))


@pytest.mark.parametrize("which", list(OVER))
def test_served_tokens_with_images_match_jax_engine(models, which):
    """5 requests, each with its own image (8 patch embeddings) and 10 or
    20 text tokens, streaming through 3 slots x 64, M 4: greedy tokens,
    states and ``stats`` as the JAX engine's."""
    m = models[which]
    reqs = _reqs(m["tcfg"], (10, 20, 10, 20, 10))
    eng, recs, jeng, jrecs = _both(m, SCFG, reqs)
    assert _tokens(recs, reqs) == _tokens(jrecs, reqs)
    assert all(recs[r.rid].state == jrecs[r.rid].state == "completed"
               for r in reqs)
    assert eng.stats == jeng.stats


def test_decode_past_cache_len_matches_jax_engine(models):
    """The reference's admission rule counts the text: 30 text tokens + 9
    new + 1 = 40 = cache_len passes, while image + text (38) + 9 runs the
    decode to position 46 of a pool of 40.  Both engines write at C - 1
    from position 39 on; the tokens agree."""
    m = models["dh96"]
    scfg = dataclasses.replace(SCFG, n_slots=2, cache_len=40)
    reqs = _reqs(m["tcfg"], (30, 12), seed=11, max_new=9)
    n_img = m["tcfg"].n_image_tokens
    assert 30 + 9 + 1 <= scfg.cache_len < n_img + 30 + 9
    _, recs, _, jrecs = _both(m, scfg, reqs)
    assert _tokens(recs, reqs) == _tokens(jrecs, reqs)
    assert [len(recs[r.rid].tokens) for r in reqs] == [9, 9]


def test_image_and_text_past_cache_len_fail_at_the_scatter(models):
    """33 text tokens + 6 + 1 = 40 passes the admission rule, but image +
    text (41 positions) cannot fit a slot of 40: the reference's
    ``dynamic_update_slice`` refuses it, and the port's ``scatter_slot``
    raises with the shapes (nothing of the pool written)."""
    m = models["dh64"]
    scfg = dataclasses.replace(SCFG, n_slots=2, cache_len=40)
    reqs = _reqs(m["tcfg"], (33,), seed=13)
    with pytest.raises(TypeError, match="update shape"):
        JServeEngine(m["jp"], m["jcfg"], JServeConfig(
            **dataclasses.asdict(scfg))).serve(_jreqs(reqs))
    eng = ServeEngine(m["tp"], m["tcfg"], scfg, device="cpu")
    before = eng.state["cache"]["k"].clone()
    with pytest.raises(RuntimeError, match="scatter_slot.*40.*41"):
        eng.serve(reqs)
    assert torch.equal(eng.state["cache"]["k"], before)


def test_snapshots_refuse_extras_in_both_packages(models, tmp_path):
    """Extras cannot ride a serve snapshot's JSON header: both packages'
    schedulers refuse while a request with extras is queued, and the
    port's engine raises at its first snapshot."""
    m = models["dh64"]
    reqs = _reqs(m["tcfg"], (10, 10))
    for sched in (FifoScheduler(reqs, 2), JFifo(_jreqs(reqs), 2)):
        with pytest.raises(ValueError, match="extras"):
            sched.to_meta()
    eng = ServeEngine(m["tp"], m["tcfg"], SCFG, device="cpu")
    with pytest.raises(ValueError, match="extras"):
        eng.serve(reqs, snapshot_path=str(tmp_path / "s.npz"),
                  snapshot_every_blocks=1)
