"""The port's audio family (Whisper: an encoder over stub frame embeddings,
a decoder with causal self-attention and cross attention over the
encoder output) against ``repro.models`` and the JAX ``ServeEngine`` in
one process, on the CPU.  Weights are the JAX init carried across with
``bridge.params_from_numpy``; tokens and frame embeddings come from
numpy seeds.  Three configurations of ``reduced(whisper-large-v3)`` (2
encoder + 2 decoder layers, d_model 256, 32 frames): as reduced (4
heads over 2 KV heads, rep 2), at rep 1 (``n_kv_heads`` = ``n_heads``,
Whisper's MHA) and at ``rope_theta`` > 0, where neither package ropes
the encoder or the prefill (the reference's decode step does rope its
self-attention then, and the port follows it).

- ``init_params`` builds the reference's tree (``enc_blocks``, the
  decoder's ``blocks`` with ``self_attn`` / ``cross_attn`` / ``ln3``,
  ``enc_adapter``, ``enc_norm``) and it round-trips through ``bridge``;
- ``sinusoidal_positions``, ``_encoder_forward``, ``gqa_forward(x_cross=)``
  / ``precompute_cross_kv`` / ``gqa_cross_decode``, ``forward`` and
  ``pooled``, ``prefill``'s cache (``cross_k`` / ``cross_v``, ``len`` =
  the text), three ``decode_step_slots`` steps with a masked slot: f32,
  ``LOGIT_TOL`` 1e-4 absolute on logits, ``STATE_TOL`` 1e-5 on states;
- ``ServeEngine`` with ``enc_embeds`` extras: greedy tokens, states and
  ``stats`` identical to the JAX engine's and to the port's
  ``naive_generate``;
- reference caveats: at 1,040 frames (past ``blockwise_attention``'s
  block of 1,024, not a multiple of it) the reference's blockwise
  ``full`` kind lets the zero-padded keys into the softmax, where the
  port, ``direct_attention`` and the Pallas kernel do not; a request
  with another frame count than ``encoder_seq_len`` fails at the port's
  scatter and writes nothing;
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
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.common import sinusoidal_positions as jsinusoid  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeConfig as JServeConfig  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro.serve.pool import init_pool_cache as jinit_pool  # noqa: E402
from repro.serve.pool import scatter_slot as jscatter  # noqa: E402
from repro.serve.scheduler import FifoScheduler as JFifo  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.common import (sinusoid_rows,  # noqa: E402
                                       sinusoidal_positions)
from repro_torch.serve import (Request, ServeConfig,  # noqa: E402
                               ServeEngine)
from repro_torch.serve.engine import naive_generate  # noqa: E402
from repro_torch.serve.pool import (init_pool_cache,  # noqa: E402
                                    scatter_slot)
from repro_torch.serve.scheduler import FifoScheduler  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401

ARCH = "whisper-large-v3"
#: the reduced config (rep 2), Whisper's MHA (rep 1), and RoPE set
OVER = {"rep2": {}, "rep1": dict(n_kv_heads=4),
        "rope": dict(rope_theta=10000.0)}
J_INIT = jax.jit(JT.init_params, static_argnums=1)
J_FORWARD = jax.jit(JT.forward, static_argnums=2)
J_PREFILL = jax.jit(JT.prefill, static_argnums=2, static_argnames="cache_len")
J_DECODE = jax.jit(JT.decode_step_slots, static_argnums=3)
LOGIT_TOL, STATE_TOL = 1e-4, 1e-5
SCFG = ServeConfig(n_slots=3, cache_len=32, block_steps=4, max_new_tokens=8)


def _model(over):
    jcfg = jreduced(jget_config(ARCH)).with_(**over)
    tcfg = reduced(get_config(ARCH)).with_(**over)
    jp = J_INIT(jax.random.PRNGKey(0), jcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp,
                tp=bridge.params_from_numpy(jax.device_get(jp), "cpu"))


@pytest.fixture(scope="module")
def models():
    return {k: _model(v) for k, v in OVER.items()}


def _inputs(cfg, b, n_text, seed, n_frames=None):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, n_text)).astype(np.int32)
    frames = rng.standard_normal((b, n_frames or cfg.encoder_seq_len,
                                  cfg.encoder_embed_dim))
    return toks, frames.astype(np.float32)


def _jbatch(toks, enc):
    return {"tokens": jnp.asarray(toks), "enc_embeds": jnp.asarray(enc)}


def _tbatch(toks, enc):
    return {"tokens": torch.from_numpy(toks),
            "enc_embeds": torch.from_numpy(enc)}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.float()),
                               np.asarray(want, np.float32), atol=tol, rtol=0)


# ----------------------------------------------------------------------
# the model
def test_init_tree_matches_jax_and_round_trips(models):
    """``init_params`` gives the reference's tree in keys, shapes and
    dtypes -- the encoder's dense blocks, the decoder's blocks with self
    and cross attention, the adapter and the encoder norm -- and the JAX
    weights come back bit for bit through the bridge; ``init_cache``
    adds zero ``cross_k`` / ``cross_v`` (L, B, E, KV, dh)."""
    m = models["rep2"]

    def spec(tree):
        return {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
                for p, x in jax.tree_util.tree_leaves_with_path(tree)}
    port = spec(bridge.params_to_numpy(TT.init_params(0, m["tcfg"],
                                                      device="cpu")))
    assert port == spec(m["jp"])
    assert port["['enc_adapter']['w']"] == ((256, 256), "float32")
    assert port["['blocks']['cross_attn']['wk']['w']"] == ((2, 256, 128),
                                                           "float32")
    assert port["['enc_blocks']['attn']['wq']['w']"] == ((2, 256, 256),
                                                         "float32")
    back = bridge.params_to_numpy(m["tp"])
    for (p, want), got in zip(jax.tree_util.tree_leaves_with_path(m["jp"]),
                              jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(got, np.asarray(want),
                                      err_msg=jax.tree_util.keystr(p))
    empty = TT.init_cache(m["tcfg"], 3, 24, device="cpu")
    want = JT.init_cache(m["jcfg"], 3, 24)
    assert {k: tuple(v.shape) for k, v in empty.items()} == \
        {k: v.shape for k, v in want.items()}
    assert tuple(empty["cross_k"].shape) == (2, 3, 32, 2, 64)
    assert not empty["cross_v"].any()


@pytest.mark.parametrize("n,d", [(32, 256), (64, 256), (448, 64)])
def test_sinusoidal_positions_match_jax(n, d):
    """The table (the reference's f32 formula) and the decode step's rows
    at given positions, computed without a table: the rows are the
    table's bit for bit, the table JAX's within ``STATE_TOL``."""
    table = sinusoidal_positions(n, d)
    _close(table, jsinusoid(n, d), STATE_TOL)
    at = torch.tensor([[0, n - 1], [n // 2, 3]])
    assert torch.equal(sinusoid_rows(at, d), table[at])


@pytest.mark.parametrize("which", list(OVER))
def test_encoder_forward_matches_jax(models, which):
    """The adapter, the sinusoid, the full-mask stack without RoPE and
    ``enc_norm`` over 32 frames."""
    m = models[which]
    _, enc = _inputs(m["tcfg"], 2, 1, seed=1)
    want = JT._encoder_forward(m["jp"], {"enc_embeds": jnp.asarray(enc)},
                               m["jcfg"], JT.Runtime())
    got = TT._encoder_forward(m["tp"], {"enc_embeds": torch.from_numpy(enc)},
                              m["tcfg"])
    assert tuple(got.shape) == (2, 32, 256)
    _close(got, want, STATE_TOL)


@pytest.mark.parametrize("which", ["rep2", "rep1"])
def test_cross_attention_paths_agree(models, which):
    """``gqa_forward(x_cross=)`` over 10 encoder frames (T 1 and T 6),
    ``precompute_cross_kv`` and ``gqa_cross_decode`` (the decode kernel's
    plain version over the constant position table) against each other
    and against the reference's, as ``tests/test_attention.py::
    test_cross_attention_decode`` holds the JAX ones."""
    m = models[which]
    cfg, jcfg = m["tcfg"], m["jcfg"]
    p = {k: {"w": m["tp"]["blocks"]["cross_attn"][k]["w"][0]}
         for k in ("wq", "wk", "wv", "wo")}
    jp = {k: {"w": jnp.asarray(v["w"].numpy())} for k, v in p.items()}
    rng = np.random.default_rng(7)
    enc = rng.standard_normal((2, 10, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    te, tx = torch.from_numpy(enc), torch.from_numpy(x)
    cross = TA.precompute_cross_kv(p, te, cfg)
    jcross = JA.precompute_cross_kv(jp, jnp.asarray(enc), jcfg)
    for name in ("k", "v"):
        _close(cross[name], jcross[name], STATE_TOL)
    o1 = TA.gqa_cross_decode(p, tx[:, :1], cross, cfg)
    o2, kv = TA.gqa_forward(p, tx[:, :1], cfg, x_cross=te, return_kv=True)
    _close(o1, o2.detach(), STATE_TOL)
    for name in ("k", "v"):
        assert torch.equal(kv[name], cross[name])
    _close(o1, JA.gqa_cross_decode(jp, jnp.asarray(x[:, :1]), jcross, jcfg),
           STATE_TOL)
    full = TA.gqa_forward(p, tx, cfg, x_cross=te)
    _close(full, JA.gqa_forward(jp, jnp.asarray(x), jcfg,
                                x_cross=jnp.asarray(enc)), STATE_TOL)
    q_pos, kv_pos = TA.cross_positions(2, 10, "cpu")
    assert TA.cross_positions(2, 10, "cpu")[1] is kv_pos
    assert q_pos.tolist() == [9, 9] and kv_pos[1].tolist() == list(range(10))


@pytest.mark.parametrize("which", list(OVER))
def test_forward_and_pooled_match_jax(models, which):
    """Logits of the decoder over 12 tokens and 32 frames, and ``pooled``
    (``forward``'s and the function's)."""
    m = models[which]
    toks, enc = _inputs(m["tcfg"], 2, 12, seed=2)
    jl, ja = J_FORWARD(m["jp"], _jbatch(toks, enc), m["jcfg"])
    tl, ta = TT.forward(m["tp"], _tbatch(toks, enc), m["tcfg"])
    assert tuple(tl.shape) == (2, 12, m["tcfg"].vocab_size)
    _close(tl, jl, LOGIT_TOL)
    _close(ta["pooled"], ja["pooled"], STATE_TOL)
    _close(TT.pooled(m["tp"], _tbatch(toks, enc), m["tcfg"]), ja["pooled"],
           STATE_TOL)


@pytest.mark.parametrize("which", list(OVER))
def test_prefill_cache_matches_jax(models, which):
    """``prefill``: logits, ``len`` = the text's length, the causal K /
    V / pos grown to ``cache_len`` with the sentinel, and ``cross_k`` /
    ``cross_v`` (L, 1, E, KV, dh)."""
    m = models[which]
    toks, enc = _inputs(m["tcfg"], 1, 10, seed=3)
    jl, jc = J_PREFILL(m["jp"], _jbatch(toks, enc), m["jcfg"], cache_len=24)
    tl, tc = TT.prefill(m["tp"], _tbatch(toks, enc), m["tcfg"], cache_len=24)
    _close(tl, jl, LOGIT_TOL)
    assert int(tc["len"]) == int(jc["len"]) == 10
    assert sorted(tc) == sorted(jc)
    for name in ("k", "v", "cross_k", "cross_v"):
        assert tuple(tc[name].shape) == jc[name].shape, name
        _close(tc[name], jc[name], STATE_TOL)
    assert tuple(tc["cross_k"].shape) == (2, 1, 32, m["tcfg"].n_kv_heads, 64)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("which", list(OVER))
def test_three_decode_steps_with_a_masked_slot_match_jax(models, which):
    """Three slots prefilled with 5, 9 and 14 tokens (each its own
    frames) in a pool of C 20, then three ``decode_step_slots`` steps
    with slot 1 masked on the second: logits and every leaf of the pool
    each step; the masked slot's position holds."""
    m = models[which]
    jcfg, tcfg, c = m["jcfg"], m["tcfg"], 20
    jpool, tpool = jinit_pool(jcfg, 3, c), init_pool_cache(tcfg, 3, c, "cpu")
    for slot, n_text in enumerate((5, 9, 14)):
        toks, enc = _inputs(tcfg, 1, n_text, seed=4 + slot)
        _, jcache = J_PREFILL(m["jp"], _jbatch(toks, enc), jcfg, cache_len=c)
        _, tcache = TT.prefill(m["tp"], _tbatch(toks, enc), tcfg, cache_len=c)
        jpool = jscatter(jpool, jcache, slot)
        scatter_slot(tpool, tcache, slot)
    rng = np.random.default_rng(8)
    for step in range(3):
        toks = rng.integers(0, tcfg.vocab_size, (3, 1)).astype(np.int32)
        mask = np.array([True, step != 1, True])
        jl, jpool = J_DECODE(m["jp"], jpool, {"tokens": jnp.asarray(toks)},
                             jcfg, step_mask=jnp.asarray(mask))
        tl, tpool = TT.decode_step_slots(
            m["tp"], tpool, {"tokens": torch.from_numpy(toks)}, tcfg,
            step_mask=torch.from_numpy(mask))
        _close(tl, jl, LOGIT_TOL)
        for name in ("k", "v", "cross_k", "cross_v"):
            _close(tpool[name], jpool[name], STATE_TOL)
        np.testing.assert_array_equal(tpool["pos"].numpy(),
                                      np.asarray(jpool["pos"]))
    np.testing.assert_array_equal(tpool["len"].numpy(), [8, 11, 17])
    np.testing.assert_array_equal(np.asarray(jpool["len"]), [8, 11, 17])


# ----------------------------------------------------------------------
# the engine
def _reqs(cfg, text_lens, seed=9, max_new=None, n_frames=None):
    out = []
    for i, n in enumerate(text_lens):
        toks, enc = _inputs(cfg, 1, n, seed=seed + i, n_frames=n_frames)
        out.append(Request(rid=i, tokens=tuple(int(t) for t in toks[0]),
                           max_new=max_new, extras=(("enc_embeds", enc[0]),)))
    return out


def _jreqs(reqs):
    return [JRequest(**dataclasses.asdict(r)) for r in reqs]


def _tokens(recs, reqs):
    return {r.rid: [int(t) for t in recs[r.rid].tokens] for r in reqs}


@pytest.mark.parametrize("which", ["rep2", "rep1"])
def test_served_tokens_match_jax_engine_and_naive_generate(models, which):
    """5 requests, each with its own 32 frames and 4 or 10 text tokens,
    streaming through 3 slots x 32, M 4: greedy tokens, states and
    ``stats`` as the JAX engine's; the port's ``naive_generate`` (the
    extras stacked into its prefill batch) gives the same tokens for
    the requests of one prompt length."""
    m = models[which]
    reqs = _reqs(m["tcfg"], (4, 10, 4, 10, 4))
    eng = ServeEngine(m["tp"], m["tcfg"], SCFG, device="cpu")
    recs = eng.serve(reqs)
    jeng = JServeEngine(m["jp"], m["jcfg"],
                        JServeConfig(**dataclasses.asdict(SCFG)))
    jrecs = jeng.serve(_jreqs(reqs))
    assert _tokens(recs, reqs) == _tokens(jrecs, reqs)
    assert all(recs[r.rid].state == jrecs[r.rid].state == "completed"
               for r in reqs)
    assert eng.stats == jeng.stats
    same = [r for r in reqs if len(r.tokens) == 4]
    naive = naive_generate(m["tp"], m["tcfg"], same, SCFG)
    assert _tokens(naive, same) == _tokens(recs, same)


def test_another_frame_count_fails_at_the_scatter(models):
    """A request of 24 frames where the pool holds ``encoder_seq_len``
    32: the port's ``scatter_slot`` raises with the shapes and writes
    nothing of the pool (the reference's ``dynamic_update_slice`` writes
    such a request into part of the slot: a reference caveat)."""
    m = models["rep2"]
    reqs = _reqs(m["tcfg"], (6,), seed=13, n_frames=24)
    eng = ServeEngine(m["tp"], m["tcfg"], SCFG, device="cpu")
    before = {k: v.clone() for k, v in eng.state["cache"].items()}
    with pytest.raises(RuntimeError, match="scatter_slot.*32.*24"):
        eng.serve(reqs)
    for name, t in eng.state["cache"].items():
        assert torch.equal(t, before[name]), name


def test_snapshots_refuse_extras_in_both_packages(models, tmp_path):
    """Frame embeddings cannot ride a serve snapshot's JSON header: both
    packages' schedulers refuse while a request with extras is queued,
    and the port's engine raises at its first snapshot."""
    m = models["rep2"]
    reqs = _reqs(m["tcfg"], (4, 4))
    for sched in (FifoScheduler(reqs, 2), JFifo(_jreqs(reqs), 2)):
        with pytest.raises(ValueError, match="extras"):
            sched.to_meta()
    eng = ServeEngine(m["tp"], m["tcfg"], SCFG, device="cpu")
    with pytest.raises(ValueError, match="extras"):
        eng.serve(reqs, snapshot_path=str(tmp_path / "s.npz"),
                  snapshot_every_blocks=1)


# ----------------------------------------------------------------------
# a reference caveat past the blockwise oracle's block
def _fold(x):
    """(B, T, H, dh) -> (B*H, T, dh), the layout of the Pallas kernel."""
    b, t, h, dh = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3)).reshape(b * h, t, dh)


@pytest.mark.parametrize("t,rep", [(1, 1), (6, 2)])
def test_full_mask_past_the_blockwise_block(t, rep):
    """1,040 encoder frames (> 1,024, not a multiple of it), V of mean 3:
    the port's full mask (the flash wrapper's plain version, and
    ``gqa_cross_decode``'s decode route for T 1) equals
    ``direct_attention(kind="full")`` and the Pallas kernel in interpret
    mode, which masks its padded keys; the reference's
    ``blockwise_attention(kind="full")``, which pads S to 2,048 and masks
    the padding by position only, lets 1,008 zero keys into the softmax
    and differs (the reference's ``gqa_cross_decode`` runs it)."""
    s, n_kv, dh = 1040, 2, 64
    h = n_kv * rep
    rng = np.random.default_rng(t + rep)
    q = rng.standard_normal((1, t, h, dh)).astype(np.float32)
    k = rng.standard_normal((1, s, n_kv, dh)).astype(np.float32)
    v = (rng.standard_normal((1, s, n_kv, dh)) + 3.0).astype(np.float32)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=False).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    _close(torch.from_numpy(got), JA.direct_attention(jq, jk, jv, kind="full"),
           STATE_TOL)
    pallas = flash_attention_pallas(
        jnp.asarray(_fold(q)), jnp.asarray(_fold(k)), jnp.asarray(_fold(v)),
        causal=False, n_rep=rep, bq=8, bkv=512, interpret=True)
    _close(torch.from_numpy(_fold(got)), pallas, STATE_TOL)
    blockwise = np.asarray(JA.blockwise_attention(jq, jk, jv, kind="full"))
    assert np.abs(blockwise - got).max() > 0.5
    if t == 1:
        cross = {"k": torch.from_numpy(k), "v": torch.from_numpy(v)}
        q_pos, kv_pos = TA.cross_positions(1, s, "cpu")
        from repro_torch.kernels.decode_attention import decode_attention
        dec = decode_attention(torch.from_numpy(q[:, 0]), cross["k"],
                               cross["v"], q_pos, kv_pos)
        _close(dec, got[:, 0], STATE_TOL)
