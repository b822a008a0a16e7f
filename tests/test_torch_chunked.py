"""llama4's chunked attention in the port, on the CPU, against the JAX
package in one process from numpy inputs (f32, tolerance 1e-4 relative
to max(1, |value|)):

- ``flash_attention_ref(chunk=)`` against ``blockwise_attention(kind=
  "chunked")`` for chunks 48, 64 and 100 with T crossing 2-3 chunk
  boundaries, B 3, and with T < S (the bottom-right alignment: the rule
  reads the query's position q + (S - T));
- ``decode_attention_ref(chunk=)`` over a ring as wide as the chunk whose
  slots sit just before, on and after a chunk boundary (a slot at the
  boundary sees only itself, the ring still holding the earlier chunk's
  entries), against the blockwise chunked kind; and the decode kernel's
  design -- the chunk as a per-slot window of q_pos % chunk + 1, split
  and combine passes emulated over ``split_plan``'s chunks of the pool;
- the chunked flash gradient against ``jax.grad`` of the blockwise
  version;
- ``gqa_forward`` and ``gqa_decode_slots`` of kind ``chunked``;
- the moe model ``reduced(llama4-scout-17b-a16e)`` (2 layers, chunk 64):
  ``forward`` (logits, ``load_balance``, ``router_z``), ``prefill``
  (logits and the ring cache leaf by leaf), ``init_cache`` and
  ``decode_step_slots`` with a ``step_mask``, prompts of 70-200 tokens;
- the sliding and chunked masks refuse to be set together.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.attention import blockwise_attention  # noqa: E402
from repro.serve.pool import init_pool_cache as jinit_pool  # noqa: E402
from repro.serve.pool import scatter_slot as jscatter  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, split_bounds, split_plan)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve.pool import init_pool_cache, scatter_slot  # noqa: E402
from test_torch_attention_split import _pool, _two_pass  # noqa: E402
from test_torch_hybrid import _assert_same_tree, _close  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401


ARCH = "llama4-scout-17b-a16e"
J_FORWARD = jax.jit(JT.forward, static_argnums=(2,))
J_PREFILL = jax.jit(JT.prefill, static_argnums=(2,),
                    static_argnames="cache_len")
J_DECODE = jax.jit(JT.decode_step_slots, static_argnums=(3,))


def _rnd(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _qkv(seed, b, t, s, h, n_kv, dh):
    return (_rnd(seed, (b, t, h, dh)), _rnd(seed + 1, (b, s, n_kv, dh)),
            _rnd(seed + 2, (b, s, n_kv, dh)))


def _jax_chunked(q, k, v, chunk):
    """blockwise_attention's chunked kind, query t at position t + (S - T)
    as the kernels align it."""
    t, s = q.shape[1], k.shape[1]
    qp = jnp.arange(s - t, s, dtype=jnp.int32)[None].repeat(q.shape[0], 0)
    return blockwise_attention(q, k, v, kind="chunked", window=chunk,
                               q_positions=qp, kv_block=32)


# ----------------------------------------------------------------------
# flash
@pytest.mark.parametrize("chunk,t,s", [(48, 130, 130), (64, 170, 170),
                                       (100, 260, 260), (48, 70, 230),
                                       (100, 70, 250)])
def test_flash_ref_chunked_matches_blockwise(chunk, t, s):
    """B 3; T = S crossing 2 or 3 boundaries, or T < S (bottom-right)."""
    q, k, v = _qkv(chunk + t, 3, t, s, 4, 2, 64)
    got = tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                   chunk=chunk)
    _close(got, _jax_chunked(*map(jnp.asarray, (q, k, v)), chunk))
    assert (s - 1) // chunk - (s - t) // chunk >= 1     # crosses a boundary


def test_flash_chunked_backward_matches_jax_grad():
    """The wrapper's gradient (plain recompute with the chunk) against
    jax.grad of blockwise_attention, for q, k and v, from one cotangent."""
    q, k, v = _qkv(21, 2, 90, 90, 4, 2, 64)
    cot = _rnd(24, q.shape)
    chunk = 40
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention(*leaves, chunk=chunk)
    (out * torch.from_numpy(cot)).sum().backward()

    def loss(q, k, v):
        return (_jax_chunked(q, k, v, chunk) * cot).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    _close(out.detach(), _jax_chunked(*map(jnp.asarray, (q, k, v)), chunk))
    for got, w in zip(leaves, want):
        _close(got.grad, w)


# ----------------------------------------------------------------------
# decode over a ring as wide as the chunk
def _ring(chunk, seed=5):
    """Slots at positions chunk - 2, chunk - 1 (just before the boundary),
    chunk (on it: sees only itself), chunk + 1, 2 chunk + 5 and 3; a ring
    of ``chunk`` entries."""
    lens = [chunk - 1, chunk, chunk + 1, chunk + 2, 2 * chunk + 6, 4]
    return _pool(seed, len(lens), chunk, 2, 2, 64, lens, window=chunk)


@pytest.mark.parametrize("chunk", [48, 64, 100])
def test_decode_ref_chunked_ring_matches_blockwise(chunk):
    q, k, v, q_pos, pos = _ring(chunk)
    got = tref.decode_attention_ref(*map(torch.from_numpy,
                                         (q, k, v, q_pos, pos)), chunk=chunk)
    want = blockwise_attention(
        jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
        kind="chunked", window=chunk, q_positions=jnp.asarray(q_pos)[:, None],
        kv_positions=jnp.asarray(pos))[:, 0]
    _close(got, want)
    # the slot on the boundary sees one entry: its own V, per KV head
    on = 2
    slot_v = v[on, q_pos[on] % chunk]                    # (KV, dh)
    np.testing.assert_allclose(got[on].numpy(),
                               np.repeat(slot_v, 2, axis=0), atol=1e-6)
    np.testing.assert_array_equal(
        decode_attention(*map(torch.from_numpy, (q, k, v, q_pos, pos)),
                         chunk=chunk).numpy(), got.numpy())


def test_decode_kernel_design_chunk_as_a_per_slot_window():
    """The kernel's rule: slot s's chunk becomes the window q_pos % chunk
    + 1; its split and combine passes, emulated slot by slot over the
    chunks ``split_plan`` cuts a 256-wide ring into (the chunks before the
    slot's chunk start wholly masked), give the chunked attention."""
    chunk = 256
    q, k, v, q_pos, pos = map(torch.from_numpy, _ring(chunk, seed=9))
    n_split, split_len = split_plan(q.shape[0], 2, chunk, 64, 2)
    assert n_split > 1
    bounds = split_bounds(chunk, n_split, split_len)
    want = tref.decode_attention_ref(q, k, v, q_pos, pos, chunk=chunk)
    for s in range(q.shape[0]):
        win = int(q_pos[s]) % chunk + 1
        one = [x[s:s + 1] for x in (q, k, v, q_pos, pos)]
        _close(_two_pass(*one, win, bounds), want[s:s + 1])


# ----------------------------------------------------------------------
# the GQA module and the moe model
@pytest.fixture(scope="module")
def scout():
    jcfg, tcfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    assert jcfg.attention_chunk == tcfg.attention_chunk == 64
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in (200, 127, 128, 70)]
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp,
                tp=bridge.params_from_numpy(jax.device_get(jp), "cpu"),
                prompts=prompts)


def _layer0(tree):
    return jax.tree_util.tree_map(lambda x: x[0], tree)


def test_gqa_forward_chunked_matches_jax(scout):
    jcfg, tcfg = scout["jcfg"], scout["tcfg"]
    jp = _layer0(scout["jp"]["blocks"]["attn"])
    tp = bridge.params_from_numpy(jax.device_get(jp), "cpu")
    x = _rnd(3, (2, 150, jcfg.d_model))
    jy, jkv = jattn.gqa_forward(jp, jnp.asarray(x), jcfg, kind="chunked",
                                window=64, return_kv=True)
    ty, tkv = tattn.gqa_forward(tp, torch.from_numpy(x), tcfg,
                                kind="chunked", window=64, return_kv=True)
    _close(ty, jy)
    _close(tkv["k"], jkv["k"])


def test_gqa_decode_slots_chunked_matches_jax(scout):
    """Slots around the boundary of the 64-chunk over a 64-entry ring: the
    write goes to ring index lens % 64, and the read keeps to the chunk."""
    jcfg, tcfg = scout["jcfg"], scout["tcfg"]
    jp = _layer0(scout["jp"]["blocks"]["attn"])
    tp = bridge.params_from_numpy(jax.device_get(jp), "cpu")
    _, k, v, q_pos, pos = _ring(64, seed=13)
    lens = (q_pos + 1).astype(np.int32)                  # the next position
    x = _rnd(14, (len(lens), 1, jcfg.d_model))
    jout, jc = jattn.gqa_decode_slots(
        jp, jnp.asarray(x), {"k": jnp.asarray(k), "v": jnp.asarray(v),
                             "pos": jnp.asarray(pos),
                             "lens": jnp.asarray(lens)},
        jcfg, kind="chunked", window=64)
    tc = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
          "pos": torch.from_numpy(pos.copy()),
          "lens": torch.from_numpy(lens)}
    tout, tc = tattn.gqa_decode_slots(tp, torch.from_numpy(x), tc, tcfg,
                                      kind="chunked", window=64)
    _close(tout, jout)
    for key in ("k", "v"):
        _close(tc[key], jc[key])
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    np.testing.assert_array_equal(tc["lens"].numpy(), lens + 1)


def test_forward_matches_jax_with_router_aux(scout):
    toks = np.stack([scout["prompts"][0][:150], scout["prompts"][0][50:]])
    jl, jaux = J_FORWARD(scout["jp"], {"tokens": jnp.asarray(toks)},
                         scout["jcfg"])
    tl, taux = TT.forward(scout["tp"], {"tokens": torch.from_numpy(toks)},
                          scout["tcfg"])
    _close(tl, jl)
    for key in ("load_balance", "router_z", "pooled"):
        _close(taux[key], jaux[key])
    assert float(taux["router_z"]) > 0
    dense = reduced(get_config("fedmm-base"))
    _, daux = TT.forward(TT.init_params(0, dense, device="cpu"),
                         {"tokens": torch.from_numpy(toks) % 512}, dense)
    assert float(daux["load_balance"]) == float(daux["router_z"]) == 0.0


def test_prefill_ring_cache_matches_jax(scout):
    """200 tokens: the ring of 64 holds positions 192-199 of the last
    chunk and 136-191 of the one before it, as the reference packs it."""
    toks = scout["prompts"][0][None]
    jl, jc = J_PREFILL(scout["jp"], {"tokens": jnp.asarray(toks)},
                       scout["jcfg"], cache_len=256)
    tl, tc = TT.prefill(scout["tp"], {"tokens": torch.from_numpy(toks)},
                        scout["tcfg"], cache_len=256)
    _close(tl, jl)
    _assert_same_tree(tc, jc)
    assert tc["k"].shape[2] == 64


def test_init_cache_matches_jax(scout):
    for cache_len in (32, 256):
        _assert_same_tree(
            TT.init_cache(scout["tcfg"], 3, cache_len, device="cpu"),
            JT.init_cache(scout["jcfg"], 3, cache_len))


def test_decode_step_slots_matches_jax(scout):
    """Four slots at positions 200, 127 (one before a boundary), 128 (on
    it) and 70; three steps, the second freezing slot 1: logits, every
    pool leaf and the positions agree."""
    jcfg, tcfg, jp, tp = (scout[k] for k in ("jcfg", "tcfg", "jp", "tp"))
    cache_len, n_slots = 256, 4
    jpool = jinit_pool(jcfg, n_slots, cache_len)
    tpool = init_pool_cache(tcfg, n_slots, cache_len, device="cpu")
    for slot, toks in enumerate(scout["prompts"]):
        _, jc = J_PREFILL(jp, {"tokens": jnp.asarray(toks)[None]}, jcfg,
                          cache_len=cache_len)
        _, tc = TT.prefill(tp, {"tokens": torch.from_numpy(toks)[None]},
                           tcfg, cache_len=cache_len)
        jpool = jscatter(jpool, jc, jnp.asarray(slot, jnp.int32))
        scatter_slot(tpool, tc, slot)
    rng = np.random.default_rng(7)
    for step in range(3):
        mask = np.array([True, step != 1, True, True])
        toks = rng.integers(0, jcfg.vocab_size, (n_slots, 1)).astype(np.int32)
        jl, jpool = J_DECODE(jp, jpool, {"tokens": jnp.asarray(toks)}, jcfg,
                             step_mask=jnp.asarray(mask))
        tl, tpool = TT.decode_step_slots(
            tp, tpool, {"tokens": torch.from_numpy(toks)}, tcfg,
            step_mask=torch.from_numpy(mask))
        _close(tl, jl)
    _assert_same_tree(tpool, jpool)
    np.testing.assert_array_equal(tpool["len"].numpy(), [203, 129, 131, 73])


def test_window_and_chunk_exclude_each_other():
    q = torch.zeros((1, 4, 2, 64))
    kv = q[:, :, :1]
    pos = torch.zeros((1,), dtype=torch.int32)
    kv_pos = torch.zeros((1, 4), dtype=torch.int32)
    for call in (lambda: fa.flash_attention(q, kv, kv, window=3, chunk=4),
                 lambda: fa._check(q, kv, kv, 3, 4),
                 lambda: decode_attention(q[:, 0], kv, kv, pos, kv_pos,
                                          window=3, chunk=4)):
        with pytest.raises(ValueError, match="exclude|not both"):
            call()
    with pytest.raises(ValueError, match="chunk"):
        fa._check(q, kv, kv, 0, -1)
    assert tattn._mask_spec("full", 0) == {"causal": False, "window": 0,
                                           "chunk": 0}
    with pytest.raises(NotImplementedError, match="full"):
        tattn._mask_spec("bidirectional", 0)
