"""The single-position decode path of the port against the JAX reference
on the CPU, in one process: ``attention.gqa_decode`` / ``mla_decode``
(one scalar ``len`` for the whole batch) and ``transformer.decode_step``
after ``prefill``, with JAX's weights through ``bridge`` and inputs from
numpy seeds.

- ``init_kv_cache`` is the reference's;
- ``gqa_decode`` over 16-20 steps from an empty cache: a causal linear
  buffer run past its end (the write clamps at C - 1, and the causal mask
  is by position only, so entry 0 stays visible), a sliding ring that
  wraps (as ``tests/test_attention.py:63``) and a chunked ring; the
  output and every cache leaf each step;
- ``mla_decode`` over 12 steps of a buffer of 8: at ``len == C`` and past
  it the write clamps to row C - 1 (the reference's
  ``dynamic_update_slice``), where ``mla_decode_slots`` drops it;
- ``decode_step`` after ``prefill`` for every family the port serves, on
  its ``reduced`` config in f32: dense (qk_norm, under a sliding
  window), vlm with image embeddings (causal), moe (chunked; and MLA),
  ssm, hybrid and audio.  Six steps, the linear buffers run past their
  end; logits within 1e-4 each step, ``len`` and the caches at the
  end.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401

LOGIT_TOL, STATE_TOL = 1e-4, 1e-5
KEY = jax.random.PRNGKey(0)
J_GQA = jax.jit(JA.gqa_decode, static_argnums=3,
                static_argnames=("kind", "window"))
J_MLA = jax.jit(JA.mla_decode, static_argnums=3)
J_INIT = jax.jit(JT.init_params, static_argnums=1)
J_PREFILL = jax.jit(JT.prefill, static_argnums=(2, 3),
                    static_argnames="cache_len")
J_STEP = jax.jit(JT.decode_step, static_argnums=(3, 4))


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol):
    got = got.detach().float().numpy()
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _same_cache(tc, jc, tol=STATE_TOL):
    """Every leaf of two cache trees, matched by key: ints equal, floats
    within ``tol``."""
    if isinstance(jc, dict):
        assert sorted(tc) == sorted(jc)
        for k in jc:
            _same_cache(tc[k], jc[k], tol)
    elif isinstance(jc, (list, tuple)):
        assert len(tc) == len(jc)
        for t, j in zip(tc, jc):
            _same_cache(t, j, tol)
    elif tc.dtype in (torch.int32, torch.int64):
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    else:
        _close(tc, jc, tol)


def test_init_kv_cache_is_the_reference():
    got = TA.init_kv_cache(2, 6, 2, 64, torch.float32)
    want = JA.init_kv_cache(2, 6, 2, 64, jnp.float32)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == bridge._leaf_to_torch(
            np.asarray(want[k]), "cpu").dtype
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# (arch, kind, window, cache_len, steps)
GQA_CASES = {"causal past the end": ("yi-6b", "causal", 0, 8, 16),
             "sliding ring": ("mistral-nemo-12b", "sliding", 8, 8, 20),
             "chunked ring": ("llama4-scout-17b-a16e", "chunked", 6, 6, 14)}


@pytest.mark.parametrize("case", list(GQA_CASES))
def test_gqa_decode_matches_jax(case):
    arch, kind, window, c, steps = GQA_CASES[case]
    jcfg, tcfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jp = jax.device_get(JA.make_gqa(KEY, jcfg, jnp.float32))
    tp = bridge.params_from_numpy(jp, "cpu")
    b = 2
    jc = JA.init_kv_cache(b, c, jcfg.n_kv_heads, jcfg.head_dim, jnp.float32)
    tc = TA.init_kv_cache(b, c, tcfg.n_kv_heads, tcfg.head_dim,
                          torch.float32)
    x = np.random.default_rng(1).standard_normal(
        (steps, b, 1, tcfg.d_model)).astype(np.float32)
    for i in range(steps):
        jo, jc = J_GQA(jp, jnp.asarray(x[i]), jc, jcfg, kind=kind,
                       window=window)
        to, tc = TA.gqa_decode(tp, _t(x[i]), tc, tcfg, kind=kind,
                               window=window)
        _close(to, jo, 1e-5)
        _same_cache(tc, jc)
    assert int(tc["len"]) == int(jc["len"]) == steps
    if kind == "causal":            # entry C - 1 holds the last position
        np.testing.assert_array_equal(tc["pos"][:, -1].numpy(), steps - 1)


def test_mla_decode_clamps_the_write_at_the_end():
    """12 steps over a latent buffer of 8: from ``len == C`` on, the new
    latent and rope key overwrite row C - 1 and every row is visible, as
    in the reference; ``mla_decode_slots`` at the same position drops
    the write instead."""
    arch = "deepseek-v2-236b"
    jcfg, tcfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jp = jax.device_get(JA.make_mla(KEY, jcfg, jnp.float32))
    tp = bridge.params_from_numpy(jp, "cpu")
    b, c, steps = 2, 8, 12
    jc = JA.init_mla_cache(b, c, jcfg, jnp.float32)
    tc = TA.init_mla_cache(b, c, tcfg, torch.float32)
    x = np.random.default_rng(2).standard_normal(
        (steps, b, 1, tcfg.d_model)).astype(np.float32)
    for i in range(steps):
        if i == c:                  # the slot path's drop, from this state
            slot = {k: tc[k].clone() for k in ("c_kv", "k_rope")}
            TA.mla_decode_slots(tp, _t(x[i]), dict(
                slot, lens=torch.full((b,), c, dtype=torch.int32)), tcfg)
            for k in slot:
                np.testing.assert_array_equal(slot[k].numpy(),
                                              tc[k].numpy())
        before = tc["c_kv"][:, -1].clone()
        jo, jc = J_MLA(jp, jnp.asarray(x[i]), jc, jcfg)
        to, tc = TA.mla_decode(tp, _t(x[i]), tc, tcfg)
        _close(to, jo, 1e-5)
        _same_cache(tc, jc)
        if i >= c - 1:              # the clamped write lands on row C - 1
            assert not torch.equal(tc["c_kv"][:, -1], before)
    assert int(tc["len"]) == int(jc["len"]) == steps


# (arch, Runtime window_override)
FAMILIES = {"dense sliding": ("qwen3-32b", 6),
            "vlm": ("phi-3-vision-4.2b", 0),
            "moe": ("llama4-scout-17b-a16e", 0),
            "moe MLA": ("deepseek-v2-236b", 0),
            "ssm": ("falcon-mamba-7b", 0),
            "hybrid": ("recurrentgemma-9b", 0),
            "audio": ("whisper-large-v3", 0)}


def _batch(cfg, b, s, rng):
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.standard_normal(
            (b, cfg.n_image_tokens, cfg.image_embed_dim)).astype(np.float32)
    if cfg.family == "audio":
        batch["enc_embeds"] = rng.standard_normal(
            (b, cfg.encoder_seq_len, cfg.encoder_embed_dim)).astype(
                np.float32)
    return batch


@pytest.mark.parametrize("family", list(FAMILIES))
def test_decode_step_after_prefill_matches_jax(family):
    arch, window = FAMILIES[family]
    jcfg, tcfg = jreduced(jget_config(arch)), reduced(get_config(arch))
    jrt = JT.Runtime(window_override=window)
    trt = TT.Runtime(window_override=window)
    jp = jax.device_get(J_INIT(KEY, jcfg))
    tp = bridge.params_from_numpy(jp, "cpu")
    rng = np.random.default_rng(3)
    b, s, steps = 2, 10, 6
    batch = _batch(tcfg, b, s, rng)
    # four positions of room: the linear buffers run past their end
    c = s + 4 + (tcfg.n_image_tokens if family == "vlm" else 0)
    jl, jc = J_PREFILL(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                       jcfg, jrt, cache_len=c)
    tl, tc = TT.prefill(tp, {k: _t(v) for k, v in batch.items()}, tcfg,
                        cache_len=c, rt=trt)
    _close(tl, jl, LOGIT_TOL)
    for i in range(steps):
        tok = rng.integers(0, tcfg.vocab_size, (b, 1)).astype(np.int32)
        jl, jc = J_STEP(jp, jc, {"tokens": jnp.asarray(tok)}, jcfg, jrt)
        tl, tc = TT.decode_step(tp, tc, {"tokens": _t(tok)}, tcfg, rt=trt)
        assert tuple(tl.shape) == (b, 1, tcfg.vocab_size)
        _close(tl, jl, LOGIT_TOL)
    assert int(tc["len"]) == int(jc["len"]) == c - 4 + steps
    assert tc["len"].dtype == torch.int32 and tc["len"].dim() == 0
    _same_cache(tc, jc, 1e-4)
