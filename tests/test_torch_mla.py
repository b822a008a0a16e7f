"""DeepSeek-V2's multi-head latent attention (MLA) in the port against the
JAX reference on the CPU, in one process.  ``reduced(deepseek-v2-236b)``
(2 layers, d_model 256, 4 heads, kv_lora 64, q_lora 48, rope 32, nope
64, v 64, 4 experts top-2 + 1 shared; f32) and the same with
``q_lora_rank=0`` (the ``wq`` query path); JAX weights cross through
``bridge.params_from_numpy``, inputs come from numpy seeds.

- ``make_mla``'s tree (keys and shapes) is the reference's;
- ``mla_forward`` (output and ``return_kv``) and ``mla_decode_slots`` at
  mixed per-slot ``lens`` -- 0, mid-buffer, C - 1 and C, where the
  reference drops the write and every entry is visible -- against
  ``repro.models.attention`` (1e-5 of the output's scale: f32 sums in
  another order);
- the plain twins: ``flash_attention_ref`` at dqk != dv against
  ``repro.kernels.ref.flash_attention_ref(scale=)`` and
  ``mla_decode_ref`` against the reference's einsums (1e-5);
- the ``mla_decode`` wrapper's CPU route, its shape checks and
  ``split_plan``; the flash wrapper's (dh, dv) check;
- ``init_cache``, ``prefill`` and ``decode_step_slots`` against
  ``repro.models.transformer`` (logits 1e-4 of max |logit|, caches
  1e-5).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import mla_decode as md  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401

ARCH = "deepseek-v2-236b"


def _cfgs(q_lora):
    jcfg, tcfg = jreduced(jget_config(ARCH)), reduced(get_config(ARCH))
    if q_lora is not None:
        jcfg = jcfg.with_(mla=dataclasses.replace(jcfg.mla,
                                                  q_lora_rank=q_lora))
        tcfg = tcfg.with_(mla=dataclasses.replace(tcfg.mla,
                                                  q_lora_rank=q_lora))
    return jcfg, tcfg


@pytest.fixture(scope="module", params=[None, 0], ids=["q_lora", "wq"])
def model(request):
    jcfg, tcfg = _cfgs(request.param)
    jp = jax.jit(JT.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                   jcfg)
    jp = jax.device_get(jp)
    return dict(jcfg=jcfg, tcfg=tcfg, jp=jp,
                tp=bridge.params_from_numpy(jp, "cpu"),
                jattn=jax.tree_util.tree_map(lambda w: w[0],
                                             jp["blocks"]["attn"]))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want, tol):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol, err


def _scale(x):
    return max(1.0, float(np.abs(np.asarray(x)).max()))


# ----------------------------------------------------------------------
@pytest.mark.parametrize("q_lora", [None, 0], ids=["q_lora", "wq"])
def test_make_mla_tree_matches_reference(q_lora):
    jcfg, tcfg = _cfgs(q_lora)
    want = jax.eval_shape(lambda: JA.make_mla(jax.random.PRNGKey(0), jcfg,
                                              jnp.float32))
    got = TA.make_mla(torch.Generator().manual_seed(0), tcfg, torch.float32)
    assert set(got) == set(want)
    assert ("wq_a" in got) == bool(tcfg.mla.q_lora_rank)
    for name, sub in want.items():
        assert set(got[name]) == set(sub), name
        for leaf, w in sub.items():
            assert tuple(got[name][leaf].shape) == tuple(w.shape), name


def test_mla_forward_matches_reference(model):
    cfg, p = model["tcfg"], model["jattn"]
    x = np.random.default_rng(1).normal(size=(2, 37, cfg.d_model)).astype(
        np.float32)
    jy, jkv = JA.mla_forward(p, jnp.asarray(x), model["jcfg"],
                             return_kv=True)
    ty, tkv = TA.mla_forward(bridge.params_from_numpy(p, "cpu"), _t(x), cfg,
                             return_kv=True)
    _close(ty, jy, 1e-5 * _scale(jy))
    assert set(tkv) == {"c_kv", "k_rope"}
    for name in tkv:
        _close(tkv[name], jkv[name], 1e-5 * _scale(jkv[name]))
    # without return_kv, the output alone
    _close(TA.mla_forward(bridge.params_from_numpy(p, "cpu"), _t(x), cfg),
           jy, 1e-5 * _scale(jy))


def test_mla_forward_gradient_flows(model):
    """The flash wrapper's backward (plain recompute) at dqk != dv: every
    attention weight gets a finite gradient."""
    cfg = model["tcfg"]
    tp = bridge.params_from_numpy(model["jattn"], "cpu")
    for leaf in (lin["w"] if "w" in lin else lin["scale"]
                 for lin in tp.values()):
        leaf.requires_grad_(True)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 9, cfg.d_model)).astype(np.float32))
    TA.mla_forward(tp, x, cfg).square().mean().backward()
    for name, lin in tp.items():
        g = (lin["w"] if "w" in lin else lin["scale"]).grad
        assert g is not None and bool(torch.isfinite(g).all()), name
    assert float(tp["w_ukv"]["w"].grad.abs().max()) > 0


@pytest.mark.parametrize("lens", [[0, 5, 15, 16], [16, 16, 1, 9]])
def test_mla_decode_slots_matches_reference(model, lens):
    """Mixed per-slot positions over a pool of C 16: a slot at 0, mid
    buffer, at C - 1 and at C (the reference drops that write and shows
    all 16 entries); output, caches and lens."""
    cfg, p = model["tcfg"], model["jattn"]
    m = cfg.mla
    rng = np.random.default_rng(3 + lens[0])
    s, c = len(lens), 16
    x = rng.normal(size=(s, 1, cfg.d_model)).astype(np.float32)
    ckv = rng.normal(size=(s, c, m.kv_lora_rank)).astype(np.float32)
    kr = rng.normal(size=(s, c, m.rope_head_dim)).astype(np.float32)
    ln = np.array(lens, dtype=np.int32)
    jy, jc = JA.mla_decode_slots(p, jnp.asarray(x), {
        "c_kv": jnp.asarray(ckv), "k_rope": jnp.asarray(kr),
        "lens": jnp.asarray(ln)}, model["jcfg"])
    cache = {"c_kv": _t(ckv.copy()), "k_rope": _t(kr.copy()), "lens": _t(ln)}
    ty, tc = TA.mla_decode_slots(bridge.params_from_numpy(p, "cpu"), _t(x),
                                 cache, cfg)
    _close(ty, jy, 1e-5 * _scale(jy))
    assert tc["c_kv"] is cache["c_kv"]                  # written in place
    for name in ("c_kv", "k_rope"):
        _close(tc[name], jc[name], 1e-5 * _scale(jc[name]))
    full = [i for i, n in enumerate(lens) if n == c]
    np.testing.assert_array_equal(tc["c_kv"].numpy()[full], ckv[full])
    np.testing.assert_array_equal(tc["lens"].numpy(), np.asarray(jc["lens"]))


def test_init_mla_cache_matches_reference():
    jcfg, tcfg = _cfgs(None)
    want = JA.init_mla_cache(3, 20, jcfg, jnp.float32)
    got = TA.init_mla_cache(3, 20, tcfg, torch.float32)
    assert set(got) == set(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == tuple(leaf.shape), name
        assert not bool(got[name].any()), name


# ----------------------------------------------------------------------
# the plain twins
@pytest.mark.parametrize("t,s", [(24, 24), (7, 30)])
def test_flash_ref_dqk_ne_dv_matches_reference(t, s):
    """q / k 96 wide, v 64: (B, T, H, dv) out, scores scaled by dqk^-0.5,
    causal bottom-right, against the JAX oracle at ``scale=``."""
    rng = np.random.default_rng(t + s)
    q = rng.normal(size=(2, t, 4, 96)).astype(np.float32)
    k = rng.normal(size=(2, s, 4, 96)).astype(np.float32)
    v = rng.normal(size=(2, s, 4, 64)).astype(np.float32)
    got = ref.flash_attention_ref(_t(q), _t(k), _t(v))
    assert tuple(got.shape) == (2, t, 4, 64)

    def fold(a):                                   # (B, S, H, d) -> (BH, S, d)
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(-1, *a.shape[1::2]))
    want = jref.flash_attention_ref(fold(q), fold(k), fold(v),
                                    scale=96 ** -0.5)
    want = np.asarray(want).reshape(2, 4, t, 64).transpose(0, 2, 1, 3)
    _close(got, want, 1e-5)
    # the wrapper's CPU route is the plain twin
    _close(fa.flash_attention(_t(q), _t(k), _t(v)), got, 0.0)


def _mla_einsums(q_c, q_rope, c_kv, k_rope, lens, scale):
    """The attention of ``repro.models.attention.mla_decode_slots`` (its
    lines after the cache write), in jnp."""
    sc = (jnp.einsum("bhc,bsc->bhs", q_c, c_kv,
                     preferred_element_type=jnp.float32)
          + jnp.einsum("bhd,bsd->bhs", q_rope, k_rope,
                       preferred_element_type=jnp.float32)) * scale
    valid = jnp.arange(c_kv.shape[1])[None, None, :] <= lens[:, None, None]
    sc = jnp.where(valid, sc, -1e30)
    alpha = jax.nn.softmax(sc, axis=-1).astype(c_kv.dtype)
    return jnp.einsum("bhs,bsc->bhc", alpha, c_kv)


@pytest.mark.parametrize("c,lens", [(40, [0, 7, 39, 40]), (1, [0, 1])])
def test_mla_decode_ref_matches_reference_einsums(c, lens):
    rng = np.random.default_rng(c)
    s, h = len(lens), 32
    args = [rng.normal(size=shape).astype(np.float32) for shape in
            ((s, h, 64), (s, h, 32), (s, c, 64), (s, c, 32))]
    ln = np.array(lens, dtype=np.int32)
    scale = 96 ** -0.5
    want = _mla_einsums(*map(jnp.asarray, args), jnp.asarray(ln), scale)
    got = ref.mla_decode_ref(*map(_t, args), _t(ln), scale)
    _close(got, want, 1e-5)
    _close(md.mla_decode(*map(_t, args), _t(ln), scale), got, 0.0)


# ----------------------------------------------------------------------
# the wrappers' checks and the split plan
def test_mla_decode_split_plan_covers_the_pool():
    """DeepSeek-V2's pool (S 8, C 4,352, H 128) splits into 8 chunks of
    544 (512 blocks, >= two per SM); every plan's chunks are whole tiles
    and cover C once; tiny pools run one chunk."""
    assert md.split_plan(8, 128, 4352) == (8, 544)
    assert md.split_plan(8, 128, 4352)[0] * 8 * 128 // 16 >= \
        md.TARGET_BLOCKS
    assert md.split_plan(1, 128, 1)[0] == 1
    assert md.split_plan(64, 128, 4352)[0] == 1          # the slots fill it
    for s, h, c in ((8, 128, 1000), (1, 16, 4352), (3, 128, 257),
                    (2, 64, 100_000), (8, 128, 31)):
        n, length = md.split_plan(s, h, c)
        assert length % md.TILE == 0
        assert n == 1 or (n - 1) * length < c
        assert n == 1 or length >= md.MIN_CHUNK_TILES * md.TILE


@pytest.mark.parametrize("what", ["kvr", "rd", "heads", "dtype", "lens"])
def test_mla_decode_check_refuses_other_shapes(what):
    s, h, c, kvr, rd = 2, 32, 8, 512, 64
    shapes = {"kvr": (s, h, c, 256, rd), "rd": (s, h, c, kvr, 32),
              "heads": (s, 24, c, kvr, rd)}.get(what, (s, h, c, kvr, rd))
    s, h, c, kvr, rd = shapes
    args = [torch.zeros(x) for x in ((s, h, kvr), (s, h, rd), (s, c, kvr),
                                      (s, c, rd))]
    lens = torch.zeros((s,), dtype=torch.int32)
    if what == "dtype":
        args[2] = args[2].to(torch.bfloat16)
    if what == "lens":
        lens = lens.long()
    err = TypeError if what in ("dtype", "lens") else ValueError
    with pytest.raises(err):
        md._check(*args, lens)
    if what == "kvr":                               # the CPU route has none
        assert md.mla_decode(*args, lens, 1.0).shape == (s, h, kvr)


@pytest.mark.parametrize("dqk,dv,ok", [(192, 128, True), (128, 128, True),
                                       (192, 192, False), (128, 192, False),
                                       (96, 64, False)])
def test_flash_check_takes_built_head_dim_pairs(dqk, dv, ok):
    q = torch.zeros((1, 4, 2, dqk))
    k = torch.zeros((1, 4, 2, dqk))
    v = torch.zeros((1, 4, 2, dv))
    if ok:
        fa._check(q, k, v, 0)
    else:
        with pytest.raises(ValueError, match="dh"):
            fa._check(q, k, v, 0)


# ----------------------------------------------------------------------
# the transformer
def _prompt(cfg, n, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, n)).astype(np.int32)


def test_prefill_matches_reference(model):
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    toks = _prompt(tcfg, 23, 4)
    jl, jc = JT.prefill(model["jp"], {"tokens": jnp.asarray(toks)}, jcfg,
                        cache_len=40)
    tl, tc = TT.prefill(model["tp"], {"tokens": _t(toks)}, tcfg,
                        cache_len=40)
    _close(tl, jl, 1e-4 * _scale(jl))
    assert set(tc) == set(jc) == {"c_kv", "k_rope", "len"}
    for name in ("c_kv", "k_rope"):
        assert tuple(tc[name].shape) == tuple(jc[name].shape)
        _close(tc[name], jc[name], 1e-5 * _scale(jc[name]))
    assert int(tc["len"]) == int(jc["len"]) == 23


def test_init_cache_matches_reference(model):
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    want = JT.init_cache(jcfg, 3, 24)
    got = TT.init_cache(tcfg, 3, 24, device="cpu")
    assert set(got) == set(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == tuple(leaf.shape), name
        assert str(got[name].dtype).split(".")[-1] == str(leaf.dtype), name


def test_decode_step_slots_matches_reference(model):
    """Two prompts prefilled into a 3-slot pool (one slot empty), then 3
    decode steps with a frozen slot in the second: logits and caches as
    the reference's, the caches updated in place."""
    from repro.serve.pool import init_pool_cache as jpool
    from repro.serve.pool import scatter_slot as jscatter
    from repro_torch.serve import init_pool_cache, scatter_slot
    jcfg, tcfg = model["jcfg"], model["tcfg"]
    jc, tc = jpool(jcfg, 3, 32), init_pool_cache(tcfg, 3, 32, device="cpu")
    for slot, n in ((0, 9), (2, 14)):
        toks = _prompt(tcfg, n, 10 + n)
        _, jr = JT.prefill(model["jp"], {"tokens": jnp.asarray(toks)}, jcfg,
                           cache_len=32)
        _, tr = TT.prefill(model["tp"], {"tokens": _t(toks)}, tcfg,
                           cache_len=32)
        jc = jscatter(jc, jr, slot)
        scatter_slot(tc, tr, slot)
    rng = np.random.default_rng(5)
    jstep = jax.jit(JT.decode_step_slots, static_argnums=3)
    for step in range(3):
        toks = rng.integers(0, tcfg.vocab_size, (3, 1)).astype(np.int32)
        mask = np.array([True, step != 1, True])
        jl, jc = jstep(model["jp"], jc, {"tokens": jnp.asarray(toks)}, jcfg,
                       step_mask=jnp.asarray(mask))
        buf = tc["c_kv"]
        tl, tc = TT.decode_step_slots(model["tp"], tc, {"tokens": _t(toks)},
                                      tcfg, step_mask=_t(mask))
        assert tc["c_kv"] is buf
        _close(tl, jl, 1e-4 * _scale(jl))
        for name in ("c_kv", "k_rope"):
            _close(tc[name], jc[name], 1e-5 * _scale(jc[name]))
        np.testing.assert_array_equal(tc["len"].numpy(),
                                      np.asarray(jc["len"]))
