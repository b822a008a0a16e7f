"""The port's model code against ``repro.models`` in one process: the same
weights (JAX init -> numpy -> ``bridge.params_from_numpy``) and the same
numpy inputs go through both.  On the CPU the port's attention runs the
kernels' plain versions."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.serve.pool import init_pool_cache as jinit_pool  # noqa: E402
from repro.serve.pool import scatter_slot as jscatter  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.serve.pool import init_pool_cache, scatter_slot  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401


# the JAX reference, jitted: the same functions, compiled once per shape
# instead of dispatched op by op (which costs seconds per call on the CPU)
J_INIT = jax.jit(JT.init_params, static_argnums=1)
J_PREFILL = jax.jit(JT.prefill, static_argnums=2, static_argnames="cache_len")
J_DECODE = jax.jit(JT.decode_step_slots, static_argnums=3)

TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
            d_ff=128, vocab_size=256, dtype="float32")


def _cfgs(**over):
    kw = dict(TINY, **over)
    return (jget_config("fedmm-small").with_(**kw),
            get_config("fedmm-small").with_(**kw))


def _rnd(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(tree):
    return bridge.params_from_numpy(jax.device_get(tree), "cpu")


def _close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                   np.float32),
        np.asarray(want, np.float32), atol=tol, rtol=0)


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = _cfgs()
    jp = J_INIT(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, _t(jp)


# ----------------------------------------------------------------------
def test_common_blocks_match():
    x = _rnd(0, (2, 5, 4, 16))
    w = _rnd(1, (16,))
    _close(tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w)), 1e-5)
    pos = np.tile(np.arange(5, dtype=np.int32)[None] + 3, (2, 1))
    _close(tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
           jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4), 1e-5)
    mlp = {n: {"w": 0.25 * _rnd(i, shape)} for i, (n, shape) in enumerate(
        [("gate", (16, 24)), ("up", (16, 24)), ("down", (24, 16))], 2)}
    h = _rnd(9, (3, 16))
    _close(tcommon.swiglu(_t(mlp), torch.from_numpy(h)),
           jcommon.swiglu(mlp, jnp.asarray(h)), 1e-5)
    _close(tcommon.linear(torch.from_numpy(h), _t(mlp["gate"])),
           jcommon.linear(jnp.asarray(h), mlp["gate"]), 1e-5)


def test_linear_refuses_lora_side_cars():
    """Well-formed side-cars run through ``lora_matmul`` (their parity is in
    tests/test_torch_train_kernels.py); ``linear`` refuses the malformed
    ones: a GeoDoRA magnitude without GeoLoRA factors, and a W that asks
    for a gradient (the kernel's backward gives W none: it is frozen
    wherever side-cars are attached)."""
    lin = {"w": torch.zeros(4, 3), "lora_A": torch.zeros(4, 2),
           "lora_B": torch.zeros(2, 3)}
    assert tuple(tcommon.linear(torch.ones(1, 4), lin).shape) == (1, 3)
    with pytest.raises(ValueError, match="dora_m without"):
        tcommon.linear(torch.zeros(1, 4), {"w": lin["w"],
                                            "dora_m": torch.ones(3)})
    live = dict(lin, w=lin["w"].clone().requires_grad_())
    with pytest.raises(ValueError, match="frozen"):
        tcommon.linear(torch.zeros(1, 4), live)


def test_init_params_tree_matches_jax(tiny):
    """Same keys, shapes and dtypes as the JAX tree, so weights drop in."""
    jcfg, tcfg, jp, _ = tiny
    got = TT.init_params(0, tcfg, device="cpu")
    flat_j = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
              for p, x in jax.tree_util.tree_leaves_with_path(jp)}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, f"{prefix}['{k}']")
            else:
                yield f"{prefix}['{k}']", (tuple(v.shape),
                                           str(v.dtype).split(".")[-1])
    assert dict(walk(got)) == flat_j
    bf = TT.init_params(torch.Generator().manual_seed(1),
                        tcfg.with_(dtype="bfloat16"), device="cpu")
    assert bf["blocks"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    assert float(bf["embed"].float().abs().max()) <= 0.04 * (1 + 2 ** -7)


def test_gqa_forward_matches(tiny):
    jcfg, tcfg, jp, tp = tiny
    x = _rnd(3, (2, 12, 64))
    jblk = jax.tree.map(lambda a: a[0], jp["blocks"]["attn"])
    tblk = TT._layers(tp["blocks"], tcfg.n_layers)[0]["attn"]
    jy, jkv = jattn.gqa_forward(jblk, jnp.asarray(x), jcfg, return_kv=True)
    ty, tkv = tattn.gqa_forward(tblk, torch.from_numpy(x), tcfg,
                                return_kv=True)
    _close(ty, jy, 1e-5)
    _close(tkv["k"], jkv["k"], 1e-5)
    _close(tkv["v"], jkv["v"], 1e-5)


def test_prefill_matches_logits_and_cache(tiny):
    jcfg, tcfg, jp, tp = tiny
    toks = np.random.default_rng(4).integers(0, 256, (2, 10)).astype(np.int32)
    jl, jc = J_PREFILL(jp, {"tokens": jnp.asarray(toks)}, jcfg, cache_len=24)
    tl, tc = TT.prefill(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                        cache_len=24)
    _close(tl, jl, 1e-4)
    assert set(tc) == set(jc)
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape
        _close(tc[name], jc[name], 1e-5)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    assert int(tc["len"]) == int(jc["len"]) == 10


def _pools(jcfg, tcfg, jp, tp, prompts, n_slots, cache_len):
    """The same pool in both packages: prompt i prefilled into slot i."""
    jpool = jinit_pool(jcfg, n_slots, cache_len)
    tpool = init_pool_cache(tcfg, n_slots, cache_len, device="cpu")
    for slot, toks in enumerate(prompts):
        _, jc = J_PREFILL(jp, {"tokens": jnp.asarray(toks)[None]}, jcfg,
                           cache_len=cache_len)
        _, tc = TT.prefill(tp, {"tokens": torch.from_numpy(toks)[None]},
                           tcfg, cache_len=cache_len)
        jpool = jscatter(jpool, jc, jnp.asarray(slot, jnp.int32))
        scatter_slot(tpool, tc, slot)
    return jpool, tpool


def test_decode_step_slots_with_step_mask_matches(tiny):
    """Slots at different depths, one frozen by ``step_mask``: logits, every
    cache leaf and the per-slot positions agree after two steps."""
    jcfg, tcfg, jp, tp = tiny
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, n).astype(np.int32) for n in (3, 9, 6)]
    jpool, tpool = _pools(jcfg, tcfg, jp, tp, prompts, 4, 20)
    mask = np.array([True, False, True, True])
    for step in range(2):
        toks = rng.integers(0, 256, (4, 1)).astype(np.int32)
        jl, jpool = J_DECODE(jp, jpool, {"tokens": jnp.asarray(toks)},
                                jcfg, step_mask=jnp.asarray(mask))
        tl, tpool = TT.decode_step_slots(tp, tpool,
                                         {"tokens": torch.from_numpy(toks)},
                                         tcfg, step_mask=torch.from_numpy(mask))
        _close(tl, jl, 1e-4)
    for name in ("k", "v"):
        _close(tpool[name], jpool[name], 1e-5)
    np.testing.assert_array_equal(tpool["pos"].numpy(), np.asarray(jpool["pos"]))
    np.testing.assert_array_equal(tpool["len"].numpy(), [5, 9, 8, 2])
    np.testing.assert_array_equal(tpool["len"].numpy(), np.asarray(jpool["len"]))


def test_bf16_prefill_and_decode_close(tiny):
    """bf16 weights (the JAX bf16 tree, bit for bit through the bridge):
    logits agree to 3e-2 of max |logit| -- the two frameworks round bf16 at
    different places."""
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    jp = J_INIT(jax.random.PRNGKey(1), jcfg)
    tp = _t(jp)
    assert tp["embed"].dtype == torch.bfloat16
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 256, 7).astype(np.int32) for _ in range(2)]
    jl, _ = J_PREFILL(jp, {"tokens": jnp.asarray(prompts[0])[None]}, jcfg)
    tl, _ = TT.prefill(tp, {"tokens": torch.from_numpy(prompts[0])[None]},
                       tcfg)
    scale = float(jnp.abs(jl.astype(jnp.float32)).max())
    _close(tl, jl, 3e-2 * scale)
    jpool, tpool = _pools(jcfg, tcfg, jp, tp, prompts, 2, 16)
    toks = rng.integers(0, 256, (2, 1)).astype(np.int32)
    jl, _ = J_DECODE(jp, jpool, {"tokens": jnp.asarray(toks)}, jcfg)
    tl, _ = TT.decode_step_slots(tp, tpool, {"tokens": torch.from_numpy(toks)},
                                 tcfg)
    _close(tl, jl, 3e-2 * float(jnp.abs(jl.astype(jnp.float32)).max()))


@pytest.mark.parametrize("arch,over", [("deepseek-v2-236b",
                                         {"family": "dense"})])
def test_later_slices_raise(arch, over):
    """MLA outside the moe family is not ported: the port refuses it
    instead of computing something else (sliding windows and the hybrid
    family are served since slice 11, the moe family and chunked
    attention since slice 13, MLA in the moe family since slice 14, the
    vlm family since slice 16, the audio family since slice 17:
    ``tests/test_torch_hybrid.py``, ``tests/test_torch_chunked.py``,
    ``tests/test_torch_mla.py``, ``tests/test_torch_vlm.py`` and
    ``tests/test_torch_audio.py`` hold them against JAX)."""
    from repro_torch.configs import reduced
    cfg = reduced(get_config(arch)).with_(**over)
    with pytest.raises(NotImplementedError):
        TT.init_params(0, cfg, device="cpu")
    with pytest.raises(NotImplementedError):
        TT.init_cache(cfg, 1, 8, device="cpu")


def _builds_like_jax(arch, over):
    """The port's ``init_params`` and ``init_cache`` trees on the reduced
    ``arch`` (with ``over``) against the reference's: keys, shapes and
    dtypes."""
    from repro.configs import reduced as jreduced
    from repro_torch.configs import reduced
    cfg = reduced(get_config(arch)).with_(**over)
    jcfg = jreduced(jget_config(arch)).with_(**over)

    def spec(tree):
        return {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
                for p, x in jax.tree_util.tree_leaves_with_path(tree)}
    want = spec(jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0),
                                                      jcfg)))
    assert spec(bridge.params_to_numpy(
        TT.init_params(0, cfg, device="cpu"))) == want
    assert spec(bridge.params_to_numpy(
        TT.init_cache(cfg, 1, 8, device="cpu"))) == \
        spec(jax.eval_shape(lambda: JT.init_cache(jcfg, 1, 8)))


@pytest.mark.parametrize("arch,over", [
    ("deepseek-v2-236b", {}),
    ("llama4-scout-17b-a16e", {"mla": get_config("deepseek-v2-236b").mla})])
def test_mla_configs_build_like_jax(arch, over):
    """MLA (DeepSeek-V2's moe, and a moe model given DeepSeek-V2's MLA),
    refused before slice 14, now gives the reference's parameter and
    cache trees: ``make_mla``'s leaves in every block, and the latent
    cache ``c_kv`` / ``k_rope`` with no ``pos`` leaf."""
    _builds_like_jax(arch, over)


@pytest.mark.parametrize("arch,over", [
    ("phi-3-vision-4.2b", {}),
    ("phi-3-vision-4.2b", dict(d_model=192, n_heads=2, n_kv_heads=2,
                               head_dim=96))])
def test_vlm_configs_build_like_jax(arch, over):
    """The vlm family, refused before slice 16, gives the reference's
    trees: the dense blocks and ``adapter``, and the dense cache."""
    _builds_like_jax(arch, over)


@pytest.mark.parametrize("arch,over", [
    ("mistral-nemo-12b", {"sliding_window": 64, "attention_chunk": 64}),
    ("mistral-nemo-12b", {"attention_chunk": 64}),
    ("recurrentgemma-9b", {"attention_chunk": 64}),
    ("llama4-scout-17b-a16e", {})])
def test_chunk_and_moe_configs_build_like_jax(arch, over):
    """Configs the port refused before slice 13 -- a chunk on the dense
    family (with and without a sliding window, which wins, as in
    ``_attn_kind``), on the hybrid (whose local attention ignores it), and
    the moe family -- now give the reference's parameter and cache trees:
    keys, shapes and dtypes."""
    _builds_like_jax(arch, over)


def test_config_copy_matches_jax_registry():
    """The port's config copy is field-for-field the JAX registry."""
    from repro.configs import list_archs as jlist
    from repro_torch.configs import list_archs
    assert list_archs() == jlist()
    for arch in jlist():
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jget_config(arch))


def test_scatter_gather_roundtrip(tiny):
    """scatter_slot writes every cache leaf into its slot in place;
    gather_slot copies it back out; other slots stay empty."""
    from repro_torch.serve.pool import gather_slot
    _, tcfg, _, tp = tiny
    pool = init_pool_cache(tcfg, 4, 16, device="cpu")
    toks = torch.from_numpy(np.arange(1, 8, dtype=np.int32))[None]
    _, req = TT.prefill(tp, {"tokens": toks}, tcfg, cache_len=16)
    assert scatter_slot(pool, req, 2) is pool
    back = gather_slot(pool, 2)
    assert set(back) == set(req)
    for name, leaf in req.items():
        assert back[name].shape == leaf.shape, name
        assert torch.equal(back[name], leaf), name
    other = gather_slot(pool, 0)
    assert int(other["len"]) == 0
    assert bool((other["pos"] == TT._SENTINEL).all())
