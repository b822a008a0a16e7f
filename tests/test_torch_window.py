"""The sliding-window mask and head dim 256 of the port's two attention
kernels, on the CPU, against the JAX package in one process from numpy
inputs (f32, tolerance 1e-4 relative to max(1, |value|)):

- ``flash_attention_ref(window=)`` against ``blockwise_attention(kind=
  "sliding")`` at T = S, for windows 7, 16 and >= T, KV 1 and 2, dh 64
  and 256, and with T < S (the bottom-right alignment of both masks);
- the windowed flash backward (the wrapper's autograd Function, whose
  backward recomputes through the plain version) against ``jax.grad`` of
  ``blockwise_attention``;
- ``decode_attention_ref`` at dh 256 over a wrapped ring against
  ``decode_attention_pallas(interpret=True, window=)``, and the CUDA
  kernel's two passes, emulated over the chunks ``split_plan`` gives at
  rep 16 (its rule for small chunks);
- the wrappers' checks: dh 64, 96 (since slice 16), 128 and 256 pass,
  others (80, 512) raise, and a
  negative window raises.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import decode_attention_pallas  # noqa: E402
from repro.models.attention import blockwise_attention  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    MIN_CHUNK_PER_REP, TARGET_BLOCKS, _check as decode_check, split_bounds,
    split_plan, tile_len)
from test_torch_attention_split import _pool, _two_pass  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401


REL = 1e-4


def _rnd(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert err <= rel, err


def _qkv(seed, b, t, s, h, n_kv, dh):
    return (_rnd(seed, (b, t, h, dh)), _rnd(seed + 1, (b, s, n_kv, dh)),
            _rnd(seed + 2, (b, s, n_kv, dh)))


def _jax_sliding(q, k, v, window):
    """blockwise_attention's sliding kind with the bottom-right alignment
    the kernels use: query t sits at position t + (S - T)."""
    t, s = q.shape[1], k.shape[1]
    qp = jnp.arange(s - t, s, dtype=jnp.int32)[None].repeat(q.shape[0], 0)
    return blockwise_attention(q, k, v, kind="sliding", window=window,
                               q_positions=qp, kv_block=32)


# ----------------------------------------------------------------------
# flash: the sliding mask
@pytest.mark.parametrize("dh", [64, 256])
@pytest.mark.parametrize("n_kv", [1, 2])
@pytest.mark.parametrize("window", [7, 16, 48])
def test_flash_ref_sliding_matches_blockwise(window, n_kv, dh):
    """T = S = 40: window 48 >= T is the causal mask."""
    q, k, v = _qkv(window + n_kv + dh, 2, 40, 40, 4, n_kv, dh)
    got = tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                   window=window)
    _close(got.numpy(), _jax_sliding(*map(jnp.asarray, (q, k, v)), window))
    if window >= 40:
        _close(got.numpy(), tref.flash_attention_ref(
            *map(torch.from_numpy, (q, k, v))).numpy(), 0.0)


def test_flash_ref_sliding_bottom_right_t_below_s():
    """T 12 queries against S 30 keys: the window counts back from each
    query's aligned position, as blockwise_attention's positions say."""
    q, k, v = _qkv(3, 1, 12, 30, 4, 2, 64)
    got = tref.flash_attention_ref(*map(torch.from_numpy, (q, k, v)),
                                   window=9)
    _close(got.numpy(), _jax_sliding(*map(jnp.asarray, (q, k, v)), 9))


def test_flash_windowed_backward_matches_jax_grad():
    """The wrapper's gradient (plain recompute with the window) against
    jax.grad of blockwise_attention, for q, k and v, from one cotangent."""
    q, k, v = _qkv(11, 2, 33, 33, 4, 2, 64)
    cot = _rnd(14, q.shape)
    window = 10
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention(*leaves, window=window)
    (out * torch.from_numpy(cot)).sum().backward()

    def loss(q, k, v):
        return (_jax_sliding(q, k, v, window) * cot).sum()

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    _close(out.detach().numpy(),
           _jax_sliding(*map(jnp.asarray, (q, k, v)), window))
    for got, w in zip(leaves, want):
        _close(got.grad.numpy(), w)


# ----------------------------------------------------------------------
# decode: dh 256 over a wrapped ring
def test_decode_ref_dh256_wrapped_ring_matches_pallas():
    """RecurrentGemma's grouping (rep 16 over one KV head, dh 256) over a
    ring of 24 entries: partly filled, full, wrapped once and many times,
    and a window narrower than the ring."""
    arrays = _pool(5, 4, 24, 1, 16, 256, [9, 24, 31, 100], window=24)
    for window in (24, 10):
        got = tref.decode_attention_ref(*map(torch.from_numpy, arrays),
                                        window=window).numpy()
        want = decode_attention_pallas(*map(jnp.asarray, arrays),
                                       window=window, bkv=8, interpret=True)
        _close(got, want)


@pytest.mark.parametrize("s_slots,n_kv,c,dh,rep", [
    (8, 1, 2048, 256, 16),        # the hybrid serve pool
    (4, 8, 8192, 64, 2),          # windowed fedmm-base
    (4, 4, 520, 128, 8),          # yi-6b grouping
    (2, 1, 40, 256, 16)])         # a pool of 2.5 tiles
def test_split_plan_keeps_chunks_of_four_rep_positions(s_slots, n_kv, c, dh,
                                                        rep):
    """Every chunk but a pool shorter than the rule allows holds at least
    4 x rep positions, in whole tiles covering the pool once; under the
    rule the plan still asks for ~TARGET_BLOCKS blocks."""
    n_split, split_len = split_plan(s_slots, n_kv, c, dh, rep)
    bounds = split_bounds(c, n_split, split_len)
    assert bounds[0] == 0 and bounds[-1] == c
    assert split_len % tile_len(dh) == 0
    if n_split > 1:
        assert split_len >= MIN_CHUNK_PER_REP * rep
    assert n_split == 1 or n_split * s_slots * n_kv <= 2 * TARGET_BLOCKS


def test_split_plan_at_the_hybrid_pool():
    """8 slots x one KV head x a 2,048 ring at dh 256, rep 16: 32 chunks of
    64 positions (4 tiles of 16), 256 blocks, instead of 64 chunks of 32
    whose f32 partials would match the K/V they read."""
    assert split_plan(8, 1, 2048, 256, 16) == (32, 64)
    assert split_plan(8, 1, 2048, 256, 1) == (64, 32)


def test_decode_two_passes_dh256_rep16_match_pallas():
    """The kernel's split and combine passes, emulated over the chunks the
    wrapper picks for rep 16 at dh 256, against the Pallas kernel."""
    arrays = _pool(7, 3, 256, 1, 16, 256, [256, 400, 0], window=256)
    n_split, split_len = split_plan(3, 1, 256, 256, 16)
    assert (n_split, split_len) == (4, 64)      # 16 tiles, 4 a chunk
    got = _two_pass(*map(torch.from_numpy, arrays), 256,
                    split_bounds(256, n_split, split_len)).numpy()
    want = np.asarray(decode_attention_pallas(
        *map(jnp.asarray, arrays), window=256, bkv=32, interpret=True))
    _close(got, want)
    assert np.abs(got[2]).max() == 0.0          # the empty slot


# ----------------------------------------------------------------------
# the wrappers' checks
@pytest.mark.parametrize("dh,ok", [(64, True), (96, True), (128, True),
                                   (256, True), (80, False), (512, False)])
def test_kernel_checks_take_dh_64_128_256(dh, ok):
    q = torch.zeros((1, 4, 2, dh))
    k = torch.zeros((1, 4, 1, dh))
    pos = torch.zeros((1,), dtype=torch.int32)
    kv_pos = torch.zeros((1, 4), dtype=torch.int32)
    calls = (lambda: fa._check(q, k, k, 0),
             lambda: decode_check(q[:, 0], k, k, pos, kv_pos))
    for call in calls:
        if ok:
            call()
        else:
            with pytest.raises(ValueError, match="dh"):
                call()


def test_flash_check_refuses_a_negative_window():
    q = torch.zeros((1, 4, 2, 64))
    with pytest.raises(ValueError, match="window"):
        fa._check(q, q[:, :, :1], q[:, :, :1], -1)
    assert math.isfinite(float(fa.flash_attention(q, q, q, window=3).sum()))
