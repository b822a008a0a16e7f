"""The arithmetic of the port's tensor-core ``lora_matmul`` kernel, on the
CPU.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
its plain version there).  What its bf16 design adds to the plain
arithmetic is checked here, against the JAX oracle and the Pallas kernel
(interpret mode) in one process, from numpy inputs:

- a plain emulation of the kernel's sums: bf16 inputs; f32 partial sums
  one mma k16 step at a time, over the K ranges of the wrapper's
  ``tile_plan``, summed in range order; the bottleneck x @ A kept in f32
  (the design's choice: the Pallas kernel rounds it to bf16 before @ B);
  the rank-r product added in f32 and one rounding at the store.  It must
  lie within the bf16 tolerance chip_smoke.py uses (3e-2 of max(1,
  |value|)) of JAX, and within one bf16 step of the plain version;
- the same emulation on the dx call's transposed, strided views, at
  ranks up to 64 (the kernel's two rank tiles of 32, the Pallas kernel's
  range);
- the wrapper's choices: ``tile_plan`` fills the H100's 132 SMs at every
  shape of the federated round, its tiles cover M x N once and its K
  ranges (the blocks of one cluster) cover K once; ``layout_flags`` reads
  the orientations and the 16-byte loads from strides and addresses; the
  wrapper's check takes ranks 1..64 and names that range when it raises.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.lora_matmul import lora_matmul_pallas  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.lora_matmul import (  # noqa: E402
    BK, BM, MAX_RANK, MAX_SPLITS, MIN_RANGE_STEPS, ROW_A, ROW_W, TARGET_BLOCKS,
    TILE_NS, VEC_A, VEC_W, VEC_X, _check, layout_flags, n_blocks, tile_plan)
from _torch_threads import _one_thread  # noqa: E402,F401


TOL = 3e-2                                        # bf16, of max(1, |value|)
ALL_VEC = VEC_X | VEC_W | VEC_A


def _rnd(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _bf16(a):
    """numpy f32 -> the bf16 tensor both packages get."""
    return torch.from_numpy(a).to(torch.bfloat16)


def _inputs(m, k, n, r, seed=0):
    """x, W, A, B as bf16 tensors; B at r^-0.5 so the rank-r term counts."""
    return (_bf16(_rnd(seed, (m, k))),
            _bf16(_rnd(seed + 1, (k, n), k ** -0.5)),
            _bf16(_rnd(seed + 2, (k, r), k ** -0.5)),
            _bf16(_rnd(seed + 3, (r, n), r ** -0.5)))


def emulate(x, w, a, b, k_split):
    """The bf16 kernel's arithmetic: f32 sums one k16 step at a time within
    each K range of ``k_split``, the ranges summed in order (the reduce
    pass, or the K loop itself with one range), the f32 bottleneck's
    rank-r product added one rank at a time, one rounding.  Takes strided
    views as the kernel does.  Returns (y in bf16, x @ A in f32)."""
    x, w, a, b = (t.float() for t in (x, w, a, b))
    m, k = x.shape
    ys, xas = [], []
    for k0 in range(0, k, k_split):
        acc = torch.zeros((m, w.shape[1]))
        xa = torch.zeros((m, a.shape[1]))
        for kk in range(k0, min(k, k0 + k_split), 16):
            acc = acc + x[:, kk:kk + 16] @ w[kk:kk + 16]
            xa = xa + x[:, kk:kk + 16] @ a[kk:kk + 16]
        ys.append(acc)
        xas.append(xa)
    y, xa = ys[0], xas[0]
    for p, q in zip(ys[1:], xas[1:]):
        y, xa = y + p, xa + q
    for s in range(a.shape[1]):
        y = y + xa[:, s:s + 1] * b[s]
    return y.to(torch.bfloat16), xa


def _rel_err(got, want):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


def _one_step(got, want):
    """Within one bf16 step of ``want`` (both round an f32 sum once)."""
    got, want = got.float().numpy(), want.float().numpy()
    np.testing.assert_array_less(np.abs(got - want),
                                 2.0 ** -7 * np.abs(want) + 1e-5)


SHAPES = [(64, 96, 80, 8),          # aligned
          (37, 100, 50, 3),         # ragged edges, rows off 16 bytes, r < 8
          (48, 200, 72, 32)]        # the largest rank of one rank tile
# two rank tiles: r 33 (A's rows off 16 bytes, 5 n8 tiles of the
# bottleneck) and 64, the top of the range
HIGH_RANKS = [(40, 136, 48, 33), (32, 128, 64, 64)]


@pytest.mark.parametrize("ranges", ["tile_plan", "one range"])
@pytest.mark.parametrize("mknr", SHAPES + HIGH_RANKS)
def test_emulation_matches_jax(mknr, ranges):
    m, k, n, r = mknr
    k_split = tile_plan(m, k, n)[1] if ranges == "tile_plan" else k
    x, w, a, b = _inputs(m, k, n, r, seed=sum(mknr))
    got, xa = emulate(x, w, a, b, k_split)
    js = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (x, w, a, b)]
    assert _rel_err(got, jref.lora_matmul_ref(*js)) <= TOL
    assert _rel_err(got, lora_matmul_pallas(*js, bm=16, bn=32, bk=32,
                                            interpret=True)) <= TOL
    _one_step(got, tref.lora_matmul_ref(x, w, a, b))
    np.testing.assert_allclose(xa.numpy(), (x.float() @ a.float()).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mknr", SHAPES[:2] + HIGH_RANKS)
def test_emulation_on_the_dx_views_matches_jax(mknr):
    """dx = dy @ W^T + (dy @ B^T) @ A^T is the kernel on (dy, W^T, B^T,
    A^T), strided views with the loop axis contiguous: against the
    gradient JAX takes of its oracle, and the Pallas kernel on the same
    transposes."""
    m, k, n, r = mknr
    _, w, a, b = _inputs(m, k, n, r, seed=7 * sum(mknr))
    dy = _bf16(_rnd(5, (m, n)))
    views = (dy, w.t(), b.t(), a.t())
    assert views[1].stride() == (1, n) and views[2].stride() == (1, n)
    got, _ = emulate(*views, tile_plan(m, n, k)[1])
    jw, ja, jb = (jnp.asarray(t.float().numpy(), jnp.bfloat16)
                  for t in (w, a, b))
    jdy = jnp.asarray(dy.float().numpy(), jnp.bfloat16)
    _, vjp = jax.vjp(lambda x_: jref.lora_matmul_ref(x_, jw, ja, jb),
                     jnp.zeros((m, k), jnp.bfloat16))
    assert _rel_err(got, vjp(jdy)[0]) <= TOL
    assert _rel_err(got, lora_matmul_pallas(
        jdy, jw.T, jb.T, ja.T, bm=16, bn=32, bk=32, interpret=True)) <= TOL
    _one_step(got, tref.lora_matmul_ref(*views))


# ----------------------------------------------------------------------
# the wrapper's plan: (M, K, N) of each call the federated round makes
# (fedmm-small, 32 x 16 tokens, d_model 768, wq / wo 768 wide, wk / wv 256)
ROUND_CALLS = {"forward, N 768": (512, 768, 768),
               "forward, N 256": (512, 768, 256),
               "dx from N 768": (512, 768, 768),
               "dx from N 256": (512, 256, 768)}


@pytest.mark.parametrize("call", sorted(ROUND_CALLS))
def test_tile_plan_fills_the_card_at_the_round_shapes(call):
    assert n_blocks(*ROUND_CALLS[call]) >= TARGET_BLOCKS == 132


@pytest.mark.parametrize("mkn", [(512, 768, 768), (512, 768, 256),
                                 (512, 256, 768), (1, 768, 768),
                                 (37, 100, 50), (1000, 104, 499),
                                 (2000, 64, 1024)])
def test_tile_plan_covers_output_and_k_once(mkn):
    m, k, n = mkn
    bn, k_split = tile_plan(m, k, n)
    assert bn in TILE_NS and k_split % BK == 0 and k_split >= BK
    cover = np.zeros((m, n), np.int32)
    for i in range(0, m, BM):
        for j in range(0, n, bn):
            cover[i:i + BM, j:j + bn] += 1
    assert (cover == 1).all()
    ks = np.zeros(k, np.int32)
    ranges = [(k0, min(k, k0 + k_split)) for k0 in range(0, k, k_split)]
    assert len(ranges) <= MAX_SPLITS                # one cluster per tile
    for lo, hi in ranges:
        assert hi > lo                            # no empty range
        ks[lo:hi] += 1
    assert (ks == 1).all()
    assert n_blocks(m, k, n) == (-(-m // BM)) * (-(-n // bn)) * len(ranges)


def test_tile_plan_at_the_round_shapes():
    """64 x 64 tiles in 2 K ranges where that fills the card; 64 x 32 where
    64 x 64 would need ranges shorter than MIN_RANGE_STEPS; no split once
    the tiles alone fill it."""
    assert tile_plan(512, 768, 768) == (64, 384)           # 96 tiles x 2
    assert tile_plan(512, 768, 256) == (32, 256)           # 64 tiles x 3
    assert tile_plan(512, 256, 768) == (32, 256)           # 192 tiles
    assert tile_plan(4096, 768, 768) == (64, 768)
    for mkn in ROUND_CALLS.values():
        assert tile_plan(*mkn)[1] >= MIN_RANGE_STEPS * BK


def test_layout_flags_at_the_round_shapes():
    x, w, a, b = _inputs(512, 768, 256, 8)
    assert layout_flags(x, w, a) == ALL_VEC | ROW_W | ROW_A
    dy = _bf16(_rnd(1, (512, 256)))
    # dx's views W^T and B^T have the loop axis contiguous
    assert layout_flags(dy, w.t(), b.t()) == ALL_VEC


def test_layout_flags_fall_back_to_element_loads():
    x, w, a, _ = _inputs(37, 100, 50, 3)
    assert layout_flags(x, w, a) == ROW_W | ROW_A          # K, N, r off 8
    _, w, a, _ = _inputs(64, 64, 64, 8)
    x = _bf16(_rnd(2, (65, 64)))[1:]                       # 128 bytes in
    assert layout_flags(x, w, a) & VEC_X
    x = _bf16(_rnd(3, (64 * 64 + 4,)))[4:].view(64, 64)    # 8 bytes in
    assert not layout_flags(x, w, a) & VEC_X
    w = _bf16(_rnd(4, (64, 2, 64)))[:, 0]                  # pitch 128 bytes
    assert layout_flags(x, w, a) & VEC_W
    w = _bf16(_rnd(5, (64, 130)))[:, :64]                  # pitch 260 bytes
    assert not layout_flags(x, w, a) & VEC_W


def test_layout_flags_for_an_operand_with_no_contiguous_axis():
    """Neither stride 1: the row orientation, element loads."""
    x, _, a, _ = _inputs(16, 64, 64, 8)
    w = _bf16(_rnd(6, (64, 2, 64, 2)))[:, 0, :, 0]
    assert w.stride() == (256, 2)
    flags = layout_flags(x, w, a)
    assert flags & ROW_W and not flags & VEC_W


@pytest.mark.parametrize("r", [1, 8, 32, 33, 64])
def test_check_takes_ranks_up_to_64(r):
    _check(*_inputs(16, 64, 32, r))


@pytest.mark.parametrize("r", [65, 128])
def test_check_refuses_ranks_past_64_naming_the_range(r):
    assert MAX_RANK == 64
    with pytest.raises(ValueError, match=r"rank 1\.\.64.*Pallas"):
        _check(*_inputs(16, 64, 32, r))
