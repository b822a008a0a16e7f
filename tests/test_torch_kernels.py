"""The port's attention kernels, plain versions, against the JAX Pallas
kernels (interpret mode) and the JAX oracles, in one process.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against these plain versions there.  Tolerances as in
tests/test_kernels.py: 1e-5 for f32, 3e-2 for bf16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import decode_attention_pallas  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from _torch_threads import _one_thread  # noqa: E402,F401


SENTINEL = (2 ** 31 - 1) // 2
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _rnd(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pool(seed, s_slots, c, n_kv, rep, dh, lens, window=0):
    """A serving-style pool (numpy): slot j holds lens[j] tokens, as a ring
    of width c when window > 0, linear otherwise; empty entries carry the
    position sentinel.  lens[j] == 0 leaves slot j fully masked."""
    q = _rnd(seed, (s_slots, n_kv * rep, dh))
    k = _rnd(seed + 1, (s_slots, c, n_kv, dh))
    v = _rnd(seed + 2, (s_slots, c, n_kv, dh))
    lens = np.asarray(lens, np.int32)
    idx = np.arange(c, dtype=np.int32)[None, :]
    if window:
        wrap = ((lens[:, None] - 1 - idx) // c) * c + idx
        pos = np.where((wrap >= 0) & (idx < np.minimum(lens[:, None], c))
                       & (wrap < lens[:, None]), wrap, SENTINEL)
    else:
        pos = np.where(idx < lens[:, None], idx, SENTINEL)
    # the query sits at the slot's newest position
    q_pos = np.maximum(lens - 1, 0).astype(np.int32)
    return q, k, v, q_pos, pos.astype(np.int32)


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) if a.dtype == np.float32
            else torch.from_numpy(a) for a in arrays]


def _jax(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) if a.dtype == np.float32 else jnp.asarray(a)
            for a in arrays]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol)


def _decode_case(q, k, v, q_pos, pos, window=0, dtype="float32"):
    """port plain version vs Pallas (interpret) and the JAX oracle."""
    got = tref.decode_attention_ref(
        *_torch(q, k, v, q_pos, pos, dtype=getattr(torch, dtype)),
        window=window)
    jin = _jax(q, k, v, q_pos, pos, dtype=getattr(jnp, dtype))
    pallas = decode_attention_pallas(*jin, window=window, bkv=32,
                                     interpret=True)
    oracle = jref.decode_attention_ref(*jin, window=window)
    got = got.float().numpy()
    _close(got, pallas, TOL[dtype])
    _close(got, oracle, TOL[dtype])
    return got, np.asarray(pallas, np.float32), np.asarray(oracle, np.float32)


@pytest.mark.parametrize("n_kv,rep", [(2, 1), (2, 4), (3, 2), (1, 8)])
def test_decode_ref_gqa_grouping(n_kv, rep):
    """Query head h reads KV head h // rep, for every grouping."""
    _decode_case(*_pool(0, 3, 40, n_kv, rep, 32, [40, 17, 1]))


def test_decode_ref_dh96():
    """Phi-3-vision's head dim (MHA, rep 1): a slot at C, a short one and
    one of a single entry, against Pallas and the oracle."""
    _decode_case(*_pool(3, 3, 70, 2, 1, 96, [70, 9, 1]))


def test_decode_ref_ring_window():
    """Ring-buffer windows: partially filled, full, wrapped once, wrapped
    many times."""
    _decode_case(*_pool(7, 4, 24, 2, 2, 32, [9, 24, 31, 100], window=24),
                 window=24)


def test_decode_ref_padded_slots():
    """Entries past each slot's length carry the sentinel and get exactly
    zero weight: poisoning them must not move the output."""
    q, k, v, q_pos, pos = _pool(13, 3, 50, 2, 2, 32, [1, 13, 50])
    bad = np.where((pos == SENTINEL)[..., None, None], 1e4, 1.0)
    poisoned = tref.decode_attention_ref(
        *_torch(q, (k * bad).astype(np.float32), (v * bad).astype(np.float32),
                q_pos, pos))
    clean, _, _ = _decode_case(q, k, v, q_pos, pos)
    _close(poisoned, clean, 1e-5)


def test_decode_ref_fully_masked_slot_is_zero():
    """A slot with no visible entry gives 0, as the Pallas kernel does;
    the JAX oracle's softmax over an all -1e30 row gives the mean of V.
    The port follows the Pallas kernel."""
    q, k, v, q_pos, pos = _pool(17, 3, 32, 2, 2, 32, [5, 0, 32])
    got = tref.decode_attention_ref(*_torch(q, k, v, q_pos, pos)).numpy()
    jin = _jax(q, k, v, q_pos, pos)
    pallas = np.asarray(decode_attention_pallas(*jin, bkv=32,
                                                interpret=True))
    oracle = np.asarray(jref.decode_attention_ref(*jin))
    assert np.abs(got[1]).max() == 0.0
    assert np.abs(pallas[1]).max() == 0.0
    assert np.abs(oracle[1]).max() > 0.1       # the oracle's other contract
    _close(got, pallas, 1e-5)
    _close(got[[0, 2]], oracle[[0, 2]], 1e-5)  # live slots agree with both


def test_decode_ref_bf16():
    _decode_case(*_pool(29, 2, 32, 2, 2, 32, [32, 11]), dtype="bfloat16")


# ----------------------------------------------------------------------
def _fold(x):
    """(B, T, H, dh) -> (B*H, T, dh), the layout the Pallas kernel takes."""
    b, t, h, dh = x.shape
    return jnp.asarray(np.ascontiguousarray(
        x.transpose(0, 2, 1, 3)).reshape(b * h, t, dh))


@pytest.mark.parametrize("b,t,h,n_kv,dh", [(1, 64, 4, 4, 32),
                                           (2, 100, 4, 2, 32),
                                           (1, 100, 4, 2, 96)])
def test_flash_ref_matches_pallas(b, t, h, n_kv, dh):
    """Causal, Sq == Sk, n_rep in {1, 2}: the plain version against the
    Pallas kernel and the JAX oracle (K/V repeated per head for the
    oracle)."""
    rep = h // n_kv
    q, k, v = _rnd(6, (b, t, h, dh)), _rnd(7, (b, t, n_kv, dh)), \
        _rnd(8, (b, t, n_kv, dh))
    got = tref.flash_attention_ref(*_torch(q, k, v)).numpy()
    got_f = np.asarray(_fold(got))
    pallas = flash_attention_pallas(_fold(q), _fold(k), _fold(v),
                                    causal=True, n_rep=rep, bq=64, bkv=64,
                                    interpret=True)
    _close(got_f, pallas, TOL["float32"])
    oracle = jref.flash_attention_ref(_fold(q), _fold(np.repeat(k, rep, 2)),
                                      _fold(np.repeat(v, rep, 2)),
                                      causal=True)
    _close(got_f, oracle, TOL["float32"])


def test_flash_ref_bottom_right_causal():
    """Sq < Sk: the causal mask is aligned bottom-right, as the JAX oracle
    aligns it (k <= q + Sk - Sq)."""
    q, k, v = _rnd(9, (1, 24, 2, 32)), _rnd(10, (1, 40, 2, 32)), \
        _rnd(11, (1, 40, 2, 32))
    got = tref.flash_attention_ref(*_torch(q, k, v)).numpy()
    oracle = jref.flash_attention_ref(_fold(q), _fold(k), _fold(v))
    _close(_fold(got), oracle, TOL["float32"])


@pytest.mark.parametrize("b,t,s,h,n_kv,dh", [(1, 64, 64, 4, 4, 32),
                                             (2, 100, 100, 4, 2, 32),
                                             (1, 24, 70, 4, 4, 64),
                                             (2, 1, 90, 4, 2, 64),
                                             (1, 40, 33, 6, 3, 64)])
def test_flash_ref_full_mask_matches_pallas(b, t, s, h, n_kv, dh):
    """The full mask (``causal=False``, the audio family's encoder and
    cross attention): T == S and T != S (more or fewer keys than rows),
    rep 1, 2 and 3; the plain version against the Pallas kernel, whose
    padded keys ``sk_valid`` masks, and the JAX oracle (K / V repeated
    per head); the wrapper's CPU route is the plain version."""
    rep = h // n_kv
    q, k, v = _rnd(b + t, (b, t, h, dh)), _rnd(s, (b, s, n_kv, dh)), \
        _rnd(s + 1, (b, s, n_kv, dh))
    tq, tk, tv = _torch(q, k, v)
    got = tref.flash_attention_ref(tq, tk, tv, causal=False)
    assert torch.equal(flash_attention(tq, tk, tv, causal=False), got)
    got_f = _fold(got.numpy())
    pallas = flash_attention_pallas(_fold(q), _fold(k), _fold(v),
                                    causal=False, n_rep=rep, bq=16, bkv=32,
                                    interpret=True)
    _close(got_f, pallas, TOL["float32"])
    oracle = jref.flash_attention_ref(_fold(q), _fold(np.repeat(k, rep, 2)),
                                      _fold(np.repeat(v, rep, 2)),
                                      causal=False)
    _close(got_f, oracle, TOL["float32"])
    if t > 1:                       # a row sees the keys past its own
        causal = tref.flash_attention_ref(tq, tk, tv).numpy()
        assert np.abs(causal - got.numpy()).max() > 1e-2


def test_flash_full_mask_refuses_a_window_or_a_chunk():
    """The full mask takes neither: the wrapper and the plain version
    raise instead of computing another mask."""
    q = torch.zeros((1, 4, 2, 64))
    kv = q[:, :, :1]
    for mask in (dict(window=3), dict(chunk=4)):
        with pytest.raises(ValueError, match="causal=False"):
            flash_attention(q, kv, kv, causal=False, **mask)
        with pytest.raises(ValueError, match="causal=False"):
            tref.flash_attention_ref(q, kv, kv, causal=False, **mask)


def test_flash_ref_bf16():
    q, k, v = (_rnd(s, (1, 64, 4, 32)) for s in (12, 13, 14))
    got = tref.flash_attention_ref(*_torch(q, k, v, dtype=torch.bfloat16))
    pallas = flash_attention_pallas(
        *(_fold(x).astype(jnp.bfloat16) for x in (q, k, v)), bq=64, bkv=64,
        interpret=True)
    _close(_fold(got.float().numpy()), pallas, TOL["bfloat16"])


# ----------------------------------------------------------------------
def test_wrappers_on_cpu_use_plain_version_and_count_nothing():
    """A CPU tensor goes to the plain version; only kernel launches count."""
    q, k, v, q_pos, pos = _torch(*_pool(3, 2, 16, 2, 2, 64, [16, 5]))
    d0, f0 = decode_attention.launches, flash_attention.launches
    got = decode_attention(q, k, v, q_pos, pos)
    torch.testing.assert_close(got, tref.decode_attention_ref(
        q, k, v, q_pos, pos), rtol=0, atol=0)
    fq, fk, fv = _torch(_rnd(4, (1, 16, 4, 64)), _rnd(5, (1, 16, 2, 64)),
                        _rnd(6, (1, 16, 2, 64)))
    got = flash_attention(fq, fk, fv)
    torch.testing.assert_close(got, tref.flash_attention_ref(fq, fk, fv),
                               rtol=0, atol=0)
    assert (decode_attention.launches, flash_attention.launches) == (d0, f0)


def test_wrappers_refuse_devices_without_a_kernel():
    """Neither a CPU nor a CUDA tensor: the wrapper raises instead of
    picking a path."""
    q = torch.empty((2, 4, 64), device="meta")
    k = torch.empty((2, 16, 2, 64), device="meta")
    pos = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        decode_attention(q, k, k, pos, torch.empty((2, 16), dtype=torch.int32,
                                                   device="meta"))
    with pytest.raises(ValueError):
        flash_attention(q[None], k, k)
