"""The chunked arithmetic of the port's selective-scan kernel on the CPU:
``ref.selective_scan_chunked_ref`` (chunk pairs, the ordered carry, each
chunk rescanned from its carry-in) and the wrapper's CPU route against the
JAX oracles -- ``repro.kernels.ref.selective_scan_ref``, the Pallas
kernel in interpret mode and ``repro.models.ssm._chunked_diag_scan`` --
and the port's sequential plain version; and ``scan_plan``, the grid the
kernel runs, with the index maps of its passes emulated here.

Inputs are made with numpy from a seed.  Tolerance: the scan tests'
rtol 2e-4 / atol 1e-5 in f32 (``tests/test_torch_ssm.py``); the chunked
twin with one chunk is the sequential version bit for bit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.selective_scan import selective_scan_pallas  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.selective_scan import (  # noqa: E402
    LANES, ONE_PASS_BLOCKS, PASS_COLUMNS, PASS_THREADS, SUB, WARPS,
    design_plan, fold_steps, link_words, runs_chained, scan_plan,
    selective_scan)
from _torch_threads import _one_thread  # noqa: E402,F401

RTOL, ATOL = 2e-4, 1e-5


def _inputs(b, s, c, seed, da_lo=0.3, da_hi=0.99):
    r = np.random.default_rng(seed)
    da = r.uniform(da_lo, da_hi, (b, s, c)).astype(np.float32)
    dbx = r.standard_normal((b, s, c)).astype(np.float32)
    h0 = r.standard_normal((b, c)).astype(np.float32)
    return da, dbx, h0


def _edge_inputs():
    """B 3, S 29, C 300 (not a multiple of the kernel's 256-channel tile):
    h0 = 0 on row 0 (as a prefill starts) and != 0 on rows 1 and 2; da
    holds exact 0 (a reset: the carry-in is dropped) and exact 1 (the
    state passes unchanged) at and across chunk boundaries."""
    da, dbx, h0 = _inputs(3, 29, 300, seed=11)
    h0[0] = 0.0
    da[:, 7] = 0.0                   # the last step of a chunk of 8
    da[:, 8] = 1.0                   # the first step of the next
    da[1, 12:20, :40] = 1.0          # a whole chunk of ones on some channels
    da[2, 16, 5:260] = 0.0           # a reset at a chunk's first step
    da[0, 27:, 290:] = 0.0           # in the ragged last chunk
    return da, dbx, h0


_ORACLES = {}


def _oracles(key, da, dbx, h0, pallas_chunk=16):
    """[(name, (h_all, h_last))] of every JAX oracle and the port's
    sequential plain version, computed once per input ``key``."""
    if key not in _ORACLES:
        jda, jdbx, jh0 = map(jnp.asarray, (da, dbx, h0))
        _ORACLES[key] = [
            ("jax ref", jref.selective_scan_ref(jda, jdbx, jh0)),
            ("pallas", selective_scan_pallas(jda, jdbx, jh0,
                                             chunk=pallas_chunk, bc=16,
                                             interpret=True)),
            ("_chunked_diag_scan", jssm._chunked_diag_scan(
                jda, jdbx, jh0, pallas_chunk)),
            ("port sequential", ref.selective_scan_ref(
                *map(torch.from_numpy, (da, dbx, h0))))]
    return _ORACLES[key]


def _hold(got: dict, oracles, shape):
    """Each (h_all, h_last) of ``got`` against every oracle."""
    for gname, (g_all, g_last) in got.items():
        assert g_all.dtype == g_last.dtype == torch.float32
        assert g_all.shape == shape and g_last.shape == (shape[0], shape[2])
        assert torch.equal(g_last, g_all[:, -1])
        for oname, (w_all, w_last) in oracles:
            for g, w in ((g_all, w_all), (g_last, w_last)):
                np.testing.assert_allclose(
                    g.numpy(), np.asarray(w, np.float32), rtol=RTOL,
                    atol=ATOL, err_msg=f"{gname} vs {oname}")


def _hold_twin(key, da, dbx, h0, chunk, pallas_chunk=16):
    """The chunked twin and the wrapper's CPU route against every oracle."""
    args = tuple(map(torch.from_numpy, (da, dbx, h0)))
    _hold({"chunked twin": ref.selective_scan_chunked_ref(*args, chunk),
           "wrapper (CPU)": selective_scan(*args)},
          _oracles(key, da, dbx, h0, pallas_chunk), da.shape)


@pytest.mark.parametrize("chunk", [32, 29, 28, 8, 1],
                         ids=["s<chunk", "s=chunk", "s=chunk+1",
                              "ragged-last-5", "chunk-1"])
def test_chunked_matches_oracles(chunk):
    """S 29 against chunks of 32 (one chunk, no pair), 29, 28 (a last
    chunk of one step), 8 (a ragged last chunk of 5) and 1 (a pair every
    step), on ``_edge_inputs``."""
    _hold_twin("edges", *_edge_inputs(), chunk)


@pytest.mark.parametrize("chunk", [8, 1])
def test_chunked_single_step(chunk):
    """S = 1: one step from h0, whatever the chunk."""
    _hold_twin("s1", *_inputs(2, 1, 45, seed=1), chunk)


def test_chunked_bf16_inputs():
    """bf16 da / dbx are widened to f32 (the JAX oracles take the same
    widened values); the twin and the route keep f32 outputs."""
    da, dbx, h0 = _edge_inputs()
    da16, dbx16 = (torch.from_numpy(x).to(torch.bfloat16) for x in (da, dbx))
    wide = [x.float().numpy() for x in (da16, dbx16)]
    t_h0 = torch.from_numpy(h0)
    _hold({"chunked twin": ref.selective_scan_chunked_ref(da16, dbx16, t_h0,
                                                          8),
           "wrapper (CPU)": selective_scan(da16, dbx16, t_h0)},
          _oracles("bf16", *wide, h0), da.shape)


def test_chunked_long_s_da_near_one():
    """da in (0.999, 1) over S 2,560 at the sub-chunk the kernel folds at
    the RG-LRU prefill (160 pairs): the state barely decays, so an error in
    a carry-in stays in every later step.  dbx is the RG-LRU's gated input,
    sqrt(1 - a^2) times a normal (``models/rglru.py``), which keeps |h|
    near 1.  (Without that factor |h| reaches ~80, and at this elementwise
    limit even the JAX oracles disagree with each other: f32 rounding at
    that size is larger than atol where h crosses 0.)"""
    chunk = fold_steps(runs_chained(1, 4096), 2560)
    da, x, h0 = _inputs(1, 2560, 16, seed=17, da_lo=0.999, da_hi=1.0)
    dbx = (np.sqrt(1.0 - da * da) * x).astype(np.float32)
    _hold_twin("long", da, dbx, h0, chunk, pallas_chunk=256)


def test_chunked_one_chunk_is_sequential_bit_for_bit():
    """chunk >= S is the sequential plain version, bit for bit (the one-
    pass plan's arithmetic)."""
    args = tuple(map(torch.from_numpy, _edge_inputs()))
    want = ref.selective_scan_ref(*args)
    for chunk in (29, 64):
        got = ref.selective_scan_chunked_ref(*args, chunk)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


# ----------------------------------------------------------------------
# the plan
def _kernel_cover(b, s, c):
    """Emulate the index maps of the kernel that ``scan_plan`` picks:
    {(batch row, tile): [(first step, steps)]} of the work it does, the
    channel range of every tile, and the ticket each block waits on."""
    tile, chunk, blocks = scan_plan(b, s, c)
    tiles = -(-c // tile)
    runs, waits = {}, []
    if tile != LANES:                               # one pass
        for bi in range(b):
            for x in range(tiles):
                runs[bi, x] = [(0, s)]
    else:                                           # chained, by ticket
        sub = chunk // WARPS
        n_chunks = -(-s // chunk)
        for v in range(blocks):
            k, bi, x = v // (b * tiles), (v // tiles) % b, v % tiles
            for w in range(WARPS):
                t0 = (k * WARPS + w) * sub
                if t0 < s:
                    runs.setdefault((bi, x), []).append((t0, min(sub, s - t0)))
            if k:
                waits.append((v, v - b * tiles, (k - 1, bi, x)))
        assert blocks == n_chunks * b * tiles
    chans = [(x * tile, min(c, x * tile + tile)) for x in range(tiles)]
    return runs, chans, waits, tiles


@pytest.mark.parametrize("b,s,c", [
    (1, 512, 131072), (1, 128, 131072), (1, 2560, 4096), (1, 2219, 4096),
    (1, 2895, 4096), (3, 700, 4096), (1, 1, 4096), (2, 1, 131072),
    (3, 37, 1000), (8, 600, 4096), (2, 33, 256), (1, 31, 5),
    (1, 64, 67586), (1, 64, 67584)])
def test_scan_plan_covers_once(b, s, c):
    """Every (row, step, channel) is computed by exactly one thread, and a
    chained block waits only on the previous chunk of its own columns,
    which took an earlier ticket."""
    tile, chunk, blocks = scan_plan(b, s, c)
    runs, chans, waits, tiles = _kernel_cover(b, s, c)
    assert chunk == (WARPS * SUB if tile == LANES else s)
    assert blocks == b * tiles * -(-s // chunk)
    assert chans[0][0] == 0 and chans[-1][1] == c
    assert all(hi == lo for (_, hi), (lo, _) in zip(chans, chans[1:]))
    assert set(runs) == {(bi, x) for bi in range(b) for x in range(tiles)}
    for steps in runs.values():
        steps = sorted(steps)
        assert steps[0][0] == 0 and all(n > 0 for _, n in steps)
        assert all(t + n == nxt for (t, n), (nxt, _) in zip(steps, steps[1:]))
        assert steps[-1][0] + steps[-1][1] == s
    for v, earlier, (k, bi, x) in waits:
        assert earlier < v
        assert (earlier // (b * tiles), (earlier // tiles) % b,
                earlier % tiles) == (k, bi, x)
    chained = runs_chained(b, c)
    assert chained == (tile == LANES)
    words = link_words(chained, b, s, c)
    if not chained:
        assert words == 0 and fold_steps(chained, s) == s
    else:
        # the links of every chunk but the last, then room for the ticket
        assert words >= (-(-s // chunk) - 1) * b * c + 1
        assert fold_steps(chained, s) == chunk // WARPS


def test_scan_plan_shapes_of_the_main_path():
    """One pass at Falcon-Mamba's prefill (4 columns a thread); the
    chained design at the RG-LRU's, with at least two blocks a SM."""
    assert scan_plan(1, 512, 131072) == (PASS_THREADS * PASS_COLUMNS, 512,
                                         128)
    assert scan_plan(1, 128, 131072)[1:] == (128, 128)
    # two waves of the chained kernel's 3 resident blocks a SM (f32)
    assert scan_plan(1, 2560, 4096) == (LANES, WARPS * SUB, 2560)
    for s in (2219, 2895):
        assert scan_plan(1, s, 4096)[2] >= 2 * 3 * 132
    # one pass from ONE_PASS_BLOCKS blocks of PASS_THREADS columns up
    assert scan_plan(1, 64, ONE_PASS_BLOCKS * PASS_THREADS)[:2] == (
        PASS_THREADS * PASS_COLUMNS, 64)
    assert scan_plan(1, 64, (ONE_PASS_BLOCKS - 1) * PASS_THREADS)[0] == LANES
    # a C that is not a multiple of 4, or a pointer off 16 bytes, takes
    # the chained design, which takes any C and alignment
    assert scan_plan(1, 64, ONE_PASS_BLOCKS * PASS_THREADS + 2) == \
        design_plan(True, 1, 64, ONE_PASS_BLOCKS * PASS_THREADS + 2)
    assert scan_plan(1, 512, 131072, aligned=False) == design_plan(
        True, 1, 512, 131072)
    assert fold_steps(runs_chained(1, 4096), 2560) == SUB
    assert fold_steps(runs_chained(1, 131072), 512) == 512
