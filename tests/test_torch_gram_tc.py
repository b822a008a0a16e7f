"""The arithmetic of the port's redesigned ``gram`` kernel, on the CPU.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it against
its plain version there).  What its design adds to the plain arithmetic
is checked here, against JAX's ``repro.core.cka.cosine_gram`` and the
Pallas kernel (interpret mode) in one process, from numpy inputs:

- a plain emulation of the kernel's sums: 32 x 32 tiles over the tile
  pairs I <= J, each stored twice; each tile's f32 partial sums taken
  one k16 step at a time within each warp's columns of each 128-wide
  chunk, the warps of a CTA added in order, the D ranges of the
  wrapper's ``gram_plan`` (the CTAs of a cluster) added in rank order;
  the row norms summed the same way from the squares of the same
  values (the kernel takes them from its mma fragments); rows scaled
  by rsqrt(max(|x|^2, 1e-8)).  Tolerance 1e-5 of max(1, |value|) against
  JAX, the Pallas kernel and the plain version, for bf16 and f32 inputs
  alike: all take f32 sums of the same exact products, in other orders,
  and a looser limit would miss a wrong sum (an off-diagonal cosine is
  ~D^-0.5);
- the wrapper's choice: ``gram_plan``'s ranges cover D once and give
  at least as many CTAs as the first port's grid (ceil(B / 16)^2 x K)
  at the round's two shapes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cka as jcka  # noqa: E402
from repro.kernels.gram import cosine_gram_pallas  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.gram import (  # noqa: E402
    CHUNK, EPS, MAX_SPLITS, TARGET_BLOCKS, TILE, WARPS, gram_plan, n_blocks,
    n_tile_pairs)
from _torch_threads import _one_thread  # noqa: E402,F401


TOL = 1e-5                                    # of max(1, |value|)
DT = {"float32": (torch.float32, jnp.float32),
      "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _rnd(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ranges(d, n_split, d_split):
    return [(z * d_split, min(d, (z + 1) * d_split)) for z in range(n_split)]


def emulate(x):
    """The kernel's arithmetic on x (K, B, D): see the module docstring.
    Returns the (K, B, B) Gram in f32."""
    x = x.float()
    k, b, d = x.shape
    n_split, d_split = gram_plan(k, b, d)
    nt = -(-b // TILE)
    xp = torch.zeros((k, nt * TILE, d))
    xp[:, :b] = x
    out = torch.zeros((k, nt * TILE, nt * TILE))
    pairs = [(i, j) for i in range(nt) for j in range(i, nt)]
    assert len(pairs) == n_tile_pairs(b)
    for node in range(k):
        for ti, tj in pairs:
            xi = xp[node, ti * TILE:(ti + 1) * TILE]
            xj = xp[node, tj * TILE:(tj + 1) * TILE]
            tot = ssi = ssj = None
            for lo, hi in _ranges(d, n_split, d_split):   # rank order
                cta = cssi = cssj = None
                for w in range(WARPS):                    # warp order
                    acc = torch.zeros((TILE, TILE))
                    si, sj = torch.zeros(TILE), torch.zeros(TILE)
                    for c0 in range(lo, hi, CHUNK):
                        w0 = c0 + w * CHUNK // WARPS
                        for kk in range(w0, min(hi, w0 + CHUNK // WARPS),
                                        16):
                            a, bb = xi[:, kk:kk + 16], xj[:, kk:kk + 16]
                            acc = acc + a @ bb.T
                            si = si + (a * a).sum(1)
                            sj = sj + (bb * bb).sum(1)
                    cta = acc if cta is None else cta + acc
                    cssi = si if cssi is None else cssi + si
                    cssj = sj if cssj is None else cssj + sj
                tot = cta if tot is None else tot + cta
                ssi = cssi if ssi is None else ssi + cssi
                ssj = cssj if ssj is None else ssj + cssj
            g = (tot * torch.rsqrt(ssi.clamp_min(EPS))[:, None]
                 * torch.rsqrt(ssj.clamp_min(EPS))[None, :])
            rows = slice(ti * TILE, (ti + 1) * TILE)
            cols = slice(tj * TILE, (tj + 1) * TILE)
            out[node, rows, cols] = g                 # stored twice
            out[node, cols, rows] = g.T
    return out[:, :b, :b]


def _rel_err(got, want):
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


#: name -> (K, B, D); rows 3 and, where B > 5, 5 are zero (the eps clamp)
SHAPES = {"loss (32, 768)": (1, 32, 768),
          "ragged (37, 100)": (1, 37, 100),
          "B 1 (1, 768)": (1, 1, 768),
          "K 3 (3, 20, 300)": (3, 20, 300),
          "three row tiles (1, 70, 264)": (1, 70, 264)}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_emulation_matches_jax(name, dtype):
    k, b, d = SHAPES[name]
    td, jd = DT[dtype]
    xn = _rnd(b * d + k, (k, b, d))
    for row in (3, 5):
        if row < b:
            xn[:, row] = 0.0
    x = torch.from_numpy(xn).to(td)
    got = emulate(x)
    jx = jnp.asarray(x.float().numpy(), jd)
    assert _rel_err(got, jax.vmap(jcka.cosine_gram)(jx)) <= TOL
    pallas = np.stack([np.asarray(cosine_gram_pallas(jx[i], block=16,
                                                     interpret=True))
                       for i in range(k)])
    assert _rel_err(got, pallas) <= TOL
    assert _rel_err(got, tref.cosine_gram_ref(x)) <= TOL
    if b > 3:                                   # a zero row: zero similarities
        assert got[:, 3].abs().max() == 0 and got[:, :, 3].abs().max() == 0


# ----------------------------------------------------------------------
# the wrapper's plan
ROUND_SHAPES = {"loss": (1, 32, 768), "upload": (4, 32, 768)}


@pytest.mark.parametrize("where", sorted(ROUND_SHAPES))
def test_gram_plan_gives_more_ctas_than_the_first_port(where):
    k, b, d = ROUND_SHAPES[where]
    first_port = k * (-(-b // 16)) ** 2             # 16 x 16 tiles, D serial
    assert n_blocks(k, b, d) >= first_port


@pytest.mark.parametrize("kbd", [(1, 32, 768), (4, 32, 768), (1, 37, 100),
                                 (1, 1, 768), (1, 128, 5120), (16, 32, 768),
                                 (3, 20, 300), (1, 8, 1), (2, 64, 129),
                                 (1, 200, 100000), (2, 1, 5120)])
def test_gram_plan_ranges_cover_d_once(kbd):
    k, b, d = kbd
    n_split, d_split = gram_plan(k, b, d)
    assert 1 <= n_split <= MAX_SPLITS
    assert d_split % CHUNK == 0 and d_split >= CHUNK
    cover = np.zeros(d, np.int32)
    for lo, hi in _ranges(d, n_split, d_split):
        assert hi > lo                            # no empty range
        cover[lo:hi] += 1
    assert (cover == 1).all()
    assert n_blocks(k, b, d) == k * n_tile_pairs(b) * n_split


def test_gram_plan_at_the_listed_shapes():
    """One CTA a 128-wide chunk while the tiles leave the card short of
    TARGET_BLOCKS; no split once they fill it."""
    assert gram_plan(1, 32, 768) == (6, 128)          # 6 CTAs (was 4)
    assert gram_plan(4, 32, 768) == (6, 128)          # 24 (was 16)
    assert gram_plan(16, 32, 768) == (6, 128)         # 96
    assert gram_plan(1, 128, 5120) == (8, 640)        # 10 pairs x 8 ranges
    assert gram_plan(1, 37, 100) == (1, 128)          # one chunk
    assert gram_plan(200, 32, 768)[0] == 1            # 200 tiles fill it
    assert TARGET_BLOCKS == 132


def test_n_tile_pairs_is_the_upper_triangle():
    assert [n_tile_pairs(b) for b in (1, 32, 33, 64, 65, 128)] == \
        [1, 1, 3, 3, 6, 10]

