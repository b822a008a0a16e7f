"""Time the absorbed-MLA decode kernel's designs at some pools over the
wgmma design's plans: its share budget G and the least tiles a share
(``least``), beside the mma design at ``split_plan``'s chunks.  Each
plan is held against the plain version (``chip_smoke``'s element-by-
element limits) and bit for bit against a second launch, then timed
twice, the plans in order and then in reverse, so that a drift of the
card's clock shows as a spread.  The measurement behind ``mla_plan``'s
choice of design, of G and of ``WG_LEAST``.  Needs one NVIDIA GPU; run
from the repo root:

    python3 scripts/mla_plan_sweep.py
    python3 scripts/mla_plan_sweep.py --case pool "H 64" --least 1 2 3 4
    python3 scripts/mla_plan_sweep.py --pool 64 256 128 random

``--case`` takes ``pool`` (DeepSeek-V2's serve pool, S 8, C 4,352, H 128,
lens 0 to C: ``chip_smoke.MLA_POOL``) or names of
``chip_smoke.MLA_POOL_CASES``; ``--pool S C H full|random`` adds a pool
whose slots are all at lens C or at lens drawn from a seed.  G defaults
to ``share_budget`` at one tile a share.  ``launch_design`` launches a
named design at a given plan; the wrapper ``mla_decode`` always runs
``mla_plan``'s.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.mla_decode import (  # noqa: E402
    WG_HEADS, launch_design, mla_plan, share_budget, share_plan, split_plan)


def plans(s, c, h, shares, least) -> list:
    """(design, n_split, split_len) of the mma design and, where the head
    count takes it, of the wgmma design at each (G, least)."""
    out = [("mma", *split_plan(s, h, c))]
    if h in (WG_HEADS, 2 * WG_HEADS):
        gs = shares or [share_budget(s, h, c, 1)]
        out += [("wgmma", g, f) for g in gs if g >= s for f in least]
    return out


def sweep(s, c, h, lens, shares, least) -> list:
    """[(plan, pieces, ms first pass, ms second pass)] at the pool."""
    args = cs.mla_inputs(s, c, h, lens, torch.bfloat16, seed=c)
    sets = cs.copies(args)
    want = ref.mla_decode_ref(*args, cs.MLA_SCALE)
    runs = {}
    for plan in plans(s, c, h, shares, least):
        def run(*x, plan=plan):
            return launch_design(*x, cs.MLA_SCALE, *plan)

        got = run(*args)
        cs.attn_err("mla_decode", f"{plan}", got, want)
        if not torch.equal(got, run(*args)):
            raise AssertionError(f"mla_decode {plan}: two launches differ")
        runs[plan] = run
    times = {p: [] for p in runs}
    for order in (list(runs), list(runs)[::-1]):
        for plan in order:
            times[plan].append(cs.time_ms(runs[plan], sets))
    rows = []
    for plan, (a, b) in times.items():
        pieces = (sum(p >= 0 for *_, p in share_plan(lens, c, *plan[1:]))
                  if plan[0] == "wgmma" else plan[1] * s)
        rows.append((plan, pieces, a, b))
    return rows


def pools(a) -> dict:
    """name -> (S, C, H, lens) of the cases and pools asked for."""
    out = {name: cs.MLA_POOL if name == "pool" else cs.MLA_POOL_CASES[name]
           for name in a.case}
    rng = np.random.default_rng(26)
    for s, c, h, kind in a.pool:
        s, c, h = int(s), int(c), int(h)
        lens = ([c] * s if kind == "full"
                else rng.integers(0, c + 1, s).tolist())
        out[f"S {s}, C {c}, H {h}, {kind}"] = (s, c, h, lens)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--case", nargs="*", default=["pool"],
                   help="'pool' or names of chip_smoke.MLA_POOL_CASES")
    p.add_argument("--pool", nargs=4, action="append", default=[],
                   metavar=("S", "C", "H", "LENS"),
                   help="a pool of S slots of C positions at H heads, "
                        "lens 'full' or 'random'")
    p.add_argument("--shares", type=int, nargs="*", default=[])
    p.add_argument("--least", type=int, nargs="+", default=[1, 2, 3, 4, 6])
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("mla_plan_sweep: needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.log(f"card: {cs.card_line()}")
    _build.build_all(["mla_decode"])
    for name, (s, c, h, lens) in pools(a).items():
        cs.log(f"mla_decode plans at {name} (S {s}, C {c}, H {h}, lens "
               f"{lens}); mla_plan picks {mla_plan(torch.bfloat16, s, h, c)}")
        for plan, pieces, t1, t2 in sweep(s, c, h, lens, a.shares, a.least):
            cs.log(f"  {plan[0]:>5} n_split {plan[1]:>3} split_len "
                   f"{plan[2]:>4}: {pieces:>3} pieces / chunks, {t1:.4f} / "
                   f"{t2:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
