"""Time the selective-scan kernel's two designs -- one pass and chained --
at one shape, each held bit for bit against its plain twin
(``ref.selective_scan_chunked_ref`` at the design's ``fold_steps``: S
for one pass, 16 for the chained design): the measurement behind
``scan_plan``'s ``ONE_PASS_BLOCKS``.  Needs one NVIDIA GPU; run from the
repo root:

    python3 scripts/scan_plan_sweep.py
    python3 scripts/scan_plan_sweep.py --b 4 --s 512 --c 4096

The shape defaults to the RG-LRU prefill of RecurrentGemma-9B (B 1,
S 2,560, C 4,096, f32; one pass needs C a multiple of 4).  The kernel's
C entry point takes the plan -- ``design_plan``'s tile and chunk and
``fold_steps`` -- so each design is launched through it directly; the
wrapper ``selective_scan`` always runs ``scan_plan``'s.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.selective_scan import (  # noqa: E402
    design_plan, fold_steps, link_words, scan_plan)


def sweep(b, s, c) -> list:
    """[(design, blocks, resident blocks a SM, ms)] of the kernel (f32
    inputs, h0 = 0) in each design."""
    lib = _build.load("selective_scan")
    args = cs.scan_inputs(b, s, c, torch.float32)
    sets = cs.copies(args)
    times = []
    for chained, design in enumerate(("one pass", "chained")):
        tile, chunk, blocks = design_plan(chained, b, s, c)
        sub = fold_steps(chained, s)
        n_links = link_words(chained, b, s, c)
        links = torch.zeros(max(n_links, 1), dtype=torch.int64,
                            device="cuda")

        def run(da, dbx, h0, tile=tile, chunk=chunk, sub=sub,
                n_links=n_links, links=links):
            h_all = torch.empty((b, s, c), dtype=torch.float32,
                                device="cuda")
            h_last = torch.empty((b, c), dtype=torch.float32, device="cuda")
            links.zero_()
            err = lib.selective_scan_launch(
                da.data_ptr(), dbx.data_ptr(), h0.data_ptr(),
                h_all.data_ptr(), h_last.data_ptr(), links.data_ptr(),
                n_links, b, s, c, tile, chunk, sub, 0,
                torch.cuda.current_stream().cuda_stream)
            _build.check_launch("selective_scan", err)
            return h_all, h_last

        got = run(*args)
        want = ref.selective_scan_chunked_ref(*args, sub)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"selective_scan {design}: not bit for bit "
                                 f"its plain twin")
        times.append((design, blocks, lib.selective_scan_resident(chained, 0),
                      cs.time_ms(run, sets)))
    return times


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--b", type=int, default=1)
    p.add_argument("--s", type=int, default=2560)
    p.add_argument("--c", type=int, default=4096)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("scan_plan_sweep: needs a GPU", file=sys.stderr)
        return 1
    cs.log(f"card: {cs.card_line()}")
    times = sweep(a.b, a.s, a.c)
    da_bytes = 4 * a.b * a.s * a.c
    b_ms, _ = cs.bound_ms(3 * da_bytes + 8 * a.b * a.c, 2 * a.b * a.s * a.c,
                          torch.float32)
    cs.log(f"selective_scan plans at B {a.b}, S {a.s}, C {a.c} (f32, bound "
           f"{b_ms:.4f} ms; scan_plan picks {scan_plan(a.b, a.s, a.c)}): "
           + "; ".join(f"{k} ({n} blocks, {r} a SM) {ms:.4f} ms"
                       for k, n, r, ms in times) + " (both times include "
           "zeroing the chained design's links)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
