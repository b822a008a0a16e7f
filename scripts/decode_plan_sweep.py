"""Time the decode kernel at 4 to 128 chunks of one sliding-window pool,
each plan held against the plain version: the measurement behind
``split_plan``'s ``MIN_CHUNK_PER_REP``.  Needs one NVIDIA GPU; run from
the repo root:

    python3 scripts/decode_plan_sweep.py
    python3 scripts/decode_plan_sweep.py --pool "windowed fedmm-base ring"

The pools are ``chip_smoke.WINDOW_POOLS`` (bf16, the ring as wide as the
window).  The kernel's C entry point takes the plan (n_split, split_len)
as arguments, so each plan is launched through it directly; the wrapper
``decode_attention`` always runs ``split_plan``'s.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    split_len_for, split_plan)


def sweep(s, c, n_kv, rep, dh, lens, chunks=(4, 8, 16, 32, 64, 128)) -> list:
    """[(n_split, split_len, ms)] of the kernel at about each of
    ``chunks`` chunks of the pool."""
    lib = _build.load("decode_attention")
    args = cs.decode_inputs(s, c, n_kv, rep, dh, lens, torch.bfloat16,
                            window=c)
    want = ref.decode_attention_ref(*args, window=c)
    sets = cs.copies(args)
    times = []
    for n in chunks:
        n_split, split_len = split_len_for(c, dh, n)
        part = torch.empty(s * n_kv * n_split * rep * (dh + 2),
                           dtype=torch.float32, device="cuda")

        def run(q, k, v, q_pos, pos, n_split=n_split, split_len=split_len,
                part=part):
            out = torch.empty_like(q)
            err = lib.decode_attention_launch(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                pos.data_ptr(), out.data_ptr(), part.data_ptr(), s, c, n_kv,
                rep, dh, c, 0, float(dh ** -0.5), 1, n_split, split_len,
                torch.cuda.current_stream().cuda_stream)
            _build.check_launch("decode_attention", err)
            return out

        cs.attn_err("decode", f"plan {n_split} x {split_len}", run(*args),
                    want)
        times.append((n_split, split_len, cs.time_ms(run, sets)))
    return times


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pool", default="hybrid (RecurrentGemma ring)",
                   choices=sorted(cs.WINDOW_POOLS))
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("decode_plan_sweep: needs a GPU", file=sys.stderr)
        return 1
    s, c, n_kv, rep, dh, lens = cs.WINDOW_POOLS[a.pool]
    cs.log(f"card: {cs.card_line()}")
    times = sweep(s, c, n_kv, rep, dh, lens)
    cs.log(f"decode_attention plans at {a.pool}: S {s}, C {c}, KV {n_kv}, "
           f"rep {rep}, dh {dh} (bf16; split_plan picks "
           f"{split_plan(s, n_kv, c, dh, rep)}): " + "; ".join(
               f"{n} x {n_len} {ms:.4f} ms" for n, n_len, ms in times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
