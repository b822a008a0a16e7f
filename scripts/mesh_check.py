"""Run the sharded federation across the cards of one host, one process a
card, and hold it against the single-device federation.

    python3 scripts/mesh_check.py                  # 4 cards
    python3 scripts/mesh_check.py --device cpu --tiny   # gloo rehearsal

Rank r runs on ``cuda:r`` (gloo processes on the CPU); the ranks meet on
a file store under ``build/mesh_check/`` and form the ``("pod", "data")``
mesh (2, R / 2).  Two cells of ``Federation`` (geodora, precision, 16
nodes: 4 modalities x 4, so 4 width buckets of 4, R / 4 nodes of each on
a rank when R divides 16):

- **check**: fedmm-small at full width, 4 layers, f32, 2 local steps:
  two rounds, a block of 2, and blocks of 2 under ``uniform`` C 8 and
  ``async``.  Every rank's records must equal every other's, and the
  same runs of the single-device federation (this process, on
  ``cuda:0``, after the ranks exit): cohorts and events exactly,
  records within ``TOL`` (the f32 bound of ``chip_smoke.ENGINE_TOL``:
  the server sums R partial sums, and the trunk runs stacks of 16 / R
  nodes, in other orders);
- **time**: fedmm-small at full width and depth in bf16, 10 local steps:
  the round and the 2-round block captured (on the card), then 3
  replayed rounds and one replayed block, each rank with the unsharded
  engine's exact launches; walls beside the single-device federation's
  on the same 16 nodes.

First every rank checks one eager and one captured ``all_reduce``.
Each step prints its seconds, so a run that hangs shows where.  A
collective times out after 60 s.  Each rank writes its results before
it destroys its process group (that teardown has hung on 4 H100s after
the graphs' NCCL collectives had run); ranks alive 10 s after their
results, or at ``--join-s``, are killed.  Prints the card
(``nvidia-smi``), each cell's numbers and one JSON line; exits non-zero
on any mismatch or failed rank.
"""
from __future__ import annotations

import argparse
import datetime
import json
import math
import multiprocessing as mp
import os
import pickle
import shutil
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

TOL = 1e-3                  # f32 records, as chip_smoke.ENGINE_TOL's
NODES = 16
TINY = dict(n_layers=1, d_model=32, n_heads=2, n_kv_heads=1, head_dim=16,
            d_ff=64, vocab_size=128, dtype="float32")
LAUNCHES = ("lora_matmul", "flash_attention", "cosine_gram")


def _cells(tiny: bool):
    """(config, FederationConfig) of the check and the time cell."""
    from repro_torch.configs import get_config
    from repro_torch.core.federation import FederationConfig
    base = get_config("fedmm-small")
    if tiny:
        small = base.with_(**TINY)
        fed = dict(n_nodes=NODES, local_steps=1, local_batch=4,
                   anchors_per_class=1, n_tokens=2, lora_rank=2)
        return ((small, FederationConfig(method="geodora", **fed)),
                (small, FederationConfig(method="geodora", **fed)))
    return ((base.with_(n_layers=4, dtype="float32"),
             FederationConfig(method="geodora", n_nodes=NODES,
                              local_steps=2)),
            (base, FederationConfig(method="geodora", n_nodes=NODES)))


def _plans():
    from repro_torch.core.participation import ParticipationPlan as P
    return {"uniform": P(strategy="uniform", cohort_size=8, seed=0),
            "async": P(strategy="async", lag_dist="geometric", max_lag=3,
                       transient_rate=0.2, crash_rate=0.1,
                       poison_nodes=(1,), seed=3)}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _counts() -> dict:
    from repro_torch.graphs import COUNTED
    return {fn.__name__: fn.launches for fn in COUNTED
            if fn.__name__ in LAUNCHES}


def _say(what: str, t0: float = [time.perf_counter()]) -> None:
    """Progress on stdout, so a run that hangs shows where."""
    print(f"[{time.perf_counter() - t0[0]:7.1f} s] {what}", flush=True)


def basics(dev, group_rank: int, world: int) -> None:
    """One eager ``all_reduce`` and one captured in a CUDA graph and
    replayed twice, each checked: the collectives alone, before any
    federation."""
    import torch.distributed as dist
    x = torch.full((4,), float(group_rank + 1), device=dev)
    dist.all_reduce(x)
    want = world * (world + 1) / 2
    if x.tolist() != [want] * 4:
        raise AssertionError(f"eager all_reduce {x.tolist()}, want {want}")
    if dev.type != "cuda":
        return
    y = torch.ones((4,), device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        dist.all_reduce(y)
    torch.cuda.current_stream(dev).wait_stream(side)
    y.fill_(1.0)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        dist.all_reduce(y)
    for _ in range(2):
        graph.replay()
    torch.cuda.synchronize(dev)
    if y.tolist() != [float(world ** 2)] * 4:
        raise AssertionError(f"captured all_reduce {y.tolist()}, want "
                             f"{world ** 2}")


def run_cells(make, tiny: bool, dev) -> dict:
    """The check cell's records and the time cell's numbers, on the
    federations ``make(cfg, fcfg)`` builds."""
    (ccfg, cfcg), (tcfg, tfcg) = _cells(tiny)
    out = {}
    f = make(ccfg, cfcg)
    _say("check cell: federation built")
    out["rounds"] = [f.run_round(), f.run_round()]
    _say("check cell: 2 rounds")
    out["block"] = make(ccfg, cfcg).run_rounds(2, block_size=2)
    _say("check cell: a block of 2")
    for name, plan in _plans().items():
        out[name] = make(ccfg, cfcg).run_rounds(2, block_size=2,
                                                participation=plan)
        _say(f"check cell: {name}")
    del f
    f = make(tcfg, tfcg)
    _say("time cell: federation built")
    caps, walls, per_round = [], [], []

    def capture(m: int) -> None:
        if dev.type == "cuda":
            _sync(dev)
            t0 = time.perf_counter()
            f.capture(m)
            _sync(dev)
            caps.append(time.perf_counter() - t0)
            _say(f"time cell: the {m}-round graph captured")

    # each graph is replayed before the next is captured
    capture(1)
    for r in range(3):
        before = _counts()
        _sync(dev)
        t0 = time.perf_counter()
        rec = f.run_round()
        _sync(dev)
        walls.append(time.perf_counter() - t0)
        per_round.append({k: v - before[k] for k, v in _counts().items()})
        if not all(math.isfinite(rec[k]) for k in ("task_loss", "geo_loss")):
            raise AssertionError(f"non-finite record {rec}")
        _say(f"time cell: round {r} replayed")
    capture(2)
    _sync(dev)
    t0 = time.perf_counter()
    f.run_rounds(2, block_size=2)
    _sync(dev)
    _say("time cell: a block of 2 replayed")
    out["time"] = dict(captures=caps, walls=walls, launches=per_round,
                       block_wall=time.perf_counter() - t0,
                       replays=f.engine.stats["replays"],
                       peak_gib=(torch.cuda.max_memory_allocated(dev)
                                 / 2 ** 30 if dev.type == "cuda" else None))
    return out


def rank_main(rank: int, ranks: int, device: str, tiny: bool,
              work: str) -> None:
    import torch.distributed as dist
    from repro_torch.core.federation import Federation
    from repro_torch.launch.mesh import make_mesh
    if device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{work}/store", rank=rank,
                            world_size=ranks,
                            timeout=datetime.timedelta(seconds=60))
    _say(f"rank {rank}: process group")
    try:
        mesh = make_mesh((2, ranks // 2), ("pod", "data"),
                         f"cuda:{rank}" if device == "cuda" else "cpu")
        dev = torch.device(f"cuda:{rank}" if device == "cuda" else "cpu")
        _say(f"rank {rank}: mesh {mesh}")
        basics(dev, rank, ranks)
        _say(f"rank {rank}: eager and captured all_reduce")
        out = run_cells(lambda cfg, fcfg: Federation(fcfg, cfg, mesh=mesh),
                        tiny, dev)
    except BaseException:
        out = {"error": traceback.format_exc()}
    # the results first: on 4 H100s the teardown below has hung after the
    # graphs' NCCL collectives had run, and the parent ends such ranks
    with open(f"{work}/rank{rank}.tmp", "wb") as fh:
        pickle.dump(out, fh)
    os.replace(f"{work}/rank{rank}.tmp", f"{work}/rank{rank}.pkl")
    _say(f"rank {rank}: results written")
    dist.destroy_process_group()
    _say(f"rank {rank}: done")


def _diff(a: list, b: list) -> float:
    keys = ("task_loss", "geo_loss", "acc", "cross_node_cka")
    return max(abs(x[k] - y[k]) for x, y in zip(a, b) for k in keys)


def _weights_diff(a: list, b: list) -> float:
    return max(max(abs(p - q) for p, q in zip(x["weights"], y["weights"]))
               for x, y in zip(a, b))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="a 1-layer d_model 32 model (the CPU rehearsal)")
    ap.add_argument("--join-s", type=float, default=300.0)
    args = ap.parse_args()
    if args.ranks not in (2, 4):
        raise SystemExit(f"--ranks {args.ranks}: the (2, R / 2) mesh over "
                         f"4 buckets of {NODES // 4} nodes takes R 2 or 4")
    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            raise SystemExit(f"{args.ranks} ranks need as many cards; "
                             f"{torch.cuda.device_count()} visible")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
        print(f"cards: {card.stdout.strip()}", flush=True)
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        _build.build_all()                 # once, before the ranks load
        print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    work = ROOT / "build" / "mesh_check"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(
        r, args.ranks, args.device, args.tiny, str(work)))
        for r in range(args.ranks)]
    for p in procs:
        p.start()
    files = [work / f"rank{r}.pkl" for r in range(args.ranks)]
    while time.perf_counter() - t0 < args.join_s and not all(
            f.exists() or not p.is_alive() for f, p in zip(files, procs)):
        time.sleep(0.5)
    ranks_s = time.perf_counter() - t0
    for p in procs:
        p.join(10)
    torn = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in torn:
        procs[r].kill()
        procs[r].join(10)
    if torn:
        print(f"ranks {torn} had not ended 10 s after their results (or "
              f"the deadline) and were killed", flush=True)
    outs = []
    for r, f in enumerate(files):
        if not f.exists():
            print(f"rank {r} wrote no results (exit {procs[r].exitcode})",
                  flush=True)
            return 1
        with open(f, "rb") as fh:
            outs.append(pickle.load(fh))
        if "error" in outs[-1]:
            print(f"rank {r} failed:\n{outs[-1]['error']}", flush=True)
            return 1
    print(f"ranks: {ranks_s:.1f} s with spawn and set-up", flush=True)

    from repro_torch.core.federation import Federation
    dev = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    if args.device == "cpu":
        torch.set_num_threads(1)
    t0 = time.perf_counter()
    want = run_cells(lambda cfg, fcfg: Federation(fcfg, cfg, device=dev),
                     args.tiny, dev)
    print(f"single device: {time.perf_counter() - t0:.1f} s", flush=True)

    bad = []
    cases = ("rounds", "block", "uniform", "async")
    for r, out in enumerate(outs):
        for case in cases:
            if out[case] != outs[0][case]:
                bad.append(f"rank {r} {case}: records differ from rank 0's")
    events = ("participation", "cohort_size", "delivered", "staleness",
              "quarantined", "n_delivered")
    report = {}
    for case in cases:
        got, exp = outs[0][case], want[case]
        for key in events:
            if [x.get(key) for x in got] != [x.get(key) for x in exp]:
                bad.append(f"{case}: {key} differs")
        report[case] = dict(records=_diff(got, exp),
                            weights=_weights_diff(got, exp))
        if max(report[case].values()) > TOL:
            bad.append(f"{case}: {report[case]} above {TOL}")
        print(f"check {case}: max |diff| records "
              f"{report[case]['records']:.3g}, weights "
              f"{report[case]['weights']:.3g} (tol {TOL}); participation "
              f"{[x.get('participation') for x in got]}", flush=True)
    engine = want["time"]["launches"][0]
    for r, out in enumerate(outs):
        t = out["time"]
        if any(x != engine for x in t["launches"]):
            bad.append(f"rank {r}: launches {t['launches']}, the unsharded "
                       f"round's {engine}")
        print(f"time rank {r}: captures {t['captures']} s, round walls "
              f"{t['walls']} s, block of 2 {t['block_wall']:.3f} s, "
              f"launches a round {t['launches'][-1]}, peak "
              f"{t['peak_gib']} GiB", flush=True)
    w = want["time"]
    print(f"time single device: captures {w['captures']} s, round walls "
          f"{w['walls']} s, block of 2 {w['block_wall']:.3f} s, launches a "
          f"round {w['launches'][-1]}, peak {w['peak_gib']} GiB", flush=True)
    print(json.dumps({"ranks": args.ranks, "device": args.device,
                      "check": report,
                      "time": {"ranks": [o["time"] for o in outs],
                               "single": w},
                      "ok": not bad}), flush=True)
    for b in bad:
        print(f"MISMATCH {b}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
