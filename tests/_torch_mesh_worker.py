"""The rank side of ``tests/test_torch_mesh_ranks.py``: one process of a
4-rank gloo world on the ``("pod", "data")`` (2, 2) mesh.  It imports
torch and the port only (no JAX), runs every case in one go and writes its
results for the parent to hold against the single-device port and the
JAX package.  ``run_rank`` is the spawn target."""
import datetime
import os
import pickle
import time
import traceback
import warnings

import numpy as np
import torch
import torch.distributed as dist

JAX_WAIT_S = 240               # the parent's JAX reference, at the latest


class Traffic:
    """Wraps ``torch.distributed``'s collectives (here, in the test, not in
    the program) and logs each call's name and bytes."""

    def __init__(self):
        self.calls = []
        for name in ("all_reduce", "all_gather_into_tensor"):
            orig = getattr(dist, name)

            def wrapped(tensor, *a, _orig=orig, _name=name, **kw):
                arg = a[0] if _name == "all_gather_into_tensor" else tensor
                self.calls.append((_name, arg.numel() * arg.element_size()))
                return _orig(tensor, *a, **kw)
            setattr(dist, name, wrapped)

    def take(self) -> list:
        calls, self.calls = self.calls, []
        return calls


def _gathered_state(fed) -> dict:
    """Every node's state, gathered (collective), as numpy."""
    from repro_torch import bridge
    return bridge.params_to_numpy({
        "gbar": fed.gbar, "train": fed._gathered(fed._trains),
        "opt": fed._gathered(fed._opts), "server_m": fed._server_m,
        "part": getattr(fed, "_part_state", None)})


def _cases(rank: int, inp: dict, jax_path: str) -> dict:
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.core.federation import Federation, FederationConfig
    from repro_torch.core.participation import ParticipationPlan as P
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("pod", "data"), "cpu")
    tiny = get_config("fedmm-small").with_(**inp["tiny"])
    fed = FederationConfig(**inp["fed"])
    traffic, out = Traffic(), {}

    def build(cfg=fed):
        return Federation(cfg, tiny, mesh=mesh)

    # full participation: two single rounds, the first one's traffic
    f = build()
    out["layout"] = ([len(m) for m in f._buckets],
                     [list(m) for m in f._local_buckets])
    traffic.take()
    out["full"] = [f.run_round()]
    out["traffic_full"] = traffic.take()
    out["full"].append(f.run_round())
    # a checkpoint written on rank 0 after those two rounds; restored
    # into a fresh federation on every rank
    f.save(inp["ck_path"])
    g = build()
    out["restore_step"] = g.restore(inp["ck_path"])
    saved, restored = _gathered_state(f), _gathered_state(g)
    out["restore_equal"] = all(
        np.array_equal(a, b) for a, b in zip(_leaves(saved),
                                             _leaves(restored)))
    out["restored_next"] = g.run_round()
    out["saved_next"] = f.run_round()
    # a block of two
    out["block"] = build().run_rounds(2, block_size=2)
    # uniform C 6 on JAX's uniforms
    u = build()
    stage, draws = u._stage_part, iter(inp["uniforms"])

    def staged(m, plan):
        batches, _, pos = stage(m, plan)
        return batches, torch.from_numpy(
            np.stack([next(draws) for _ in range(m)])), pos
    u._stage_part = staged
    plan = P(**inp["uniform"])
    traffic.take()
    out["uniform"] = u.run_rounds(1, participation=plan)
    out["traffic_uniform"] = traffic.take()
    out["uniform"] += u.run_rounds(1, participation=plan)
    # async
    a = build()
    plan = P(**inp["async"])
    traffic.take()
    out["async"] = a.run_rounds(1, participation=plan)
    out["traffic_async"] = traffic.take()
    out["async"] += a.run_rounds(2, participation=plan)
    # the layout fallback: buckets of 2 and 6 nodes over 4 ranks
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        fb = build(FederationConfig(**inp["fallback"]))
    out["fallback_warnings"] = [str(w.message) for w in caught
                                if "falling back" in str(w.message)]
    out["fallback_layout"] = [len(m) for m in fb._buckets]
    out["fallback"] = [fb.run_round()]
    # the data pipeline: this rank's node rows of every block
    from repro_torch.data import pipeline as pipe
    out["pipeline"] = _pipeline_rows(pipe, mesh, slice(2 * rank,
                                                       2 * rank + 2))
    # the second round against the JAX package: its state and draws come
    # from the parent, which computes them while the cases above run
    deadline = time.monotonic() + JAX_WAIT_S
    while not os.path.exists(jax_path):
        if time.monotonic() > deadline:
            raise TimeoutError("no JAX reference from the parent")
        time.sleep(0.05)
    with open(jax_path, "rb") as fh:
        ref = pickle.load(fh)
    j = build()
    bridge.load_engine_state(j, ref["state"])
    lo = [(j.engine._shard * n, (j.engine._shard + 1) * n)
          for n in j.engine.local_sizes]
    mine = tuple({k: torch.from_numpy(v[:, :, a:b]) for k, v in d.items()}
                 for d, (a, b) in zip(ref["draws"], lo))
    j._stage = lambda m: mine
    out["jax"] = j.run_round()
    state = _gathered_state(j)              # collective: every rank
    out["jax_state"] = state if rank == 0 else None
    return out


def _pipeline_rows(pipe, mesh, rows) -> bool:
    """``BlockStager``, ``stack_block_batches`` and ``shard_batch`` under
    the mesh give the rank's ``rows`` of what they give without one."""
    def streams():
        return [iter(pipe.SyntheticLMStream(64, 8, 2, seed=i))
                for i in range(8)]
    full = pipe.BlockStager(streams(), 2, 2).next_block()
    mine = pipe.BlockStager(streams(), 2, 2, sharding=mesh).next_block()
    grid = [[[{"x": np.full((3,), 10 * m + k)} for k in range(8)]
             for _ in range(2)] for m in range(2)]
    flat = {"x": np.arange(16).reshape(8, 2)}
    return (all(torch.equal(mine[k], full[k][:, :, rows]) for k in full)
            and torch.equal(
                pipe.stack_block_batches(grid, sharding=mesh)["x"],
                pipe.stack_block_batches(grid)["x"][:, :, rows])
            and torch.equal(pipe.shard_batch(flat, mesh)["x"],
                            torch.from_numpy(flat["x"][rows])))


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [np.asarray(tree)]


def run_rank(rank: int, world: int, store: str, inp_path: str,
             jax_path: str, out_path: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        with open(inp_path, "rb") as fh:
            inp = pickle.load(fh)
        out = _cases(rank, inp, jax_path)
    except BaseException:
        out = {"error": traceback.format_exc()}
    finally:
        dist.destroy_process_group()
    with open(out_path % rank, "wb") as fh:
        pickle.dump(out, fh)
