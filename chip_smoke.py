"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on a mismatch (the script then exits
non-zero and prints no result):

1. build: ``nvcc`` compiles every CUDA source of the port for sm_90a,
   one process per source, all at once; ptxas's registers and spills of
   each kernel, and the count of tensor-core instructions (HMMA / HGMMA)
   in each flash, lora_matmul and gram kernel's SASS where ``cuobjdump``
   exists, are printed;
2. kernels: each kernel is held against its plain PyTorch version on the
   card, in bf16 and f32, at the shapes its paths give it -- decode
   (fedmm-base: S 8, C 1024, KV 8, rep 2, dh 64, split in 8 chunks; the
   GQA groupings of smollm-135m and yi-6b; a slot whose visible entries
   lie in one chunk only; S 64, C 128, which runs one chunk), flash
   (T 512 and a ragged 300 for prefill; T 16 with rep 3, T 1, a ragged
   T 65, T 100 against S 300, dh 128 and B 4; B 32, T 16, H 12, KV 4 for
   the federated round, with its gradient), gram (the loss's (32, 768),
   the upload's (4, 32, 768), a ragged (37, 100), B 1, (128, 5120), a
   stack of 16 nodes and rows off 16 bytes; the output to 1e-5 in both
   dtypes, the gradient to 1e-3 in bf16 and 1e-5 in f32; timed beside
   the launch floor, a one-element ``add_``) and lora_matmul (the round's M 512, K 768, N
   768 and 256, rank 8, a ragged case, unaligned rows, r 1, 32, 33 and
   64, M 1, odd N and transposed W / A / B; output, dx and dB; timed
   beside ``torch.matmul(x, W)`` too, and at ranks 33 and 64) and
   selective_scan (Falcon-Mamba's prefill, B 1, S 512 and 128, C =
   d_inner * N = 131,072; a ragged (3, 37, 1000) and S 1 from a nonzero
   h0; RecurrentGemma's prefill, B 1, S 2,560, C = lru_width = 4,096,
   and its prompts of 2,219 and 2,895 tokens; (3, 700, 4,096) and
   (1, 1, 4,096) from a nonzero h0; S one step past and one step short of
   whole chunks; h_all and h_last, each also bit for bit against the
   plain twin of its plan, ``selective_scan_chunked_ref``, and against a
   second launch; one call of each design captured in a CUDA graph and
   replayed twice, bit for bit the eager call; each shape's plan and
   the kernels' resident blocks a SM printed).  Also the sliding window and dh 256:
   flash at the hybrid's (B 1, T 2,560 and 1,024, H 16, KV 1, dh 256,
   window 2,048) and the windowed fedmm-base's (T 8,448, H 16, KV 8, dh
   64, window 8,192), smaller windowed / dh 256 cases and a windowed
   gradient; decode over the hybrid's ring (S 8, C 2,048, KV 1, rep 16,
   dh 256, slots wrapped) and fedmm-base's (S 4, C 8,192, KV 8, rep 2),
   and a window narrower than the ring.  Llama4's chunked mask: flash at
   Scout's prefill (B 1, T 8,448, H 40, KV 8, dh 128, chunk 8,192; the
   plain version run by KV head groups), chunk 48 at T 300, T 100
   against S 300, B 4 at dh 64, chunks 37, 1 and 72 (dh 128, 128, 256)
   and a chunked gradient; decode over Scout's ring (S 8, C 8,192, KV 8,
   rep 5, dh 128, slots at positions 8,100, 8,191, 8,192 -- which must
   get its own V -- 8,500, 0, empty, 4,999 and 16,400) at chunk 8,192
   and 1,000.  DeepSeek-V2's MLA: flash at q.k 192 / v 128
   (its prefill B 1, T 4,096, H 128, KV 128, the plain version by head
   groups; ragged T 300, T 100 against S 300, B 2 at rep 4, T 1, a
   gradient; (192, 192) refused) and the absorbed-MLA decode kernel
   ``mla_decode`` over its pool (S 8, C 4,352, H 128, latent 512 + rope
   64; slots at lens 0, 1, 511, 1,000, 2,049, 4,095, C - 1 and C, where
   every entry is visible: the wgmma design ``mla_plan`` picks), S 1 at C
   1, C 1,000 (no whole tiles), H 64, all slots at lens 0, all at C, one
   at C with seven at 0, S 64 at C 128, and the mma design at H 16
   (with a pool that leaves most chunks empty), each in bf16 and f32 (the
   FMA kernel); two eager calls and a CUDA-graph replay bit for bit; the
   output read by the next kernel with no synchronisation between, at a
   pool whose slots leave no piece and at the pool; H 24 and a 256-wide
   latent refused; ptxas's registers, spills and each design's shared
   memory printed; timed beside the mma design (``A B B
   A``), with the plan's shares and pieces, and beside two SDPA calls:
   ``enable_gqa``, and K / V expanded to H heads as views under the first
   backend that takes them (efficient attention; ``library_ms``).  Each
   is timed, in bf16 at each path's
   shapes (the scan in f32, as the prefill gives it), beside its
   plain version, its bound and a PyTorch yardstick the port never
   calls: one call where one computes the same function (SDPA, with a
   boolean mask for a window;
   ``F.cosine_similarity`` for gram; as ``library_ms``; none computes
   the scan's recurrence, which is timed beside ``torch.add`` over the
   same bytes instead, as ``add_ms``), and for gram
   and lora_matmul a composition of calls (``F.normalize`` + ``@``;
   ``torch.addmm(x @ W, x @ A, B)``; as ``composition_ms``).  The
   attention kernels' forward checks hold bf16 outputs element by
   element to ``ATTN_BF16``'s atol + rtol |want| besides ``TOL``;
3. serve: ``ServeEngine`` on fedmm-base at full width (24 layers, bf16,
   random weights from seed 0) serves 16 requests with prompts of 128 to
   512 tokens through 8 slots, M = 8, every decode block one CUDA-graph
   replay (the graph captured first, outside the counted window; its
   capture seconds printed); the launch counters must show that every
   prefill layer ran the flash kernel and every decode step layer the
   decode kernel (24 x steps, 24 x admissions), with one replay and one
   readback per block.  The same stream through ``eager=True`` (the block
   without the graph) must give token-identical records and identical
   ``stats`` (the serve graph oracle).  A second, shorter serve run under
   ``torch.profiler`` reports the device's busy share and time by kernel;
4. serve oracle: one request through the same model on the card and
   with its weights copied to the CPU in f32 (the kernels' plain
   versions); the prefill logits and 8 decode steps must agree.  Then
   the chaos phase, greedy and at temperature 0.7: 12 requests x 64
   tokens under a ``seeded_plan`` of NaN and freeze events plus a
   forced-token window, the stall watchdog and the repetition guard on,
   a snapshot after every block and a simulated crash after block 1,
   then ``ServeEngine.resume`` + ``resume_serve``: every request
   terminal, faults and stalls counted, one graph per plan and engine,
   exact launches, and the resumed records identical to an uncrashed run
   with the same plan;
5. ssm serve: ``ServeEngine`` on falcon-mamba-7b at full width and depth
   (64 layers, d_model 4096, d_inner 8192, state 16, bf16, random weights
   from seed 0) serves the same 16 requests through 8 slots, blocks
   replayed as in 3; every admission must launch the scan kernel once
   per layer and nothing else a kernel, and the eager stream must match
   the replayed one.  A shorter profiled run reports busy share and time
   by kernel, and one request through a 2-layer model at full width is
   held against the CPU in f32 (prefill logits and 8 decode steps, within
   ``TOL`` of max |logit|);
6. hybrid: ``ServeEngine`` on recurrentgemma-9b at full width and depth
   (38 layers: 12 stacked (recurrent, recurrent, attention) groups and a
   tail of 2 recurrent layers; d_model 4096, 16 heads over 1 KV head of
   dh 256, local window 2,048, vocab 256,000; bf16, random weights from
   seed 0, 19.5 GiB) serves 16 requests of 2,200-3,000 prompt tokens x
   64 through 8 slots x 3,072 (rings of 2,048), M = 8, blocks replayed
   as in 3: exactly 12 flash and 26 scan launches per admission and 12
   decode launches per decode step; the eager stream must match the
   replayed one, and a profiled run reports busy share and time by
   kernel.  At 5 layers (one group and the tail) and full width: the
   reference's freeze-and-resume scenario (slot 0 frozen at decode steps
   3-5, stall watchdog 2 and off) must end token-identical to the clean
   run, and a 2,100-token prompt is held against the CPU in f32;
7. windowed dense: fedmm-base at full size under
   ``Runtime(window_override=8192)`` serves 4 requests of 8,300-8,600
   prompt tokens x 32 through 4 slots x 8,704 (rings of 8,192), blocks
   replayed, eager blocks identical, exact launches, positions past the
   config's ``max_seq_len`` of 4,096; a 2-layer model at full width is
   held against the CPU in f32;
8. moe: the memory earlier phases left is freed and printed (the phase
   raises if more than 4 GiB stays reserved), then ``ServeEngine`` on
   llama4-scout-17b-a16e at full width cut to 12 of its 48 layers (d_model
   5,120, 40 heads over 8 KV heads of dh 128, an MoE FFN of 16 routed
   experts top-1 and one shared expert in every layer, chunked attention
   of 8,192, vocab 202,048; bf16, random weights from seed 0, 53 GiB)
   serves 8 requests x 32 tokens through 8 slots x 8,832 (rings of
   8,192), M = 8: six prompts of 8,300-8,700 tokens (each admission
   crosses the chunk boundary) and two of 8,170-8,190 (their decode
   crosses position 8,192).  Blocks replayed as in 3: exactly 12 flash
   launches per admission and 12 decode launches per decode step, the
   eager stream token-identical, tokens/s, TTFT and peak memory; a
   profiled run, and an eager profiled run (two admissions, 8 steps) that
   names the expert GEMMs' share of prefill and decode.  At 1 layer and
   full width, a ~1,000-token prompt and 8 decode steps against the CPU
   in f32 (cache_len 8,192): the card's f32 run must route every
   position to the CPU's expert (read from ``rms_norm``, ``gqa_forward``
   and ``router_scores`` on both sides for the prompt, from the decode
   path's own router calls for the decode steps) and meet 1e-3 of max
   |logit|;
   its bf16 run is held to 5e-2 at the positions that route (and keep or
   drop) as on the CPU, and the flips are printed.  Then MLA, after the
   same freeing: ``ServeEngine`` on deepseek-v2-236b at full width cut
   to 7 of its 60 layers (d_model 5,120, 128 heads, q_lora 1,536,
   kv_lora 512, rope 64, nope 128, v 128, 160 routed experts top-6 + 2
   shared of d_ff 1,536, vocab 102,400; bf16, random weights from seed
   0, 53.75 GiB; the cut printed) serves 8 requests of 1,000-4,200
   prompt tokens x 32 through 8 slots x 4,352, M = 8: exactly 7 flash
   launches (at (192, 128)) per admission and 7 ``mla_decode`` launches
   per decode step, no decode-attention launch, the eager stream
   token-identical, the capture's seconds, a profiled run; at 1 layer
   the same CPU oracle on ~1,000 tokens (top-6 of 160: an f32 flip of
   a near-tie is allowed and held like bf16's, flips printed with the
   CPU router's margins);
9. federation: ``SequentialFederation`` on fedmm-small at full width
   (12 layers, bf16, geodora, precision aggregation, the default 4 nodes
   x 10 local steps, batch 32 x 16 tokens, rank 8) runs 2 rounds; each
   must launch exactly 7,680 lora_matmul (48 GeoLoRA linears, forward
   and dx, in the task and anchor passes of 40 steps), 960 flash and 44
   gram kernels, with finite records and weights summing to 1.  One
   local step under ``torch.profiler`` reports the device's busy share
   and the host's op count.  Then one round at rank 64, the top of the
   kernel's range, on fedmm-small at full width cut to 2 layers, with
   exact launch counts and finite records;
10. federation oracle: one local step from the state the rounds left,
   on the card in bf16 and f32 and through the plain versions on the
   CPU in f32: losses, pooled activations and every gradient must
   agree;
11. engine: the node-stacked ``Federation`` on the same model and
   configuration.  Before it, the node axis of ``lora_matmul`` (x (K,
   512, 768), W and A shared, B per node; K 1, 4 and 16, N 768 and 256,
   r 8 and 64, bf16 and f32; output, dx and dB) is held against its
   plain version and timed beside K launches of the single-node kernel
   and ``torch.baddbmm`` (``per_node_ms``, ``composition_ms``).  The
   round graph and the 2-round block graph are captured (one eager
   warm-up each, outside the counted window), then 2 single rounds and
   one block of 2 rounds are replayed: each must launch exactly what the
   design gives (per round, with the trunk over all nodes' rows: 10
   steps x 2 passes x 48 linears x 2 = 1,920 lora_matmul, 240 flash and
   11 gram), with one replay and one readback, finite records and
   weights summing to 1.  One replayed round under ``torch.profiler``
   reports its device busy share and launches;
12. engine oracle: from one seed, one round through ``Federation``
   (replayed) and one through ``SequentialFederation`` on the card, in
   bf16 and f32, records and trainables within ``ENGINE_TOL``; then one
   eager round of the engine against its replay from the same state;
13. participation: ``Federation`` on the same model with 8 nodes (4
   modalities x 2: 4 width buckets of 2).  Under ``uniform`` C 4 (the
   compact path, one cohort row per bucket) and under ``async``
   (geometric lag p 0.5 capped at 3, transient 0.2, crash 0.1, rejoin
   0.5, node 1's uplink poisoned), the round and the 2-round block are
   captured, then 2 rounds and one block replayed, each with the engine
   round's exact launch counts (1,920 / 240 / 11 a round), one replay and
   one readback, finite records, weights summing to 1 (or 0 on an async
   round that delivers nothing) and zero off the reporters, the cohort's
   per-bucket split, the adapters and moments of nodes that sat out
   unchanged bit for bit, the shipped leaves equal on every node,
   staleness >= 0 exactly where a report was delivered, and node 1
   quarantined once in every round it starts; one replayed round of each
   under ``torch.profiler``.  At 2 layers, one round each of
   ``precision`` C 4 and ``dropout`` 0.25 (the masked path).  Then at 2
   layers in f32 a ``uniform`` and an ``async`` round, replayed, against
   the eager run of the same round (bit-identical) and against
   ``SequentialFederation`` on the card (cohorts and events equal,
   records and trainables within ``ENGINE_TOL``);
14. checkpoints: ``Federation`` under no plan (4 nodes), ``uniform`` C 4
   (8 nodes) and ``async`` (8 nodes, 2 layers): the round graph
   captured, then ``run_rounds(4, block_size=2, checkpoint_path=...,
   checkpoint_every=1)``, which ends a sub-block at every round: 4
   replays, 4 readbacks, files at steps 1-4 (sizes and write seconds
   printed; under ``build/chip_smoke/``, deleted after), exact launches.
   ``ck_2`` restored in place (same tensors, no capture) and into a
   fresh federation (its block graph captured first), each followed by
   2 rounds, must end in the uninterrupted run's state and generators
   bit for bit;
15. the LM driver: ``repro_torch.launch.train`` (``parse_args``,
   ``build``, ``Trainer``: ``main``'s body) on fedmm-small at full width
   and depth with its default flags (4 nodes x 4 local steps, batch 8 x
   128, 16 anchors, rank 8, geodora), blocks of 2, then under
   ``uniform`` C 2: the block graph captured first, then 4 rounds with
   exact launches (per round 744 lora_matmul, 96 flash, 5 gram), one
   replay and one readback per block, finite losses, 4 more rounds
   timed and 2 blocks profiled; at 2 layers in f32 a replayed block
   against the same block run eagerly, bit for bit.  The kernel phases
   also hold every shape the driver gives a kernel against its plain
   version, in bf16 and f32: ``lora_matmul``'s node axis at K 4 and K 2
   (a C 2 cohort) x M 1024 (the task pass) and M 2048 (the anchor pass),
   and K 8 x M 512 (the async round's), output, dx and dB; flash at T
   128, H 12, KV 4 and B 16, 32 and 64 with its gradient; ``gram`` on
   (4, 16, 768).  They time K 4 x M 1024, K 8 x M 512, flash at (B 32,
   T 128) and ``gram`` on (4, 16, 768).

Peak device memory (allocated and reserved) is printed after each
federation phase and after each capture, with what the capture added to
the reserved memory.  Launch counters are set to 0 just before each path
(serve, its eager oracle, chaos, ssm serve and its oracle, the hybrid,
windowed, moe and MLA serves and their oracles, the hybrid freeze runs,
federation, engine, each participation round and block, each
checkpointed run, each driver run) and read
just after; the kernel checks' own launches never count.  A graph
replay adds the launches its capture recorded; a capture's warm-up
launches for real (the chaos phase counts them, the serve phase
captures before its window).  It prints the card's name and power
limit, one JSON line with every
kernel's numbers (the top-level times are its first timed shape's;
``timings`` lists every timed shape with its path), and last
``{"ok": true, "device": {...}}``.  There is no CPU fallback: without
CUDA it exits 1.
"""
from __future__ import annotations

import copy
import dataclasses
import gc
import itertools
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.federation import (LOCAL_KEYS,  # noqa: E402
                                         Federation, FederationConfig,
                                         SequentialFederation)
from repro_torch.core.participation import (  # noqa: E402
    ParticipationPlan, allocate_cohort, n_uniforms)
from repro_torch.data.pipeline import make_lm_batch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, split_bounds, split_plan)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.gram import (  # noqa: E402
    cosine_gram, gram_plan, n_blocks as gram_blocks)
from repro_torch.kernels.lora_matmul import (  # noqa: E402
    _apply as lora_apply, lora_matmul, n_blocks as lora_blocks, tile_plan)
from repro_torch.kernels.mla_decode import (  # noqa: E402
    DESIGNS, launch_design, mla_decode, mla_plan, share_plan,
    split_plan as mla_split_plan)
from repro_torch.kernels.selective_scan import (  # noqa: E402
    LANES, fold_steps, scan_plan, selective_scan)
from repro_torch.graphs import COUNTED  # noqa: E402
from repro_torch.graphs import capture as capture_graph  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.attention import (  # noqa: E402
    gqa_forward, mla_forward)
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models.moe import _capacity, router_scores  # noqa: E402
from repro_torch.serve import (FaultPlan, ServeConfig,  # noqa: E402
                               ServeEngine, SimulatedCrash, init_pool_cache,
                               poisson_requests, scatter_slot, seeded_plan,
                               state_counts)
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

SENTINEL = (2 ** 31 - 1) // 2
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM
PEAK_OPS = {torch.bfloat16: 989e12,           # bf16 tensor cores, dense
            torch.float32: 67e12}             # f32 outside the tensor cores
TOL = {torch.bfloat16: 3e-2, torch.float32: 1e-4}
#: the attention kernels' bf16 outputs are also held element by element,
#: scaled to the plain version's: |got - want| <= atol + rtol * |want|,
#: (rtol, atol) by kernel.  ``TOL`` alone is as large as a typical output
#: where a row sees thousands of keys (its spread is ~sqrt(e / N): 0.036
#: at N 2,048).  Decode keeps P in f32 and differs from the plain version
#: by the output's rounding; flash rounds P to bf16 for its P.V product,
#: so an output near 0 summed from terms near 1 is off by a few 1e-3
#: (the log prints each check's worst element as a share of its limit)
ATTN_BF16 = {"decode": (2 ** -6, 1e-3), "flash": (2 ** -5, 5e-3),
             "mla_decode": (2 ** -5, 5e-3)}
L2_BYTES = 50 * 2 ** 20


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ----------------------------------------------------------------------
# timing
def time_ms(fn, inputs, iters: int = 30) -> float:
    """Mean device ms of ``fn(*inputs[i % n])`` by CUDA events.  The input
    sets together exceed the L2 cache, so every call reads cold inputs, as
    a layer of the serving path does.  A spin kernel holds the card while
    the host enqueues all ``iters`` calls, so the events time the device's
    work and not the host's Python and launch cost (``host_ms`` below)."""
    for i in range(3):
        fn(*inputs[i % len(inputs)])
    torch.cuda.synchronize()
    host = host_ms(fn, inputs, iters)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(2e6 * (host * iters + 5)))    # ~2 GHz: cycles per ms
    start.record()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, inputs, iters: int = 30) -> float:
    """Mean host ms to issue one call -- Python, checks and launch -- timed
    without waiting for the device (the cost a Python caller pays)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*inputs[i % len(inputs)])
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / iters


def copies(tensors, min_bytes: int = 3 * L2_BYTES, cap: int = 64):
    """Enough copies of one input set to exceed ``min_bytes`` in all."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    n = max(1, min(cap, math.ceil(min_bytes / max(size, 1))))
    return [tuple(t.clone() for t in tensors) for _ in range(n)]


def bound_ms(nbytes: float, ops: float, dtype) -> tuple:
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops
                                     else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ----------------------------------------------------------------------
# build report: registers and spills by kernel; tensor-core instructions
def demangle(names):
    """Kernel names without return type, namespace and arguments
    (``flash_mma_kernel<64>``), through ``c++filt`` where it exists."""
    tool = shutil.which("c++filt")
    if not tool or not names:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    if len(out) != len(names):
        return list(names)
    return [n.replace("(anonymous namespace)::", "").removeprefix(
        "void ").split("(")[0] for n in out]


def build_report() -> None:
    """ptxas's registers and spills of every kernel, and the count of
    tensor-core instructions (HMMA / HGMMA) in each kernel of the sources
    with a tensor-core path (flash_attention, lora_matmul, gram) where
    ``cuobjdump`` is on the machine.  A report: it decides nothing."""
    for src, report in sorted(_build.ptxas_report.items()):
        entries, name = [], "?"
        for line in report.splitlines():
            # a kernel, or a device function kept out of line
            hit = re.search(r"Compiling entry function '([^']+)'|"
                            r"Function properties for (\S+)", line)
            if hit:
                name = hit.group(1) or hit.group(2)
            elif "registers" in line or "spill" in line:
                entries.append((name, line.split(":", 1)[-1].strip()))
        names = sorted({n for n, _ in entries})
        short = dict(zip(names, demangle(names)))
        for n, line in entries:
            log(f"  ptxas {src} {short[n]}: {line}")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        log("  cuobjdump: not found (tensor-core instruction count not "
            "reported)")
        return
    for src in ("flash_attention", "lora_matmul", "gram"):
        sass = subprocess.run([tool, "-sass", str(_build._target(src))],
                              capture_output=True, text=True,
                              timeout=120).stdout
        counts, name = {}, None
        for line in sass.splitlines():
            hit = re.search(r"Function : (\S+)", line)
            if hit:
                name = hit.group(1)
                counts[name] = 0
            elif name and re.search(r"\bHG?MMA\b", line):
                counts[name] += 1
        names = sorted(counts)
        for n, short in zip(names, demangle(names)):
            log(f"  SASS {src} {short}: {counts[n]} HMMA / HGMMA "
                f"instructions")


# ----------------------------------------------------------------------
# kernel phase: decode attention
def decode_inputs(s, c, n_kv, rep, dh, lens, dtype, window=0, seed=0):
    """A serving-style pool on the card: slot j holds lens[j] tokens (as a
    ring of width c when ``window``), empty entries at the sentinel; the
    query sits at the slot's newest position, so lens[j] == 0 is a fully
    masked slot."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((s, n_kv * rep, dh), generator=g, device="cuda").to(dtype)
    k = torch.randn((s, c, n_kv, dh), generator=g, device="cuda").to(dtype)
    v = torch.randn((s, c, n_kv, dh), generator=g, device="cuda").to(dtype)
    lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    idx = torch.arange(c, dtype=torch.int32, device="cuda")[None]
    if window:
        wrap = torch.div(lens[:, None] - 1 - idx, c,
                         rounding_mode="floor") * c + idx
        live = (wrap >= 0) & (idx < lens[:, None].clamp(max=c)) \
            & (wrap < lens[:, None])
        pos = torch.where(live, wrap, SENTINEL)
    else:
        pos = torch.where(idx < lens[:, None], idx, SENTINEL)
    q_pos = (lens - 1).clamp(min=0).to(torch.int32)
    return q, k, v, q_pos, pos.to(torch.int32).contiguous()


def attn_err(kernel: str, name: str, got, want) -> float:
    """max |got - want| of the ``kernel`` ("flash", "decode" or
    "mla_decode") attention kernel against its plain version, held to
    ``TOL`` and, in bf16, to ``ATTN_BF16[kernel]`` element by element
    (mla_decode rounds P to bf16 for its P.V product, as flash does);
    raises past either."""
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err, tol = diff.max().item(), TOL[got.dtype]
    ok, note = err <= tol, f"tol {tol}"
    if got.dtype == torch.bfloat16:
        rtol, atol = ATTN_BF16[kernel]
        scaled = (diff / (atol + rtol * want.float().abs())).max().item()
        ok &= scaled <= 1.0
        note += (f"; elementwise {scaled:.3g} of {atol} + {rtol} |want|, "
                 f"want rms {want.float().square().mean().sqrt():.3g}")
    name = f"{kernel}{'' if kernel == 'mla_decode' else '_attention'} {name}"
    log(f"  {name}: max_abs_err {err:.3g} ({note})")
    if not ok:
        raise AssertionError(f"{name}: max_abs_err {err} ({note})")
    return err


def check_decode(name, args, window=0, zero_slots=(), chunk=0):
    got = decode_attention(*args, window=window, chunk=chunk)
    err = attn_err("decode", name, got,
                   ref.decode_attention_ref(*args, window=window,
                                            chunk=chunk))
    for s in zero_slots:
        if got[s].abs().max().item() != 0.0:
            raise AssertionError(f"decode_attention {name}: fully masked "
                                 f"slot {s} is not 0")
    return err


def sdpa_decode(q4, k4, v4, mask):
    return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                          enable_gqa=True)


def decode_phase() -> dict:
    log("kernel phase: decode_attention")
    errs = {}
    # fedmm-base: 8 slots x 1024 positions, mixed depths, a fully masked
    # slot (4) and sentinel-padded tails
    lens = [1024, 700, 513, 1, 0, 300, 64, 1000]
    for dtype in (torch.bfloat16, torch.float32):
        a = decode_inputs(8, 1024, 8, 2, 64, lens, dtype)
        errs[dtype] = check_decode(f"fedmm-base {dtype}", a, zero_slots=(4,))
        ring = decode_inputs(8, 256, 8, 2, 64,
                             [100, 256, 300, 1000, 0, 257, 511, 5], dtype,
                             window=256, seed=1)
        check_decode(f"ring window 256 {dtype}", ring, window=256,
                     zero_slots=(4,))
        check_decode(f"smollm rep 3 {dtype}", decode_inputs(
            8, 1000, 3, 3, 64, [1000, 37, 0, 999, 5, 640, 128, 2], dtype,
            seed=2), zero_slots=(2,))
        check_decode(f"yi-6b rep 8 dh 128 {dtype}", decode_inputs(
            4, 520, 4, 8, 128, [520, 0, 77, 300], dtype, seed=3),
            zero_slots=(1,))
        # slot 3 sees only entries [400, 450): one chunk of the split holds
        # them, every other chunk of the slot is empty
        q, k, v, q_pos, pos = decode_inputs(8, 1024, 8, 2, 64, lens, dtype,
                                            seed=4)
        pos[3] = SENTINEL
        pos[3, 400:450] = torch.arange(50, dtype=torch.int32, device="cuda")
        q_pos[3] = 49
        bounds = split_bounds(1024, *split_plan(8, 8, 1024, 64, 2))
        seen = [bool((pos[3, a:b] <= q_pos[3]).any())
                for a, b in zip(bounds[:-1], bounds[1:])]
        if sum(seen) != 1 or len(seen) < 2:
            raise AssertionError(f"one-chunk case: chunks seen {seen}")
        check_decode(f"visible in one of {len(seen)} chunks {dtype}",
                     (q, k, v, q_pos, pos), zero_slots=(4,))
        # 64 slots x 8 KV heads fill the card: one chunk, no combine pass
        if split_plan(64, 8, 128, 64, 2)[0] != 1:
            raise AssertionError("S 64, KV 8 should run one chunk")
        check_decode(f"n_split 1 (S 64, C 128) {dtype}", decode_inputs(
            64, 128, 8, 2, 64, [(37 * i) % 129 for i in range(64)], dtype,
            seed=5), zero_slots=(0,))
    n_split, split_len = split_plan(8, 8, 1024, 64, 2)
    log(f"  decode_attention split at fedmm-base: {n_split} chunks of "
        f"{split_len} positions, {n_split * 8 * 8} blocks of (chunk, KV head,"
        f" slot), then the combine's 64")
    if n_split * 8 * 8 < 264:
        raise AssertionError("the split pass does not fill the card")

    timings = [decode_timing("serve", 8, 1024, lens),
               decode_timing("n_split 1 case", 64, 128,
                             [(37 * i) % 129 for i in range(64)])]
    return dict(max_abs_err=errs[torch.bfloat16], timings=timings)


def decode_timing(path, s_slots, c, lens, n_kv=8, rep=2, dh=64,
                  window=0, chunk=0) -> dict:
    """Kernel, plain and SDPA times (bf16), the bound of this pool's
    visible entries and that of the whole pool (``pool_bound_ms``); the
    pool is a ring of width c under a window or a chunk."""
    q, k, v, q_pos, pos = decode_inputs(s_slots, c, n_kv, rep, dh, lens,
                                        torch.bfloat16,
                                        window=window or (c if chunk else 0))
    sets = copies((q, k, v, q_pos, pos))

    def kernel(*x):
        return decode_attention(*x, window=window, chunk=chunk)

    def plain(*x):
        return ref.decode_attention_ref(*x, window=window, chunk=chunk)

    ms = time_ms(kernel, sets)
    issue_ms = host_ms(kernel, sets)
    plain_ms = time_ms(plain, sets)
    s, h, dh = q.shape
    ok = (pos <= q_pos[:, None])                       # visible entries
    if window:
        ok &= q_pos[:, None] - pos < window
    if chunk:
        ok &= pos >= q_pos[:, None] - q_pos[:, None] % chunk
    lib_sets = [(x[0].reshape(s, h, 1, dh),
                 x[1].permute(0, 2, 1, 3).contiguous(),
                 x[2].permute(0, 2, 1, 3).contiguous(), ok[:, None, None, :])
                for x in sets[:max(1, len(sets) // 2)]]
    library_ms = time_ms(sdpa_decode, lib_sets)
    live = [i for i, n in enumerate(lens) if n]
    lib_out = sdpa_decode(*lib_sets[0])[:, :, 0]
    lib_err = (lib_out[live].float() - plain(
        q, k, v, q_pos, pos)[live].float()).abs().max().item()
    if not lib_err <= TOL[torch.bfloat16]:
        raise AssertionError(f"SDPA yardstick computes another function "
                             f"({lib_err})")
    # this run's data needs the K and V of its visible entries only, plus
    # q, the positions and the output
    n_vis = int(ok.sum())
    entry = k.element_size() * k.shape[2] * dh     # one position, all KV heads
    moved = 2 * nbytes(q) + nbytes(q_pos, pos) + 2 * n_vis * entry
    ops = 4 * n_vis * h * dh                           # q.k and p.v per head
    b_ms, b_by = bound_ms(moved, ops, torch.bfloat16)
    shape = (f"S {s_slots}, C {c}, KV {n_kv}, rep {rep}, dh {dh}"
             + (f", window {window}" if window else "")
             + (f", chunk {chunk}" if chunk else ""))
    pool = 2 * nbytes(q) + nbytes(q_pos, pos, k, v)    # every entry once
    pool_ms = bound_ms(pool, 4 * pos.numel() * h * dh, torch.bfloat16)[0]
    log(f"  decode_attention timing ({path}, bf16, {shape}, "
        f"{split_plan(s_slots, n_kv, c, dh, rep)[0]} chunks): kernel "
        f"{ms:.4f} ms on the device ({issue_ms:.4f} ms to issue on the "
        f"host), plain {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}; {moved} bytes, {ops} flops; the "
        f"visible entries); the whole pool's bound {pool_ms:.4f} ms "
        f"({pool} bytes)")
    return dict(path=path, shape=shape, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                pool_bound_ms=pool_ms)


#: the sliding-window pools of this slice: name -> (S, C, KV, rep, dh,
#: lens), the ring as wide as the window; every slot past the ring has
#: wrapped, slot 5 is empty
WINDOW_POOLS = {
    "hybrid (RecurrentGemma ring)": (8, 2048, 1, 16, 256,
                                     [2200, 3000, 2048, 2500, 1, 0, 2049,
                                      2900]),
    "windowed fedmm-base ring": (4, 8192, 8, 2, 64, [8300, 8600, 8450, 8192]),
}


def window_decode_phase() -> list:
    """Decode over the sliding-window rings this slice serves (dh 256 at
    rep 16 over one KV head, and fedmm-base's 8,192 ring), held against
    the plain version in bf16 and f32 and timed in bf16 beside SDPA with
    a boolean mask."""
    log("kernel phase: decode_attention over sliding-window rings")
    for what, (s, c, n_kv, rep, dh, lens) in WINDOW_POOLS.items():
        for dtype in (torch.bfloat16, torch.float32):
            a = decode_inputs(s, c, n_kv, rep, dh, lens, dtype, window=c,
                              seed=c)
            check_decode(f"{what} {dtype}", a, window=c,
                         zero_slots=[i for i, n in enumerate(lens) if not n])
        n_split, split_len = split_plan(s, n_kv, c, dh, rep)
        log(f"  {what}: split into {n_split} chunks of {split_len} "
            f"positions, {n_split * s * n_kv} blocks of (chunk, KV head, "
            f"slot)")
    # a window narrower than the ring (the ring is cache_len wide when
    # cache_len < window is refused; a narrower window masks by position)
    check_decode("dh 256, window 700 over a ring of 1024 bf16",
                 decode_inputs(4, 1024, 1, 16, 256, [900, 2000, 1024, 3],
                               torch.bfloat16, window=1024, seed=5),
                 window=700)
    return [decode_timing(what, s, c, lens, n_kv, rep, dh, window=c)
            for what, (s, c, n_kv, rep, dh, lens) in WINDOW_POOLS.items()]


#: the chunked pools of this slice: name -> (S, C, KV, rep, dh, lens), a
#: ring as wide as the chunk.  Llama-4-Scout's slots sit at positions
#: 8,100, 8,191 (the chunk's last), 8,192 (the next chunk's first: it
#: sees only itself, the ring holding the earlier chunk's entries), 8,500,
#: 0, empty, 4,999 and 16,400
CHUNK_POOLS = {"Llama-4-Scout ring": (8, 8192, 8, 5, 128,
                                      [8101, 8192, 8193, 8501, 1, 0, 5000,
                                       16401])}
SCOUT_CHUNK = 8192


def chunk_decode_phase() -> list:
    """Decode under llama4's chunked rule over Scout's ring (chunk 8,192,
    and a chunk of 1,000 over the same ring), held against the plain
    version in bf16 and f32; the slot at the chunk boundary must get its
    own V.  Then Scout's pool timed in bf16 beside SDPA with a boolean
    chunk mask."""
    log("kernel phase: decode_attention with a chunk")
    for what, (s, c, n_kv, rep, dh, lens) in CHUNK_POOLS.items():
        for dtype in (torch.bfloat16, torch.float32):
            a = decode_inputs(s, c, n_kv, rep, dh, lens, dtype, window=c,
                              seed=7)
            zero = [i for i, n in enumerate(lens) if not n]
            check_decode(f"{what}, chunk {c} {dtype}", a, chunk=c,
                         zero_slots=zero)
            check_decode(f"{what}, chunk 1000 {dtype}", a, chunk=1000,
                         zero_slots=zero)
            # position 8,192 sees one entry: its own (ring index 0)
            on = lens.index(c + 1)
            got = decode_attention(*a, chunk=c)[on].float()
            own = a[2][on, 0].float().repeat_interleave(rep, dim=0)
            diff = (got - own).abs().max().item()
            if diff > TOL[dtype] * own.abs().max().item():
                raise AssertionError(f"decode_attention {what}: the slot at "
                                     f"the chunk boundary is {diff} off its "
                                     f"own V")
        n_split, split_len = split_plan(s, n_kv, c, dh, rep)
        log(f"  {what}: split into {n_split} chunks of {split_len} "
            f"positions; the boundary slot's other chunks wholly masked, "
            f"its output its own V")
    return [decode_timing(what, s, c, lens, n_kv, rep, dh, chunk=c)
            for what, (s, c, n_kv, rep, dh, lens) in CHUNK_POOLS.items()]


# ----------------------------------------------------------------------
# kernel phase: flash attention
def flash_inputs(t, h, n_kv, dh, dtype, seed=0, b=1, s=None, dv=None):
    g = torch.Generator(device="cuda").manual_seed(seed)
    s = t if s is None else s
    return tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((b, t, h, dh), (b, s, n_kv, dh),
                               (b, s, n_kv, dv or dh)))


#: forward checks of the block shapes and masks of the bf16 kernel (and of
#: the f32 one): name -> (B, T, S, H, KV, dh)
FLASH_CASES = {"T 16 rep 3 (heads packed)": (2, 16, 16, 12, 4, 64),
               "T 1": (2, 1, 1, 16, 8, 64),
               "T 1, S 77": (1, 1, 77, 16, 8, 64),
               "ragged T 65": (1, 65, 65, 16, 8, 64),
               "T 100, S 300 (bottom-right)": (1, 100, 300, 16, 8, 64),
               "T 100, S 300, dh 128": (1, 100, 300, 16, 4, 128),
               "B 4, T 200": (4, 200, 200, 16, 8, 64)}


def flash_phase() -> dict:
    log("kernel phase: flash_attention")
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for t in (512, 300):
            a = flash_inputs(t, 16, 8, 64, dtype, seed=t)
            err = attn_err("flash", f"T {t} {dtype}",
                           flash_attention(*a), ref.flash_attention_ref(*a))
            if t == 512:
                errs[dtype] = err
        for what, (b, t, sk, h, n_kv, dh) in FLASH_CASES.items():
            a = flash_inputs(t, h, n_kv, dh, dtype, seed=t + sk, b=b, s=sk)
            attn_err("flash", f"{what} {dtype}", flash_attention(*a),
                     ref.flash_attention_ref(*a))
        a = flash_inputs(200, 16, 4, 128, dtype, seed=9)   # dh 128, rep 4
        attn_err("flash", f"dh 128 rep 4 {dtype}", flash_attention(*a),
                 ref.flash_attention_ref(*a))
        # the federated round's shape, with the gradient (plain backward)
        g = torch.Generator(device="cuda").manual_seed(11)
        qkv = tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                    for shape in ((32, 16, 12, 64), (32, 16, 4, 64),
                                  (32, 16, 4, 64)))
        check_vjp(f"flash_attention round shape (B 32, T 16, H 12, KV 4) "
                  f"{dtype}", flash_attention, ref.flash_attention_ref, qkv,
                  (0, 1, 2), TOL[dtype])
        # the LM driver's, T 128: the task pass (batch 8 a node) and the
        # anchor pass (16 anchors a node) over 4 nodes (B 32, B 64) or
        # over a uniform C 2 cohort (B 16, B 32)
        for b in (16, 32, 64):
            qkv = tuple(torch.randn(shape, generator=g,
                                    device="cuda").to(dtype)
                        for shape in ((b, 128, 12, 64), (b, 128, 4, 64),
                                      (b, 128, 4, 64)))
            check_vjp(f"flash_attention LM driver shape (B {b}, T 128, "
                      f"H 12, KV 4) {dtype}", flash_attention,
                      ref.flash_attention_ref, qkv, (0, 1, 2), TOL[dtype])

    # timing, bf16: serve's prefill of one 512-token prompt, and the round's
    # (B 32, T 16), where three quarters of each 64 x 64 tile is padding
    timings = [flash_timing(path, b, t, h, n_kv, 64)
               for path, (b, t, h, n_kv) in (("serve", (1, 512, 16, 8)),
                                             ("federation", (32, 16, 12, 4)),
                                             ("LM driver", (32, 128, 12, 4)))]
    return dict(max_abs_err=errs[torch.bfloat16], timings=timings)


def window_mask(t: int, s: int, window: int, chunk: int = 0) -> torch.Tensor:
    """(T, S) bool: the keys each query row sees under the sliding (or
    chunked) mask, aligned bottom-right as the kernel aligns it (causal
    when window and chunk are 0)."""
    qi = torch.arange(t, device="cuda")[:, None] + (s - t)
    ki = torch.arange(s, device="cuda")[None, :]
    ok = ki <= qi
    if chunk:
        ok &= ki >= qi - qi % chunk
    return ok & (qi - ki < window) if window else ok


def flash_timing(path, b, t, h, n_kv, dh, window=0, chunk=0, dv=None,
                 plain_fn=None, plain_iters=None) -> dict:
    """Kernel, plain and SDPA times (bf16) and the bound of the visible
    (query, key) pairs.  SDPA runs ``is_causal`` for the causal mask and a
    boolean (T, S) mask for a window or a chunk; v's head dim is ``dv``
    (default dh).  ``plain_fn`` replaces the plain version where its f32
    scores would not fit at once (``grouped_ref``)."""
    dv = dv or dh
    g = torch.Generator(device="cuda").manual_seed(t)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(
        torch.bfloat16) for shape in ((b, t, h, dh), (b, t, n_kv, dh),
                                      (b, t, n_kv, dv)))
    sets = copies((q, k, v))

    def kernel(*x):
        return flash_attention(*x, window=window, chunk=chunk)

    def plain(*x):
        return (plain_fn or ref.flash_attention_ref)(*x, window=window,
                                                     chunk=chunk)

    mask = window_mask(t, t, window, chunk)
    masked = bool(window or chunk)
    sdpa = dict(attn_mask=mask) if masked else dict(is_causal=True)

    def library(*x):
        return F.scaled_dot_product_attention(*x, enable_gqa=True, **sdpa)

    ms = time_ms(kernel, sets)
    issue_ms = host_ms(kernel, sets)
    plain_ms = time_ms(plain, sets,
                       iters=plain_iters or (10 if masked else 30))
    lib_sets = [tuple(a.transpose(1, 2).contiguous() for a in x)
                for x in sets]
    library_ms = time_ms(library, lib_sets)
    lib_err = (library(*lib_sets[0]).transpose(1, 2).float()
               - plain(*sets[0]).float()).abs().max().item()
    if not lib_err <= TOL[torch.bfloat16]:
        raise AssertionError(f"SDPA yardstick computes another function "
                             f"({lib_err})")
    ops = 2 * b * h * (dh + dv) * int(mask.sum())      # visible pairs only
    b_ms, b_by = bound_ms(nbytes(q, k, v) + nbytes(q) * dv // dh, ops,
                          torch.bfloat16)
    shape = (f"B {b}, T {t}, H {h}, KV {n_kv}, dh {dh}"
             + (f", dv {dv}" if dv != dh else "")
             + (f", window {window}" if window else "")
             + (f", chunk {chunk}" if chunk else ""))
    log(f"  flash_attention timing ({path}, bf16, {shape}): kernel "
        f"{ms:.4f} ms on the device ({issue_ms:.4f} ms to issue), plain "
        f"{plain_ms:.4f} ms, SDPA{' (bool mask)' if masked else ''} "
        f"{library_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}; {ops} flops)")
    return dict(path=path, shape=shape, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)


#: the sliding-window prefills of this slice: name -> (B, T, H, KV, dh,
#: window); T 1,024 lies under the hybrid's window
WINDOW_FLASH = {
    "hybrid (RecurrentGemma local attention)": (1, 2560, 16, 1, 256, 2048),
    "hybrid, T under the window": (1, 1024, 16, 1, 256, 2048),
    "windowed fedmm-base": (1, 8448, 16, 8, 64, 8192),
}
#: smaller masks and shapes: name -> (B, T, S, H, KV, dh, window)
WINDOW_FLASH_CASES = {
    "dh 256 causal, ragged T 300": (1, 300, 300, 16, 1, 256, 0),
    "dh 256, B 2, T 200, window 50": (2, 200, 200, 8, 2, 256, 50),
    "dh 256, T 100, S 300, window 120 (bottom-right)":
        (1, 100, 300, 16, 1, 256, 120),
    "dh 64, window 1 (the diagonal)": (1, 130, 130, 16, 8, 64, 1),
    "dh 64, window 100, T 1000": (1, 1000, 1000, 16, 8, 64, 100),
    "dh 128, window 33, rep 4": (2, 150, 150, 16, 4, 128, 33),
}


def window_flash_phase() -> list:
    """Flash under the sliding mask and at dh 256: the slice's prefill
    shapes and the smaller cases, held against the plain version in bf16
    and f32; one windowed gradient check; then the three prefill shapes
    timed in bf16 beside SDPA with a boolean mask."""
    log("kernel phase: flash_attention with a sliding window and at dh 256")
    for dtype in (torch.bfloat16, torch.float32):
        for what, (b, t, h, n_kv, dh, w) in WINDOW_FLASH.items():
            a = flash_inputs(t, h, n_kv, dh, dtype, seed=t, b=b)
            attn_err("flash", f"{what} (B {b}, T {t}, H {h}, KV "
                     f"{n_kv}, dh {dh}, window {w}) {dtype}",
                     flash_attention(*a, window=w),
                     ref.flash_attention_ref(*a, window=w))
        for what, (b, t, sk, h, n_kv, dh, w) in WINDOW_FLASH_CASES.items():
            a = flash_inputs(t, h, n_kv, dh, dtype, seed=t + sk, b=b, s=sk)
            attn_err("flash", f"{what} {dtype}",
                     flash_attention(*a, window=w),
                     ref.flash_attention_ref(*a, window=w))
        check_vjp(f"flash_attention windowed gradient (B 1, T 384, H 16, "
                  f"KV 1, dh 256, window 200) {dtype}",
                  lambda *x: flash_attention(*x, window=200),
                  lambda *x: ref.flash_attention_ref(*x, window=200),
                  flash_inputs(384, 16, 1, 256, dtype, seed=384), (0, 1, 2),
                  TOL[dtype])
    return [flash_timing(what, b, t, h, n_kv, dh, w)
            for what, (b, t, h, n_kv, dh, w) in WINDOW_FLASH.items()]


#: the chunked prefill of this slice: name -> (B, T, H, KV, dh, chunk)
CHUNK_FLASH = {"Llama-4-Scout prefill": (1, 8448, 40, 8, 128, SCOUT_CHUNK)}
#: smaller chunked cases: name -> (B, T, S, H, KV, dh, chunk); chunks that
#: are no multiple of 16 put a chunk boundary inside a warp's 16 rows
CHUNK_FLASH_CASES = {
    "chunk 48, T 300": (1, 300, 300, 16, 8, 64, 48),
    "T 100, S 300, chunk 128 (bottom-right)": (1, 100, 300, 16, 8, 64, 128),
    "B 4, dh 64, T 200, chunk 64": (4, 200, 200, 16, 8, 64, 64),
    "dh 128, rep 5, T 700, chunk 37": (1, 700, 700, 40, 8, 128, 37),
    "dh 128, T 300, chunk 1 (the diagonal)": (1, 300, 300, 10, 2, 128, 1),
    "dh 256, T 200, chunk 72": (1, 200, 200, 16, 1, 256, 72),
}


def grouped_ref(q, k, v, **mask) -> torch.Tensor:
    """The plain version one KV head's group at a time (its f32 scores at
    Scout's prefill would be 11 GB at once)."""
    rep = q.shape[2] // k.shape[2]
    return torch.cat([ref.flash_attention_ref(
        q[:, :, g * rep:(g + 1) * rep], k[:, :, g:g + 1], v[:, :, g:g + 1],
        **mask) for g in range(k.shape[2])], dim=2)


def chunk_flash_phase() -> list:
    """Flash under llama4's chunked mask: Scout's prefill (compared by KV
    head groups) and the smaller cases, against the plain version in bf16
    and f32; a chunked gradient check; then Scout's prefill timed in bf16
    beside SDPA with a boolean chunk mask."""
    log("kernel phase: flash_attention with a chunk")
    for dtype in (torch.bfloat16, torch.float32):
        for what, (b, t, h, n_kv, dh, c) in CHUNK_FLASH.items():
            a = flash_inputs(t, h, n_kv, dh, dtype, seed=t + 1, b=b)
            attn_err("flash", f"{what} (B {b}, T {t}, H {h}, KV {n_kv}, dh "
                     f"{dh}, chunk {c}) {dtype}",
                     flash_attention(*a, chunk=c), grouped_ref(*a, chunk=c))
        for what, (b, t, sk, h, n_kv, dh, c) in CHUNK_FLASH_CASES.items():
            a = flash_inputs(t, h, n_kv, dh, dtype, seed=t + sk + c, b=b,
                             s=sk)
            attn_err("flash", f"{what} {dtype}", flash_attention(*a, chunk=c),
                     ref.flash_attention_ref(*a, chunk=c))
        check_vjp(f"flash_attention chunked gradient (B 2, T 384, H 16, KV "
                  f"8, dh 64, chunk 100) {dtype}",
                  lambda *x: flash_attention(*x, chunk=100),
                  lambda *x: ref.flash_attention_ref(*x, chunk=100),
                  flash_inputs(384, 16, 8, 64, dtype, seed=385, b=2),
                  (0, 1, 2), TOL[dtype])
    return [flash_timing(what, b, t, h, n_kv, dh, chunk=c)
            for what, (b, t, h, n_kv, dh, c) in CHUNK_FLASH.items()]


#: DeepSeek-V2's MLA prefill: name -> (B, T, H, KV, dqk, dv); K's rope part
#: is shared by the heads, so KV = H after the broadcast
MLA_FLASH = {"DeepSeek-V2 prefill": (1, 4096, 128, 128, 192, 128)}
#: smaller cases at (192, 128): name -> (B, T, S, H, KV, dqk, dv)
MLA_FLASH_CASES = {
    "ragged T 300": (1, 300, 300, 16, 16, 192, 128),
    "T 100, S 300 (bottom-right)": (1, 100, 300, 16, 16, 192, 128),
    "B 2, T 200, rep 4": (2, 200, 200, 16, 4, 192, 128),
    "T 1": (2, 1, 1, 16, 16, 192, 128),
}


def mla_flash_phase() -> list:
    """Flash at MLA's head dims (q.k 192, v 128): DeepSeek-V2's prefill
    (its plain version run by head groups) and the smaller cases, against
    the plain version in bf16 and f32; a gradient check at a small T; then
    the prefill timed in bf16 beside SDPA (``is_causal``, Ev 128 != E
    192)."""
    log("kernel phase: flash_attention at MLA's (dqk 192, dv 128)")
    for dtype in (torch.bfloat16, torch.float32):
        for what, (b, t, h, n_kv, dqk, dv) in MLA_FLASH.items():
            a = flash_inputs(t, h, n_kv, dqk, dtype, seed=t + 2, b=b, dv=dv)
            attn_err("flash", f"{what} (B {b}, T {t}, H {h}, KV {n_kv}, dqk "
                     f"{dqk}, dv {dv}) {dtype}", flash_attention(*a),
                     grouped_ref(*a))
        for what, (b, t, sk, h, n_kv, dqk, dv) in MLA_FLASH_CASES.items():
            a = flash_inputs(t, h, n_kv, dqk, dtype, seed=t + sk + 3, b=b,
                             s=sk, dv=dv)
            attn_err("flash", f"(192, 128) {what} {dtype}",
                     flash_attention(*a), ref.flash_attention_ref(*a))
        check_vjp(f"flash_attention (192, 128) gradient (B 1, T 256, H 8, "
                  f"KV 8) {dtype}", flash_attention, ref.flash_attention_ref,
                  flash_inputs(256, 8, 8, 192, dtype, seed=257, dv=128),
                  (0, 1, 2), TOL[dtype])
    try:
        flash_attention(*flash_inputs(16, 4, 4, 192, torch.bfloat16, dv=192))
    except ValueError as err:
        log(f"  (192, 192), a pair it is not built for, raises: {err}")
    else:
        raise AssertionError("flash_attention took (192, 192)")
    return [flash_timing(what, b, t, h, n_kv, dqk, dv=dv,
                         plain_fn=grouped_ref, plain_iters=3)
            for what, (b, t, h, n_kv, dqk, dv) in MLA_FLASH.items()]


# ----------------------------------------------------------------------
# kernel phase: absorbed MLA decode
MLA_SCALE = 192 ** -0.5            # DeepSeek-V2: (nope + rope)^-0.5
#: DeepSeek-V2's serve pool: S 8, C 4,352, H 128, the latent 512 + 64;
#: slots at lens 0 (one entry), 1, 511, 1,000, 2,049, 4,095, C - 1 and C
#: (every entry visible)
MLA_POOL = (8, 4352, 128, [0, 1, 511, 1000, 2049, 4095, 4351, 4352])
#: smaller and skewed pools: name -> (S, C, H, lens).  The wgmma design
#: takes the H 64 / 128 cases (the unbalanced pool leaves its long slot in
#: 23 pieces; S 64 at C 128 takes one share a slot and no combine); PR
#: 25's mma design the H 16 ones, whose split leaves most chunks of the
#: short slots empty (they write no acc)
MLA_POOL_CASES = {
    "S 1, C 1": (1, 1, 128, [0]),
    "C 1,000 (not whole tiles)": (3, 1000, 128, [999, 40, 1000]),
    "H 64": (4, 2000, 64, [1999, 0, 1000, 2000]),
    "all slots at lens 0": (8, 4352, 128, [0] * 8),
    "all slots at lens C": (8, 4352, 128, [4352] * 8),
    "one slot at C, seven at 0": (8, 4352, 128, [4352] + [0] * 7),
    "S 64, C 128": (64, 128, 128, [(37 * i) % 129 for i in range(64)]),
    "H 16": (4, 700, 16, [699, 0, 333, 700]),
    "H 16, empty chunks": (4, 4352, 16, [0, 5, 600, 4351])}


def mla_inputs(s, c, h, lens, dtype, seed=0):
    """q_c (S, H, 512), q_rope (S, H, 64), c_kv (S, C, 512), k_rope (S, C,
    64) from a seed, and lens (S,) int32."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    shapes = ((s, h, 512), (s, h, 64), (s, c, 512), (s, c, 64))
    return tuple(torch.randn(x, generator=g, device="cuda").to(dtype)
                 for x in shapes) + (
        torch.tensor(lens, dtype=torch.int32, device="cuda"),)


def mla_plan_note(s, c, h, lens, dtype=torch.bfloat16) -> str:
    """The plan ``mla_plan`` gives a pool: the design, and for the wgmma
    design its budget G, least share and the shares and pieces this
    pool's lens leave."""
    design, n_split, split_len = mla_plan(dtype, s, h, c)
    if design != "wgmma":
        return f"{design}, {n_split} chunks of {split_len}"
    segs = share_plan(lens, c, n_split, split_len)
    pieces = sum(p >= 0 for *_, p in segs)
    return (f"wgmma, G {n_split}, least {split_len} tiles: {len(segs)} "
            f"shares, {pieces} pieces")


def check_mla(name, args) -> float:
    s, h = args[0].shape[:2]
    c, lens = args[2].shape[1], args[4].tolist()
    note = mla_plan_note(s, c, h, lens, args[0].dtype)
    return attn_err("mla_decode", f"{name} [{note}]",
                    mla_decode(*args, MLA_SCALE),
                    ref.mla_decode_ref(*args, MLA_SCALE))


def mla_dependent_read_check() -> None:
    """The output read by the very next kernel in the stream (a copy, no
    synchronisation between): the combine pass, a programmatic dependent
    of the split pass, must not end before the split pass has written
    ``out``, even where no slot leaves a piece.  Before each call the
    allocator's block for ``out`` is filled with NaN."""
    for what, (s, c, h, lens) in (
            ("all slots at lens 0 (no piece)", MLA_POOL_CASES[
                "all slots at lens 0"]), ("DeepSeek-V2 pool", MLA_POOL)):
        args = mla_inputs(s, c, h, lens, torch.bfloat16, seed=5)
        want = mla_decode(*args, MLA_SCALE)
        torch.cuda.synchronize()
        bad = 0
        for _ in range(20):
            poison = torch.full_like(want, float("nan"))
            del poison
            seen = mla_decode(*args, MLA_SCALE).clone()
            torch.cuda.synchronize()
            bad += not torch.equal(seen, want)
        log(f"  mla_decode read by the next kernel ({what}, "
            f"{mla_plan_note(s, c, h, lens)}): {20 - bad} of 20 copies bit "
            f"for bit the synchronised output")
        if bad:
            raise AssertionError(f"mla_decode: {bad} of 20 copies taken "
                                 f"right after the call differ ({what})")


def mla_graph_check() -> None:
    """Two eager calls over DeepSeek-V2's pool bit for bit each other; one
    captured in a CUDA graph and replayed twice, each replay bit for bit
    the eager call."""
    args = mla_inputs(*MLA_POOL, torch.bfloat16, seed=9)
    eager = mla_decode(*args, MLA_SCALE)
    again = mla_decode(*args, MLA_SCALE)
    cap = capture_graph(lambda: mla_decode(*args, MLA_SCALE), [])
    same = []
    for _ in range(2):
        cap.out.fill_(float("nan"))
        cap.graph.replay()
        torch.cuda.synchronize()
        same.append(torch.equal(cap.out, eager))
    log(f"  mla_decode eager calls bit for bit: {torch.equal(eager, again)}; "
        f"graph replay (DeepSeek-V2 pool, bf16): replays bit for bit the "
        f"eager call {same}; launches a replay "
        f"{dict(zip((fn.__name__ for fn in COUNTED), cap.launches))}")
    if not all(same) or not torch.equal(eager, again):
        raise AssertionError(f"mla_decode: replays {same}, eager calls "
                             f"{torch.equal(eager, again)}")
    del cap


def mla_report() -> None:
    """ptxas's registers, barriers, shared memory and spills of the MLA
    kernels and each design's dynamic shared memory a CTA."""
    for line in _build.ptxas_report.get("mla_decode", "").splitlines():
        if re.search(r"Compiling entry function|registers|spill", line):
            log(f"  ptxas mla_decode: {line.strip()}")
    lib = _build.load("mla_decode")
    log(f"  mla_decode dynamic shared memory a CTA: "
        f"{ {d: lib.mla_decode_smem(DESIGNS[d]) for d in DESIGNS} } bytes")


def sdpa_expanded(q4, k4, v4, mask, backend):
    """One SDPA call over K and V expanded to H heads as views (no copy)
    under one backend."""
    from torch.nn.attention import sdpa_kernel
    h = q4.shape[1]
    with sdpa_kernel([backend]):
        return F.scaled_dot_product_attention(
            q4, k4.expand(-1, h, -1, -1), v4.expand(-1, h, -1, -1),
            attn_mask=mask, scale=MLA_SCALE)


def mla_decode_timing(path, s, c, h, lens) -> dict:
    """Times (bf16) of the design ``mla_plan`` picks (the wrapper), of PR
    25's mma design at the same pool (``launch_design`` at
    ``split_plan``'s chunks, uncounted), of the plain version and of two
    SDPA yardsticks, and the bound of the visible latent rows.  SDPA takes
    q (S, H, 1, 576) against k (S, 1, C, 576) and v (S, 1, C, 512) with a
    boolean mask: with ``enable_gqa`` (the first yardstick, a slow path),
    and over k / v expanded to H heads as views under the first of cuDNN
    and efficient attention that takes them (``library_ms``)."""
    from torch.nn.attention import SDPBackend
    args = mla_inputs(s, c, h, lens, torch.bfloat16, seed=c)
    sets = copies(args)

    def kernel(*x):
        return mla_decode(*x, MLA_SCALE)

    def mma(*x):
        return launch_design(*x, MLA_SCALE, "mma", *mla_split_plan(s, h, c))

    def plain(*x):
        return ref.mla_decode_ref(*x, MLA_SCALE)

    def library(q4, k4, v4, mask):
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                              scale=MLA_SCALE,
                                              enable_gqa=True)

    want = plain(*sets[0])
    attn_err("mla_decode", f"the mma design at {path}", mma(*sets[0]),
             want)
    ms = time_ms(kernel, sets)                       # in turns: A B B A
    mma_ms = time_ms(mma, sets)
    mma_again = time_ms(mma, sets)
    ms_again = time_ms(kernel, sets)
    issue_ms = host_ms(kernel, sets)
    plain_ms = time_ms(plain, sets)
    n = torch.arange(c, device="cuda")
    lib_sets = [(torch.cat(x[:2], -1)[:, :, None],
                 torch.cat(x[2:4], -1)[:, None], x[2][:, None],
                 (n[None, :] <= x[4][:, None])[:, None, None])
                for x in sets[:max(1, len(sets) // 2)]]
    gqa_ms = time_ms(library, lib_sets)
    errs = {"enable_gqa": (library(*lib_sets[0])[:, :, 0].float()
                           - want.float()).abs().max().item()}
    backend, library_ms = None, None
    for b in (SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION):
        try:
            got = sdpa_expanded(*lib_sets[0], b)
        except RuntimeError as err:
            log(f"  SDPA over expanded heads: {b.name} refuses "
                f"({str(err).splitlines()[0][:120]})")
            continue
        backend = b.name
        errs[backend] = (got[:, :, 0].float() - want.float()).abs().max(
        ).item()
        library_ms = time_ms(lambda *x: sdpa_expanded(*x, b), lib_sets)
        break
    for what, err in errs.items():
        if not err <= TOL[torch.bfloat16]:
            raise AssertionError(f"SDPA yardstick ({what}) computes another "
                                 f"function ({err})")
    n_vis = sum(min(x + 1, c) for x in lens)
    row = 2 * (512 + 64)                               # one latent row, bf16
    moved = 2 * nbytes(args[0]) + nbytes(args[1], args[4]) + n_vis * row
    ops = 2 * n_vis * h * (576 + 512)
    b_ms, b_by = bound_ms(moved, ops, torch.bfloat16)
    shape = f"S {s}, C {c}, H {h}, kvr 512, rd 64, lens {lens}"
    mma_plan = "{} chunks of {}".format(*mla_split_plan(s, h, c))
    log(f"  mla_decode timing ({path}, bf16, {shape}; "
        f"{mla_plan_note(s, c, h, lens)}): kernel {ms:.4f} / {ms_again:.4f} "
        f"ms on the device ({issue_ms:.4f} ms to issue), the mma design "
        f"({mma_plan}) {mma_ms:.4f} / {mma_again:.4f} "
        f"ms, plain {plain_ms:.4f} ms, SDPA over expanded heads "
        f"({backend}) {library_ms} ms, SDPA enable_gqa {gqa_ms:.4f} ms "
        f"(max_abs_err {errs}), bound {b_ms:.4f} ms ({b_by}; {moved} bytes, "
        f"{ops} flops; the {n_vis} visible latent rows); kernel / mma "
        f"{(ms + ms_again) / (mma_ms + mma_again):.3f}, bound / kernel "
        f"{b_ms / ms:.3f}")
    return dict(path=path, shape=shape, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
                library_backend=backend, library_gqa_ms=gqa_ms,
                mma_ms=mma_ms, plan=mla_plan_note(s, c, h, lens))


def mla_decode_phase() -> dict:
    """The absorbed-MLA decode kernel over DeepSeek-V2's pool and the
    smaller and skewed pools, against its plain version in bf16 and f32;
    the slot at lens == C must see every entry; eager calls and a graph
    replay bit for bit; H not a multiple of 16 and another latent must
    raise; then the pool timed in bf16 beside the mma design."""
    t0 = time.perf_counter()
    log("kernel phase: mla_decode (absorbed MLA decode, DeepSeek-V2)")
    mla_report()
    errs = {}
    s, c, h, lens = MLA_POOL
    for dtype in (torch.bfloat16, torch.float32):
        a = mla_inputs(s, c, h, lens, dtype, seed=1)
        errs[dtype] = check_mla(f"DeepSeek-V2 pool (S {s}, C {c}, H {h}, "
                                f"lens {lens}) {dtype}", a)
        for what, (s2, c2, h2, lens2) in MLA_POOL_CASES.items():
            check_mla(f"{what} {dtype}", mla_inputs(s2, c2, h2, lens2, dtype,
                                                    seed=c2))
        # lens == C sees all C entries: the same as lens C - 1 + a slot
        # past it; here, against the plain version restricted to C - 1
        full = lens.index(c)
        sub = tuple(t[full:full + 1] for t in a[:4]) + (
            torch.tensor([c - 1], dtype=torch.int32, device="cuda"),)
        got = mla_decode(*a, MLA_SCALE)[full:full + 1]
        attn_err("mla_decode", f"slot at lens == C against lens C - 1 "
                 f"{dtype}", got, ref.mla_decode_ref(*sub, MLA_SCALE))
    log(f"  mla_decode plan at DeepSeek-V2's pool: {mla_plan_note(*MLA_POOL)}"
        f" ({mla_plan(torch.bfloat16, s, h, c)[1] * h // 64} CTAs of 64 "
        f"heads; where G > S the combine's {s * h} (head, slot) items)")
    mla_graph_check()
    mla_dependent_read_check()
    try:
        mla_decode(*mla_inputs(4, 100, 24, [3] * 4, torch.bfloat16),
                   MLA_SCALE)
    except ValueError as err:
        log(f"  H 24 raises: {err}")
    else:
        raise AssertionError("mla_decode took H 24")
    q_c, q_rope, c_kv, k_rope, ln = mla_inputs(2, 64, 16, [3, 4],
                                               torch.bfloat16)
    try:
        mla_decode(q_c[..., :256].contiguous(), q_rope,
                   c_kv[..., :256].contiguous(), k_rope, ln, MLA_SCALE)
    except ValueError as err:
        log(f"  a 256-wide latent raises: {err}")
    else:
        raise AssertionError("mla_decode took a 256-wide latent")
    timings = [mla_decode_timing("DeepSeek-V2 serve pool", *MLA_POOL)]
    log(f"  mla_decode phase: {time.perf_counter() - t0:.1f} s")
    return dict(max_abs_err=errs[torch.bfloat16], timings=timings)


# ----------------------------------------------------------------------
# the training kernels: forward and backward against the plain versions
def check_vjp(name, fn, plain, args, live, tol, grad_tol=None):
    """``fn`` (the kernel's autograd Function) and ``plain`` (its plain
    version under autograd) on the same inputs and the same random
    cotangent: the output (held to ``tol``) and the gradient of every
    argument in ``live`` (held to ``grad_tol``, by default ``tol``).
    Errors are max |got - want| over max(1, max |want|): the outputs run up
    to a few units, where one bf16 step is 2^-7 of the value.  Returns
    the forward error."""
    def run(f):
        leaves = [a.detach().clone().requires_grad_(i in live)
                  for i, a in enumerate(args)]
        out = f(*leaves)
        return out, leaves
    got, gl = run(fn)
    want, wl = run(plain)
    g = torch.Generator(device="cuda").manual_seed(123)
    cot = torch.randn(want.shape, generator=g, device="cuda")
    (got.float() * cot).sum().backward()
    (want.float() * cot).sum().backward()
    torch.cuda.synchronize()
    errs = {}
    for what, a, b in [("out", got, want)] + [
            (f"d{i}", gl[i].grad, wl[i].grad) for i in live]:
        scale = max(1.0, b.float().abs().max().item())
        errs[what] = (a.float() - b.float()).abs().max().item() / scale
    grad_tol = tol if grad_tol is None else grad_tol
    limits = {k: tol if k == "out" else grad_tol for k in errs}
    log(f"  {name}: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
        + f" (of max(1, max |value|); tol {tol}"
        + ("" if grad_tol == tol else f", gradient {grad_tol}") + ")")
    bad = {k: (v, limits[k]) for k, v in errs.items() if not v <= limits[k]}
    if bad:
        raise AssertionError(f"{name}: (error, limit) {bad}")
    return errs["out"]


#: gram checks: name -> shape of x, (B, D) or (K, B, D)
GRAM_CASES = {"loss (32, 768)": (32, 768),
              "upload (4, 32, 768)": (4, 32, 768),
              "ragged (37, 100)": (37, 100),
              "B 1 (1, 768)": (1, 768),
              "d_model 5120 (128, 5120)": (128, 5120),
              "16 nodes (16, 32, 768)": (16, 32, 768),
              "LM driver anchors (4, 16, 768)": (4, 16, 768)}
#: gram limits: dtype -> (output, gradient).  The kernel and the plain
#: version take f32 sums of the same exact products (bf16 values too), so
#: the output is held to 1e-5 in both dtypes: a cosine off the diagonal is
#: ~D^-0.5 (0.014 at D 5120), and a looser limit would pass a wrong kernel.
#: The gradient is plain PyTorch either way, rounded to x's dtype: bf16
#: steps of dx set its limit.
GRAM_TOL = {torch.bfloat16: (1e-5, 1e-3), torch.float32: (1e-5, 1e-5)}


def gram_phase() -> dict:
    log("kernel phase: gram (forward: the kernel; backward: plain PyTorch)")
    errs = {}
    g = torch.Generator(device="cuda").manual_seed(7)
    for dtype in (torch.bfloat16, torch.float32):
        for what, shape in GRAM_CASES.items():
            x = torch.randn(shape, generator=g, device="cuda").to(dtype)
            if shape[-2] > 3:
                x[..., 3, :] = 0.0                   # the eps clamp
            kbd = shape if len(shape) == 3 else (1, *shape)
            err = check_vjp(f"gram {what} {dtype} (plan {gram_plan(*kbd)}, "
                            f"{gram_blocks(*kbd)} CTAs)", cosine_gram,
                            ref.cosine_gram_ref, (x,), (0,), *GRAM_TOL[dtype])
            errs.setdefault(dtype, err)
        # rows off 16 bytes: the element path
        x = torch.randn(32 * 768 + 1, generator=g, device="cuda").to(dtype)
        x = x[1:].view(32, 768)
        check_vjp(f"gram rows off 16 bytes (32, 768) {dtype}", cosine_gram,
                  ref.cosine_gram_ref, (x,), (0,), *GRAM_TOL[dtype])

    def composition(x):
        xn = F.normalize(x.float(), dim=-1, eps=1e-4)   # max(|x|, sqrt(eps))
        return xn @ xn.transpose(-1, -2)

    def library(x):            # one call; each row norm clamped at 1e-4
        return F.cosine_similarity(x.unsqueeze(-2), x.unsqueeze(-3), dim=-1,
                                   eps=1e-4)

    # the least a launch costs, timed the same way: a one-element add_
    floor_ms = time_ms(lambda t: t.add_(1.0),
                       copies((torch.zeros(1, device="cuda"),)))
    log(f"  launch floor: one-element add_ {floor_ms:.4f} ms on the device")
    out = []
    for what, shape in (("loss", (32, 768)), ("upload", (4, 32, 768)),
                        ("LM driver anchors", (4, 16, 768))):
        x = torch.randn(shape, generator=g, device="cuda")
        x[..., 5, :] *= 1e-6                         # a norm under the clamp
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            want = ref.cosine_gram_ref(xd)
            tol = 1e-5 if dtype == torch.float32 else TOL[dtype]
            for yard, fn in (("F.normalize + @", composition),
                             ("F.cosine_similarity", library)):
                lib_err = (fn(xd).float() - want).abs().max().item()
                if not lib_err <= tol:
                    raise AssertionError(f"gram yardstick {yard} computes "
                                         f"another function ({lib_err} > "
                                         f"{tol}, {dtype})")
        x = x.to(torch.bfloat16)
        sets = copies((x,))
        ms = time_ms(lambda t: cosine_gram(t), sets)
        issue_ms = host_ms(lambda t: cosine_gram(t), sets)
        plain_ms = time_ms(lambda t: ref.cosine_gram_ref(t), sets)
        composition_ms = time_ms(composition, sets)
        library_ms = time_ms(library, sets)
        b, d = shape[-2:]
        k = x.numel() // (b * d)
        ops = k * (2 * b * b * d + 3 * b * d)       # products and row norms
        b_ms, b_by = bound_ms(nbytes(x) + 4 * k * b * b, ops, torch.bfloat16)
        log(f"  gram timing ({what}, bf16, {tuple(shape)}, plan "
            f"{gram_plan(k, b, d)}, {gram_blocks(k, b, d)} CTAs): kernel "
            f"{ms:.4f} ms on the device ({issue_ms:.4f} ms to issue), plain "
            f"{plain_ms:.4f} ms, F.cosine_similarity {library_ms:.4f} ms, "
            f"F.normalize + @ {composition_ms:.4f} ms, launch floor "
            f"{floor_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}; "
            f"{nbytes(x) + 4 * k * b * b} bytes, {ops} flops); inputs stay "
            f"in L2")
        out.append(dict(path=(what if what.startswith("LM") else
                              f"federation ({what})"), shape=str(shape),
                        ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                        bound_by=b_by, library_ms=library_ms,
                        composition_ms=composition_ms, floor_ms=floor_ms))
    return dict(max_abs_err=errs[torch.bfloat16], timings=out)


def lora_inputs(m, k, n, r, dtype, seed=0):
    """x, W, A, B as the round has them: W scaled d_in^-0.5, A rank^-0.5
    (frozen, shared), B small (trained from 0)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((m, k), generator=g, device="cuda")
    w = torch.randn((k, n), generator=g, device="cuda") * k ** -0.5
    a = torch.randn((k, r), generator=g, device="cuda") * r ** -0.5
    b = torch.randn((r, n), generator=g, device="cuda") * 0.02
    return tuple(t.to(dtype) for t in (x, w, a, b))


#: forward, dx and dB checks beyond the round's shapes: name -> (M, K, N, r)
LORA_CASES = {"unaligned (37, 100, 50, r 3)": (37, 100, 50, 3),
              "r 1 (64, 256, 128)": (64, 256, 128, 1),
              "r 32 (128, 192, 96)": (128, 192, 96, 32),
              "r 33, 64 x 32 tiles in 3 K ranges (512, 768, 256)":
                  (512, 768, 256, 33),
              "r 64, 64 x 64 tiles in 2 K ranges (512, 768, 768)":
                  (512, 768, 768, 64),
              "r 64 ragged (100, 200, 72)": (100, 200, 72, 64),
              "M 1 (1, 768, 768, r 8)": (1, 768, 768, 8),
              "ragged, one K range (1000, 100, 500, r 5)": (1000, 100, 500, 5),
              "odd N (1000, 104, 499, r 8)": (1000, 104, 499, 8)}


def lora_phase() -> dict:
    log("kernel phase: lora_matmul (forward and dx: the kernel; dB: "
        "torch.matmul on the kernel's x @ A)")
    errs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for what, shape in (("wq / wo (512, 768, 768, r 8)",
                             (512, 768, 768, 8)),
                            ("wk / wv (512, 768, 256, r 8)",
                             (512, 768, 256, 8)),
                            ("ragged (100, 200, 72, r 4)",
                             (100, 200, 72, 4))):
            args = lora_inputs(*shape, dtype, seed=shape[2])
            err = check_vjp(f"lora_matmul {what} {dtype}", lora_matmul,
                            ref.lora_matmul_ref, args, (0, 3), TOL[dtype])
            errs.setdefault(dtype, err)
        for what, shape in LORA_CASES.items():
            args = lora_inputs(*shape, dtype, seed=sum(shape))
            check_vjp(f"lora_matmul {what} {dtype}", lora_matmul,
                      ref.lora_matmul_ref, args, (0, 3), TOL[dtype])
        # dx's orientation in the forward: W, A and B as transposed views
        # (their loop axis contiguous); the backward then reads W^T, B^T
        # and A^T with the n / r axis contiguous
        for r in (16, 33, 64):
            x, w, a, b = lora_inputs(96, 160, 136, r, dtype, seed=96 + r)
            check_vjp(f"lora_matmul transposed W, A, B (96, 160, 136, r {r})"
                      f" {dtype}", lora_matmul, ref.lora_matmul_ref,
                      (x, *(t.t().contiguous().t() for t in (w, a, b))),
                      (0, 3), TOL[dtype])

    def composition(x, w, a, b):
        return torch.addmm(x @ w, x @ a, b)

    def dx_kernel(dy, w, a, b):                     # what backward launches
        return lora_matmul(dy, w.t(), b.t(), a.t())

    out = []
    for n, r_ in ((768, 8), (256, 8), (768, 33), (768, 64)):
        args = lora_inputs(512, 768, n, r_, torch.bfloat16, seed=n + r_)
        sets = copies(args)
        ms = time_ms(lambda *t: lora_matmul(*t), sets)
        issue_ms = host_ms(lambda *t: lora_matmul(*t), sets)
        plain_ms = time_ms(lambda *t: ref.lora_matmul_ref(*t), sets)
        composition_ms = time_ms(composition, sets)
        matmul_ms = time_ms(lambda x, w, a, b: torch.matmul(x, w), sets)
        dy_sets = [(torch.randn((512, n), device="cuda").to(torch.bfloat16),
                    *t[1:]) for t in sets]
        dx_ms = time_ms(dx_kernel, dy_sets)
        x, w, a, b = args
        m_, k_ = 512, 768
        ops = 2 * m_ * k_ * n + 2 * m_ * k_ * r_ + 2 * m_ * r_ * n
        moved = nbytes(x, w, a, b) + m_ * n * x.element_size()
        b_ms, b_by = bound_ms(moved, ops, torch.bfloat16)
        plans = {what: (tile_plan(*mkn), lora_blocks(*mkn)) for what, mkn in
                 (("forward", (m_, k_, n)), ("dx", (m_, n, k_)))}
        log(f"  lora_matmul timing (bf16, M 512, K 768, N {n}, r {r_}): "
            f"kernel {ms:.4f} ms on the device ({issue_ms:.4f} ms to "
            f"issue), dx kernel {dx_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"addmm(x @ W, x @ A, B) {composition_ms:.4f} ms, "
            f"torch.matmul(x, W) {matmul_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}; {moved} bytes, {ops} flops); "
            f"(bn, k_split) and blocks {plans}")
        out.append(dict(path="federation" if r_ == 8 else
                        f"federation at rank {r_}",
                        shape=f"M 512, K 768, N {n}, r {r_}",
                        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=None, composition_ms=composition_ms,
                        matmul_ms=matmul_ms, dx_ms=dx_ms))
    return dict(max_abs_err=errs[torch.bfloat16], timings=out)


# ----------------------------------------------------------------------
# kernel phase: lora_matmul's node axis (the node-stacked round's calls)
def lora_node_inputs(nodes, m, k, n, r, dtype, seed=0):
    """x (K, M, k), shared W and A, B (K, r, n) per node, as the stacked
    round has them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((nodes, m, k), generator=g, device="cuda")
    w = torch.randn((k, n), generator=g, device="cuda") * k ** -0.5
    a = torch.randn((k, r), generator=g, device="cuda") * r ** -0.5
    b = torch.randn((nodes, r, n), generator=g, device="cuda") * 0.02
    return tuple(t.to(dtype) for t in (x, w, a, b))


def lora_nodes_phase() -> list:
    """The node axis against the plain version at K 1, 4 and 16 (M 512,
    K 768, N 768 and 256, r 8 and 64, bf16 and f32; output, dx and dB),
    then timed at the stacked round's shapes beside K launches of the
    single-node kernel and a ``torch.baddbmm`` composition."""
    log("kernel phase: lora_matmul's node axis (x (K, 512, 768), W and A "
        "shared, B per node; forward and dx: one launch for all nodes)")
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        for nodes in (1, 4, 16):
            for n in (768, 256):
                for r in (8, 64):
                    args = lora_node_inputs(nodes, 512, 768, n, r, dtype,
                                            seed=nodes * 1000 + n + r)
                    err = check_vjp(
                        f"lora_matmul K {nodes} (512, 768, {n}, r {r}) "
                        f"{dtype}", lora_matmul, ref.lora_matmul_ref, args,
                        (0, 3), TOL[dtype])
                    worst[dtype] = max(worst.get(dtype, 0.0), err)
    # the LM driver's node axes, rank 8: the task pass (batch 8 x 128
    # tokens a node: M 1024) and the anchor pass (16 x 128: M 2048), over
    # K 4 nodes, or over the K 2 of a uniform C 2 cohort; and the async
    # participation round's (K 8 x M 512)
    for dtype in (torch.bfloat16, torch.float32):
        for nodes, m in ((4, 1024), (4, 2048), (2, 1024), (2, 2048),
                         (8, 512)):
            for n in (768, 256):
                args = lora_node_inputs(nodes, m, 768, n, 8, dtype,
                                        seed=nodes * m + n)
                err = check_vjp(f"lora_matmul K {nodes} ({m}, 768, {n}, r 8)"
                                f" {dtype}", lora_matmul, ref.lora_matmul_ref,
                                args, (0, 3), TOL[dtype])
                worst[dtype] = max(worst[dtype], err)
    log(f"  node axis: worst forward error {worst} (of max(1, |value|))")

    def per_node(x, w, a, b):                 # K launches of today's kernel
        return [lora_matmul(x[k], w, a, b[k]) for k in range(x.shape[0])]

    def composition(x, w, a, b):
        return torch.baddbmm(x @ w, x @ a, b)

    def dx_kernel(dy, w, a, b):               # what backward launches
        return lora_apply(dy, w.t(), b.transpose(-1, -2), a.t(), False)[0]

    out = []
    for path, nodes, m in (("engine", 4, 512), ("engine", 16, 512),
                           ("async participation", 8, 512),
                           ("LM driver", 4, 1024)):
        for n in (768, 256):
            args = lora_node_inputs(nodes, m, 768, n, 8, torch.bfloat16,
                                    seed=nodes + n + m)
            sets = copies(args)
            ms = time_ms(lambda *t: lora_matmul(*t), sets)
            per_node_ms = time_ms(per_node, sets)
            plain_ms = time_ms(lambda *t: ref.lora_matmul_ref(*t), sets)
            composition_ms = time_ms(composition, sets)
            dy_sets = [(torch.randn((nodes, m, n), device="cuda").to(
                torch.bfloat16), *t[1:]) for t in sets]
            dx_ms = time_ms(dx_kernel, dy_sets)
            x, w, a, b = args
            ops = nodes * (2 * m * 768 * n + 2 * m * 768 * 8
                           + 2 * m * 8 * n)
            moved = nbytes(x, w, a, b) + nodes * m * n * x.element_size()
            b_ms, b_by = bound_ms(moved, ops, torch.bfloat16)
            plan = (tile_plan(m, 768, n, nodes),
                    lora_blocks(m, 768, n, nodes))
            log(f"  lora_matmul node-axis timing (bf16, K {nodes}, M {m}, "
                f"K 768, N {n}, r 8): kernel {ms:.4f} ms, dx kernel "
                f"{dx_ms:.4f} ms, {nodes} launches of the single-node kernel "
                f"{per_node_ms:.4f} ms, plain {plain_ms:.4f} ms, baddbmm(x @ "
                f"W, x @ A, B) {composition_ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by}; {moved} bytes, {ops} flops); (bn, k_split), "
                f"blocks {plan}")
            out.append(dict(path=f"{path} (node axis, K {nodes})",
                            shape=f"K {nodes}, M {m}, K 768, N {n}, r 8",
                            ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, library_ms=None,
                            composition_ms=composition_ms,
                            per_node_ms=per_node_ms, dx_ms=dx_ms))
    return out


# ----------------------------------------------------------------------
# kernel phase: selective scan
MAMBA_C = 8192 * 16                    # falcon-mamba-7b: d_inner x state
LRU_C = 4096                           # recurrentgemma-9b: lru_width


def scan_inputs(b, s, c, dtype, h0_zero=True, seed=0):
    """da in (0.3, 0.99) (exp(dt A) of a Mamba layer lies in (0, 1)), dbx
    and h0 standard normal; h0 is 0 for the prefill's shapes."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    da = 0.3 + 0.69 * torch.rand((b, s, c), generator=g, device="cuda")
    dbx = torch.randn((b, s, c), generator=g, device="cuda")
    h0 = torch.randn((b, c), generator=g, device="cuda")
    return (da.to(dtype), dbx.to(dtype),
            torch.zeros_like(h0) if h0_zero else h0)


def scan_boundary_lengths(c: int, near: int = 2560) -> list:
    """Prompt lengths from ``near`` up at which S is one step past and one
    step short of a whole number of ``scan_plan``'s chunks (B 1): one
    block's first sub-chunk of one step, or its last sub-chunk a step
    short."""
    found = {}
    for s in range(near, near + 4096):
        chunk = scan_plan(1, s, c)[1]
        for off in (1, chunk - 1):
            if chunk < s and s % chunk == off % chunk:
                found.setdefault(off == 1, s)
        if len(found) == 2:
            break
    return [found[True], found[False]]


def scan_resident(is_bf16: int) -> dict:
    """Resident blocks a SM of the one-pass and the chained kernel."""
    lib = _build.load("selective_scan")
    return {design: lib.selective_scan_resident(chained, is_bf16)
            for chained, design in enumerate(("one pass", "chained"))}


def off16(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` one element past the start of its
    buffer: its pointer off 16 bytes."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return out.view(t.shape).copy_(t)


def scan_check(what, shape, dtype, zero, off=False) -> float:
    """The kernel against the sequential plain version (``TOL[f32]`` of
    max(1, max |h|)) and, bit for bit, against the plain twin of its plan
    (``selective_scan_chunked_ref`` at the plan's ``fold_steps``; for one
    pass that is the sequential version); a second launch on the same
    inputs bit for bit.  ``off``: every input's pointer off 16 bytes, which
    the plan sends to the chained design.  Returns the error against the
    sequential version."""
    args = scan_inputs(*shape, dtype, zero, seed=shape[1])
    if off:
        args = tuple(map(off16, args))
    tile, chunk, blocks = scan_plan(*shape, aligned=not off)
    fold = fold_steps(tile == LANES, shape[1])
    resident = _build.load("selective_scan").selective_scan_resident(
        int(tile == LANES), int(dtype == torch.bfloat16))
    got = selective_scan(*args)
    again = selective_scan(*args)
    want = ref.selective_scan_ref(*args)
    twin = ref.selective_scan_chunked_ref(*args, fold)
    torch.cuda.synchronize()
    # both widen the same inputs and compute in f32: the f32 tolerance
    # holds for bf16 inputs too
    scale = max(1.0, want[0].abs().max().item())
    err = max((g - w).abs().max().item() for g, w in zip(got, want)) / scale
    twin_err = max((g - w).abs().max().item() for g, w in zip(got, twin))
    same = all(torch.equal(g, a) for g, a in zip(got, again))
    log(f"  selective_scan {what} {dtype}: plan tile {tile}, chunk {chunk} "
        f"({-(-shape[1] // chunk)} chunks; pairs of {fold} steps), {blocks} "
        f"blocks, {resident} resident a SM; max_abs_err "
        f"{err:.3g} of max(1, max |h|) = {scale:.4g} (h_all and h_last; tol "
        f"{TOL[torch.float32]}); against the plan's plain twin max abs "
        f"{twin_err:.3g} (want 0: bit for bit); second launch bit-equal "
        f"{same}")
    if not err <= TOL[torch.float32]:
        raise AssertionError(f"selective_scan {what} {dtype}: {err}")
    if twin_err != 0.0 or not same:
        raise AssertionError(f"selective_scan {what} {dtype}: not bit for "
                             f"bit (twin {twin_err}, relaunch {same})")
    return err


def scan_graph_check(what, shape) -> None:
    """One call captured in a CUDA graph, replayed twice: each replay bit
    for bit the eager call (no state carries from one launch to the
    next, so a replay needs no reset)."""
    args = scan_inputs(*shape, torch.float32, False, seed=7)
    eager = selective_scan(*args)
    cap = capture_graph(lambda: selective_scan(*args), [])
    outs = []
    for _ in range(2):
        for t in cap.out:
            t.fill_(float("nan"))
        cap.graph.replay()
        outs.append(tuple(t.clone() for t in cap.out))
    torch.cuda.synchronize()
    same = [all(torch.equal(g, w) for g, w in zip(o, eager)) for o in outs]
    log(f"  selective_scan graph replay {what} (f32, h0 != 0): replays bit "
        f"for bit the eager call {same}; launches a replay "
        f"{dict(zip((fn.__name__ for fn in COUNTED), cap.launches))}")
    if not all(same):
        raise AssertionError(f"selective_scan graph replay {what}: {same}")
    del cap


def scan_phase() -> dict:
    log("kernel phase: selective_scan (forward only, as the prefill runs "
        "it)")
    for is_bf16 in (0, 1):
        log(f"  selective_scan resident blocks a SM "
            f"({'bf16' if is_bf16 else 'f32'}, 256 threads): "
            f"{scan_resident(is_bf16)}")
    past, short = scan_boundary_lengths(LRU_C)
    shapes = (("falcon-mamba prefill (1, 512, 131072)", (1, 512, MAMBA_C),
               True),
              ("falcon-mamba prefill (1, 128, 131072)", (1, 128, MAMBA_C),
               True),
              ("(1, 128, 131072), inputs off 16 bytes", (1, 128, MAMBA_C),
               True, True),
              ("C not a multiple of 4 (1, 64, 131070), h0 != 0",
               (1, 64, MAMBA_C - 2), False),
              ("ragged (3, 37, 1000), h0 != 0", (3, 37, 1000), False),
              ("S 1 (2, 1, 131072), h0 != 0", (2, 1, MAMBA_C), False),
              ("hybrid prefill (1, 2560, 4096)", (1, 2560, LRU_C), True),
              ("hybrid prompt (1, 2219, 4096)", (1, 2219, LRU_C), True),
              ("hybrid prompt (1, 2895, 4096)", (1, 2895, LRU_C), True),
              ("B 3 (3, 700, 4096), h0 != 0", (3, 700, LRU_C), False),
              ("S 1 (1, 1, 4096), h0 != 0", (1, 1, LRU_C), False),
              (f"one step past whole chunks (1, {past}, 4096)",
               (1, past, LRU_C), True),
              (f"one step short of whole chunks (1, {short}, 4096), h0 != 0",
               (1, short, LRU_C), False))
    errs = {dtype: max(scan_check(what, shape, dtype, *flags)
                       for what, shape, *flags in shapes)
            for dtype in (torch.float32, torch.bfloat16)}
    scan_graph_check("hybrid prefill (1, 2560, 4096), chained", (1, 2560,
                                                                  LRU_C))
    scan_graph_check("falcon-mamba prefill (1, 512, 131072), one pass",
                     (1, 512, MAMBA_C))

    timings = []
    for path, s, c in (("ssm serve", 512, MAMBA_C), ("ssm serve", 128, MAMBA_C),
                       ("hybrid serve", 2560, LRU_C),
                       ("hybrid serve", 2895, LRU_C)):
        sets = copies(scan_inputs(1, s, c, torch.float32))
        ms = time_ms(lambda *x: selective_scan(*x), sets)
        issue_ms = host_ms(lambda *x: selective_scan(*x), sets)
        plain_ms = time_ms(lambda *x: ref.selective_scan_ref(*x), sets,
                           iters=10)
        # not the same function: the same bytes (read da and dbx, write
        # one f32 tensor of their shape) through one elementwise call,
        # what the card reaches on this access count
        add_ms = time_ms(lambda a, b, _: torch.add(a, b, out=torch.empty_like(
            a)), sets)
        da, dbx, h0 = sets[0]
        moved = nbytes(da, dbx, h0) + 4 * (da.numel() + h0.numel())
        ops = 2 * da.numel()                           # one mul, one add
        b_ms, b_by = bound_ms(moved, ops, torch.float32)
        shape = f"B 1, S {s}, C {c}, f32"
        log(f"  selective_scan timing ({path} prefill, {shape}; plan "
            f"{scan_plan(1, s, c)}): kernel {ms:.4f} ms on the device "
            f"({issue_ms:.4f} ms to issue), plain {plain_ms:.4f} ms, no "
            f"single PyTorch call, torch.add(da, dbx, out=) over the same "
            f"bytes {add_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {moved} "
            f"bytes, {ops} flops; {b_ms / ms:.3f} of it)")
        timings.append(dict(path=path, shape=shape, ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                            library_ms=None, add_ms=add_ms))
    return dict(max_abs_err=errs[torch.float32], timings=timings)


# ----------------------------------------------------------------------
# launch counters of every wrapper, set to 0 just before a path runs
WRAPPERS = {"decode_attention": decode_attention,
            "flash_attention": flash_attention, "gram": cosine_gram,
            "lora_matmul": lora_matmul, "selective_scan": selective_scan,
            "mla_decode": mla_decode}


def reset_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


# ----------------------------------------------------------------------
# serve phase
PROMPT_LENS = (128, 256, 384, 512)


def serve_requests(cfg, n_per_len: int = 4, max_new: int = 64):
    """16 requests, all at t=0, prompt lengths interleaved 128..512."""
    reqs = []
    for j, plen in enumerate(PROMPT_LENS):
        for i, r in enumerate(poisson_requests(
                n_per_len, 0.0, prompt_len=plen, vocab_size=cfg.vocab_size,
                seed=j, max_new=max_new)):
            reqs.append(dataclasses.replace(r, rid=i * len(PROMPT_LENS) + j))
    return sorted(reqs, key=lambda r: r.rid)


SERVE_CFG = ServeConfig(n_slots=8, cache_len=1024, block_steps=8,
                        max_new_tokens=64)


def layer_kinds(cfg) -> tuple:
    """(attention layers, recurrent layers) of a model: every dense and
    moe layer attends, every ssm layer recurs, and the hybrid's pattern
    decides."""
    if cfg.family == "ssm":
        return 0, cfg.n_layers
    if cfg.family != "hybrid":
        return cfg.n_layers, 0
    pat = cfg.rglru.block_pattern
    n_att = sum(pat[i % len(pat)] == "attention" for i in range(cfg.n_layers))
    return n_att, cfg.n_layers - n_att


def decode_kernel(cfg) -> str:
    """The kernel a decode step's attention launches: ``mla_decode`` under
    MLA (DeepSeek-V2), else ``decode_attention``."""
    return "mla_decode" if cfg.mla is not None else "decode_attention"


def serve_launches(cfg, eng) -> dict:
    """What ``eng``'s runs so far launched by the design: per admission
    the flash kernel once per attention layer and the scan once per
    recurrent layer (ssm, RG-LRU), and per decode step the decode kernel
    (``mla_decode`` under MLA) once per attention layer -- the replayed
    blocks' steps and each capture's warm-up block."""
    n_att, n_rec = layer_kinds(cfg)
    admits = eng.stats["admit_dispatches"]
    steps = eng.scfg.block_steps * (eng.stats["block_dispatches"]
                                    + eng.graph_stats["captures"])
    want = dict.fromkeys(WRAPPERS, 0)
    want.update(flash_attention=n_att * admits,
                selective_scan=n_rec * admits)
    want[decode_kernel(cfg)] = n_att * steps
    return want


def sum_counts(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in WRAPPERS}


def serve_phase(cfg, params, scfg=SERVE_CFG, reqs=None, rt=None) -> dict:
    """The requests (by default the 16 of ``serve_requests``) through the
    slots, every decode block one CUDA-graph replay: the graph is captured
    first, outside the counted window; then every admission must run the
    flash kernel once per attention layer and the scan once per recurrent
    layer, every decode step the decode kernel once per attention layer,
    nothing else may launch a kernel, and each block must be one replay
    and one readback.  Then 3 more replays of the block over the filled
    pool (after the counted window) are timed by CUDA events: the device
    ms of a decode step (``step_ms``)."""
    reqs = reqs or serve_requests(cfg)
    max_new = reqs[0].max_new
    log(f"serve phase: {cfg.arch_id}, {cfg.family}, {cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.dtype}"
        + (f", window_override {rt.window_override}" if rt else "")
        + f", {scfg.n_slots} slots x {scfg.cache_len}, M = "
        f"{scfg.block_steps}, {len(reqs)} requests x {max_new} tokens "
        f"(prompts {min(len(r.tokens) for r in reqs)}.."
        f"{max(len(r.tokens) for r in reqs)}), decode blocks replayed from a "
        f"CUDA graph")
    # warm-up (cuBLAS handles, allocator) on its own engine, not counted
    ServeEngine(params, cfg, dataclasses.replace(scfg, max_new_tokens=9),
                rt=rt, device="cuda").serve(
        [dataclasses.replace(r, max_new=9) for r in reqs[:2]])
    torch.cuda.synchronize()
    eng = ServeEngine(params, cfg, scfg, rt=rt, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    graph = eng.capture()
    per_replay = {name: graph.launches_by_name()[fn.__name__]
                  for name, fn in WRAPPERS.items()}
    want_replay = dict.fromkeys(WRAPPERS, 0)
    want_replay[decode_kernel(cfg)] = layer_kinds(cfg)[0] * scfg.block_steps
    if per_replay != want_replay:
        raise AssertionError(f"the decode block's graph records "
                             f"{per_replay}, want {want_replay}")
    capture_s = eng.graph_stats["capture_s"]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    recs = eng.serve(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    st, gst = eng.stats, eng.graph_stats
    bad = [r.rid for r in reqs if recs[r.rid].state != "completed"
           or len(recs[r.rid].tokens) != max_new]
    if bad:
        raise AssertionError(f"requests not completed with {max_new} "
                             f"tokens: {bad}")
    steps = st["block_dispatches"] * scfg.block_steps
    want = serve_launches(cfg, eng)
    # the capture's warm-up is not counted
    want[decode_kernel(cfg)] = layer_kinds(cfg)[0] * steps
    if launches != want or st["admit_dispatches"] != len(reqs):
        raise AssertionError(f"kernel launches {launches}, want {want} "
                             f"({st['admit_dispatches']} admissions, "
                             f"{steps} decode steps)")
    if not (st["block_syncs"] == gst["replays"] == st["block_dispatches"]
            and gst["captures"] == 1):
        raise AssertionError(f"blocks {st['block_dispatches']}, replays "
                             f"{gst['replays']}, readbacks "
                             f"{st['block_syncs']}, captures "
                             f"{gst['captures']}: want one capture, one "
                             f"replay and one readback per block")
    n_tok = sum(len(recs[r.rid].tokens) for r in reqs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ttft = sorted(recs[r.rid].first_token_s for r in reqs)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(3):
        graph.graph.replay()
    end.record()
    end.synchronize()
    step_ms = start.elapsed_time(end) / (3 * scfg.block_steps)
    log(f"  a replayed decode step over the filled pool: {step_ms:.3f} ms on "
        f"the device (3 blocks of {scfg.block_steps}, CUDA events)")
    log(f"  time to first token (end of the first block that reads it "
        f"back): min {ttft[0]:.3f} s, median {ttft[len(ttft) // 2]:.3f} s, "
        f"max {ttft[-1]:.3f} s")
    log(f"  1 graph captured in {capture_s:.3f} s (one eager warm-up block, "
        f"then the capture; one replay launches {per_replay}); completed "
        f"{len(reqs)} requests, {n_tok} tokens in {wall:.3f} s: "
        f"{n_tok / wall:.1f} tokens/s; {st['block_dispatches']} blocks, "
        f"{gst['replays']} replays, {st['block_syncs']} readbacks, {steps} "
        f"decode steps, {st['admit_dispatches']} admissions; launches "
        f"{launches}; peak memory {peak:.2f} GiB")
    return dict(launches=launches, wall_s=wall, tokens=n_tok, stats=dict(st),
                first=reqs[0], reqs=reqs, records=recs, peak_gib=peak,
                capture_s=capture_s, replays=gst["replays"], scfg=scfg,
                rt=rt, ttft=ttft, step_ms=step_ms)


def serve_graph_oracle_phase(cfg, params, served) -> dict:
    """The serve phase's stream again through ``eager=True`` (the same
    block without the graph): records token-identical to the replayed run,
    the same terminal states and identical ``stats``; exact launches."""
    eng = ServeEngine(params, cfg, served["scfg"], rt=served["rt"],
                      device="cuda", eager=True)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    recs = eng.serve(served["reqs"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    want = serve_launches(cfg, eng)
    if launches != want:
        raise AssertionError(f"eager serve: launches {launches}, want {want}")
    differ = [r.rid for r in served["reqs"]
              if (recs[r.rid].state, recs[r.rid].tokens)
              != (served["records"][r.rid].state,
                  served["records"][r.rid].tokens)]
    if differ or eng.stats != served["stats"]:
        raise AssertionError(f"serve graph oracle ({cfg.arch_id}): records "
                             f"of {differ} differ, stats {eng.stats} vs "
                             f"{served['stats']}")
    if eng.graph_stats["captures"] or eng.graph_stats["replays"]:
        raise AssertionError(f"eager engine replayed: {eng.graph_stats}")
    n_tok = sum(len(recs[r.rid].tokens) for r in served["reqs"])
    log(f"serve graph oracle ({cfg.arch_id}): eager blocks {wall:.3f} s, "
        f"{n_tok / wall:.1f} tokens/s, against the replayed "
        f"{served['tokens'] / served['wall_s']:.1f} tokens/s: "
        f"{len(served['reqs'])} records token-identical, stats identical "
        f"({eng.stats}); launches {launches}")
    return dict(launches=launches, wall_s=wall, tokens=n_tok)


def chaos_requests(cfg, n: int = 12):
    return poisson_requests(n, 0.0, prompt_len=128,
                            vocab_size=cfg.vocab_size, seed=5, max_new=64)


FORCED_SLOT = 6


class GuardLog(ServeEngine):
    """A ServeEngine that logs, for every block, each busy slot whose
    fault flag the block raised: ``(first global decode step, slot,
    rid)``.  Only the chaos phase uses it, to tell the two output guards'
    trips apart; it reads ``t`` once per block before the replay."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.fault_log = []

    def _run_block(self, fault_plan, cancel):
        t0 = int(self.state["t"])
        busy = [(s, rid) for s, rid in enumerate(self._sched.slot_rid)
                if rid is not None and not cancel[s]]
        packed = super()._run_block(fault_plan, cancel)
        fault_h = packed[2 * self.scfg.block_steps + 1]
        self.fault_log += [(t0, s, rid) for s, rid in busy if fault_h[s]]
        return packed


def chaos_plan(cfg, scfg, max_rep: int):
    """A seeded plan of NaN and freeze events (``seeded_plan``), all after
    the crash point, so the crash leaves no stall count in flight; a
    forced token on slot 6 for ``max_rep + 1`` steps from step 0, so the
    repetition guard must trip on the request that slot holds from the
    start (its ``rep_run`` rides the snapshot when the trip comes after
    the crash); the crash after block 1."""
    m = scfg.block_steps
    base = seeded_plan(0, n_steps=80, n_slots=scfg.n_slots, nan_rate=0.02,
                       freeze_rate=0.02, freeze_span=3 * m)
    if FORCED_SLOT in base.nan_slots + base.freeze_slots:
        raise AssertionError(f"chaos: the seeded plan's NaN / freeze slots "
                             f"{base.nan_slots} include the forced slot")
    off = 3 * m
    return dataclasses.replace(
        base, nan_steps=tuple(t + off for t in base.nan_steps),
        freeze_steps=tuple(t + off for t in base.freeze_steps),
        force_steps=tuple(range(max_rep + 1)), force_slots=(FORCED_SLOT,),
        force_token=17, crash_after_block=1)


def guard_trips(plan, m: int, fault_log) -> tuple:
    """Split a GuardLog's faults between the guards: a fault in a block
    where the plan poisons that slot is the NaN guard's, every other one
    the repetition guard's."""
    nan, rep = [], []
    for t0, s, rid in fault_log:
        hit = s in plan.nan_slots and any(t0 <= t < t0 + m
                                          for t in plan.nan_steps)
        (nan if hit else rep).append((t0, s, rid))
    return nan, rep


def chaos_phase(cfg, params, temperature: float = 0.0) -> dict:
    """fedmm-base under a seeded chaos plan (NaN, freeze and forced-token
    events; the stall watchdog and the repetition guard on; a snapshot
    after every block and a simulated crash after block 1), then
    ``ServeEngine.resume`` + ``resume_serve``: every request terminal,
    faults and stalls counted, each output guard tripped (the NaN guard on
    a poisoned slot, the repetition guard on the forced slot, whose
    request is retried), the faults the same across the crash, one graph
    per plan and engine, exact launches, and the resumed stream
    token-identical to an uncrashed run with the same plan."""
    scfg = ServeConfig(n_slots=8, cache_len=256, block_steps=8,
                       max_new_tokens=64, max_attempts=3, stall_blocks=2,
                       temperature=temperature, seed=7)
    reqs = chaos_requests(cfg)
    snap = Path(__file__).resolve().parent / "build" / "chip_smoke" \
        / "serve_snapshot.npz"
    engines = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    probe_eng = ServeEngine(params, cfg, scfg, device="cuda")
    probe = probe_eng.serve(reqs)
    engines.append(probe_eng)
    longest = max(max(sum(1 for _ in g) for _, g in itertools.groupby(
        probe[r.rid].tokens)) for r in reqs)
    # the guard must stay above every natural run, and the forced run must
    # trip it before the forced slot's request spends its budget
    max_rep = longest + 2
    if max_rep + 1 > scfg.max_new_tokens - 1:
        raise AssertionError(
            f"chaos: the probe's longest run of one token is {longest}, so "
            f"a repetition guard above it (max_repeat {max_rep}) cannot "
            f"trip within {scfg.max_new_tokens} tokens")
    scfg = dataclasses.replace(scfg, max_repeat=max_rep)
    plan = chaos_plan(cfg, scfg, max_rep)
    clean = dataclasses.replace(plan, crash_after_block=-1)
    want_eng = GuardLog(params, cfg, scfg, device="cuda")
    want = want_eng.serve(reqs, fault_plan=clean)
    engines.append(want_eng)
    crashed = GuardLog(params, cfg, scfg, device="cuda")
    engines.append(crashed)
    try:
        crashed.serve(reqs, fault_plan=plan, snapshot_path=str(snap),
                      snapshot_every_blocks=1)
        raise AssertionError("chaos: the plan's crash did not fire")
    except SimulatedCrash:
        pass
    resumed = GuardLog.resume(str(snap), params, cfg, device="cuda")
    engines.append(resumed)
    got = resumed.resume_serve(fault_plan=plan)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    want_launches = sum_counts(*(serve_launches(cfg, e) for e in engines))
    snap_bytes = snap.stat().st_size
    shutil.rmtree(snap.parent)
    counts = state_counts(got)
    st = want_eng.stats
    problems = []
    if sum(counts.values()) != len(reqs) or any(
            got[r.rid].state not in ("completed", "failed") for r in reqs):
        problems.append(f"not every request terminal: {counts}")
    if st["faults_detected"] < 1 or st["stalls_detected"] < 1:
        problems.append(f"faults / stalls not detected: {st}")
    m = scfg.block_steps
    nan, rep = guard_trips(plan, m, want_eng.fault_log)
    forced = [(t0, rid) for t0, s, rid in rep
              if s == FORCED_SLOT and t0 <= max_rep]
    if len(want_eng.fault_log) != st["faults_detected"]:
        problems.append(f"fault log {want_eng.fault_log} against {st}")
    if not nan:
        problems.append(f"the NaN guard never tripped: {want_eng.fault_log}")
    if not forced:
        problems.append(f"the repetition guard did not trip on the forced "
                        f"slot within the forced run: {want_eng.fault_log}")
    elif want[forced[0][1]].retries < 1:
        problems.append(f"the forced request {forced[0][1]} was not "
                        f"retried: {want[forced[0][1]]}")
    split = crashed.fault_log + resumed.fault_log
    if split != want_eng.fault_log:
        problems.append(f"faults across the crash {split} against the "
                        f"uncrashed run's {want_eng.fault_log}")
    if [e.graph_stats["captures"] for e in engines] != [1, 1, 1, 1]:
        problems.append(f"captures {[e.graph_stats for e in engines]}")
    for e in engines:
        if not (e.graph_stats["replays"] == e.stats["block_dispatches"]
                == e.stats["block_syncs"]):
            problems.append(f"replays / readbacks {e.graph_stats} {e.stats}")
    differ = [r.rid for r in reqs
              if (got[r.rid].state, got[r.rid].tokens)
              != (want[r.rid].state, want[r.rid].tokens)]
    if differ:
        problems.append(f"resumed records {differ} differ from the "
                        f"uncrashed run")
    if state_counts(want) != counts:
        problems.append(f"states {counts} vs uncrashed {state_counts(want)}")
    if launches != want_launches:
        problems.append(f"launches {launches}, want {want_launches}")
    if crashed.stats["snapshot_writes"] != 2 or resumed._blocks_done < 2:
        problems.append(f"snapshots {crashed.stats}")
    log(f"chaos phase ({cfg.arch_id}, temperature {temperature}, "
        f"{len(reqs)} requests x 64 tokens over 8 slots x 256, "
        f"{time.perf_counter() - t0:.1f} s): plan {len(plan.nan_steps)} "
        f"NaN steps on slots {plan.nan_slots}, {len(plan.freeze_steps)} "
        f"frozen steps on slots {plan.freeze_slots}, "
        f"{len(plan.force_steps)} forced steps on slot {FORCED_SLOT}, "
        f"max_repeat {max_rep} (longest run of one token unforced "
        f"{longest}), crash after block 1; uncrashed run: "
        f"{state_counts(want)}, faults {st['faults_detected']} (NaN guard "
        f"{len(nan)}, repetition guard {len(rep)}: (first step, slot, rid) "
        f"{want_eng.fault_log}), stalls "
        f"{st['stalls_detected']}, {st['block_dispatches']} blocks; crashed "
        f"after {crashed.stats['block_dispatches']} blocks with "
        f"{crashed.stats['snapshot_writes']} snapshots of {snap_bytes} "
        f"bytes; resumed from block "
        f"{resumed._blocks_done - resumed.stats['block_dispatches']}: "
        f"{counts}, faults {resumed.stats['faults_detected']}, stalls "
        f"{resumed.stats['stalls_detected']}; captures "
        f"{[e.graph_stats['captures'] for e in engines]} (probe, uncrashed, "
        f"crashed, resumed) in "
        f"{sum(e.graph_stats['capture_s'] for e in engines):.3f} s; "
        f"records identical to the uncrashed run: {not differ}; launches "
        f"{launches}")
    if problems:
        raise AssertionError(f"chaos phase: {problems}")
    return dict(launches=launches, wall_s=wall)


def trace_phase(cfg, params, scfg=SERVE_CFG, reqs=None, rt=None) -> None:
    """A separate, shorter serve run (the first 8 requests, or fewer, x
    17 tokens) under ``torch.profiler``, its graph captured before the
    profiled window:
    device busy time against the host's wall time, and the device time by
    kernel.  The untraced serve phase above gives the tokens/s; this run
    only says where its time goes."""
    from torch.profiler import ProfilerActivity, profile
    scfg = dataclasses.replace(scfg, max_new_tokens=17)
    reqs = [dataclasses.replace(r, max_new=17)
            for r in (reqs[:8] if reqs else serve_requests(cfg, 2, 17))]
    eng = ServeEngine(params, cfg, scfg, rt=rt, device="cuda")
    eng.capture()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve(reqs)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    steps = eng.stats["block_dispatches"] * scfg.block_steps
    device_summary(prof, wall_us, f"trace phase ({cfg.arch_id}, profiled, "
                   f"{len(reqs)} requests x 17 tokens, "
                   f"{eng.stats['admit_dispatches']} admissions, {steps} "
                   f"decode steps in {eng.graph_stats['replays']} replays)")


def device_summary(prof, wall_us: float, title: str) -> None:
    """Device busy time against the host's wall time, the count of
    PyTorch ops the host ran, and device time by kernel, from a
    ``torch.profiler`` run; raises without device events."""
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        raise AssertionError(f"{title}: the profiler recorded no device "
                             f"events, so the device's busy share is unknown")
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy = sum(by_name.values())
    host_ops = sum(1 for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and e.name.startswith("aten::"))
    log(f"{title}: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%), idle "
        f"{100 - 100 * busy / wall_us:.1f}%, {len(kern)} kernel launches, "
        f"{host_ops} aten ops on the host (nested calls included)")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    for name, us in ranked[:10]:
        log(f"  {us / 1e3:9.2f} ms  {100 * us / busy:5.1f}%  {name[:90]}")
    # the port's own kernels below the first ten, with their launch counts
    ours = set(re.findall(r"^(\w+_kernel)\(", "".join(
        f.read_text() for f in _build.CSRC.glob("*.cu")), re.M))
    for name, us in ranked[10:]:
        base = re.search(r"::(\w+_kernel)<", name)
        if base and base.group(1) in ours:
            n = sum(1 for e in kern if e.name == name)
            log(f"  {us / 1e3:9.2f} ms  {100 * us / busy:5.1f}%  {name[:90]} "
                f"({n} launches)")


# ----------------------------------------------------------------------
# oracle phase
#: prefill positions the oracle compares (all of a 512-token prompt; the
#: last 512 of a longer one, whose logits over a 256,000 vocabulary would
#: take GBs on the host)
ORACLE_LAST = 512


def run_one(params, cfg, tokens, device, steps: int = 8, feed=None,
            cache_len: int = 1024, rt=None):
    """Prefill one prompt into a 1-slot pool, then ``steps`` decode steps
    fed with ``feed`` (or greedy).  Returns the logits (the prefill's last
    ``OracleLast`` positions, then one row a step) and the fed tokens."""
    pool = init_pool_cache(cfg, 1, cache_len, device=device, rt=rt)
    prompt = torch.tensor([tokens], dtype=torch.int32, device=device)
    logits, cache = T.prefill(params, {"tokens": prompt}, cfg,
                              cache_len=cache_len, rt=rt)
    scatter_slot(pool, cache, 0)
    out = [logits[0, -ORACLE_LAST:].float().cpu()]
    tok = int(torch.argmax(logits[0, -1]))
    fed = []
    for i in range(steps):
        tok = feed[i] if feed is not None else tok
        fed.append(tok)
        lg, pool = T.decode_step_slots(
            params, pool, {"tokens": torch.tensor([[tok]], dtype=torch.int32,
                                                  device=device)}, cfg, rt=rt)
        out.append(lg[0].float().cpu())
        tok = int(torch.argmax(lg[0, -1]))
    return out, fed


def oracle_phase(cfg, params, req, tol=(5e-2, 1e-3), cache_len=1024,
                 rt=None) -> None:
    """``req`` through ``params`` on the card in bf16 and in f32, fed the
    tokens the CPU run picked; logits within ``tol`` (bf16, f32) of max
    |logit| of the plain versions' on the CPU in f32 (the prefill's last
    ``ORACLE_LAST`` positions and every decode step)."""
    log(f"oracle phase: {cfg.arch_id} ({cfg.n_layers} layers"
        + (f", window_override {rt.window_override}" if rt else "")
        + f"), request {req.rid} ({len(req.tokens)} prompt tokens) on the "
        f"card vs the plain versions on the CPU (f32)")
    cpu_params = tree_map(lambda t: t.float().cpu(), params)
    cfg32 = cfg.with_(dtype="float32")
    kw = dict(cache_len=cache_len, rt=rt)
    t0 = time.perf_counter()
    want, fed = run_one(cpu_params, cfg32, req.tokens, "cpu", **kw)
    log(f"  CPU f32 run: {time.perf_counter() - t0:.1f} s")
    del cpu_params
    cases = (("card bf16", params, cfg, tol[0]),
             ("card f32", tree_map(lambda t: t.float(), params), cfg32,
              tol[1]))
    for name, p, c, rel in cases:
        got, _ = run_one(p, c, req.tokens, "cuda", feed=fed, **kw)
        for i, (g, w) in enumerate(zip(got, want)):
            scale = w.abs().max().item()
            err = (g - w).abs().max().item()
            what = "prefill" if i == 0 else f"decode step {i}"
            if i in (0, len(got) - 1):
                log(f"  {name} {what}: max |logit| {scale:.4g}, max abs err "
                    f"{err:.4g} ({err / scale:.3g} of max; tol {rel})")
            if not err <= rel * scale:
                raise AssertionError(f"{name} {what}: logits differ by "
                                     f"{err} (max |logit| {scale})")


# ----------------------------------------------------------------------
# ssm phases: Falcon-Mamba-7B at full width
def ssm_phases() -> dict:
    """The ssm serve phase on falcon-mamba-7b at full width and depth, its
    profiled run, then the oracle on a 2-layer model at full width.  Each
    model's weights are freed before the next is built."""
    cfg = get_config("falcon-mamba-7b")
    t0 = time.perf_counter()
    params = T.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg, device="cuda")
    torch.cuda.synchronize()
    n_par = sum(t.numel() for t in tree_leaves(params))
    log(f"ssm weights: {cfg.arch_id}, {cfg.n_layers} layers, {n_par} "
        f"parameters ({cfg.param_count} by the config's count, which "
        f"leaves out conv_b and dt_bias), "
        f"{sum(nbytes(t) for t in tree_leaves(params)) / 2 ** 30:.2f} GiB, "
        f"built in {time.perf_counter() - t0:.2f} s")
    served = serve_phase(cfg, params)
    served["oracle"] = serve_graph_oracle_phase(cfg, params, served)
    trace_phase(cfg, params)
    del params
    small = cfg.with_(n_layers=2)
    params = T.init_params(torch.Generator(device="cuda").manual_seed(0),
                           small, device="cuda")
    oracle_phase(small, params, served["first"],
                 tol=(TOL[torch.bfloat16], TOL[torch.float32]))
    del params
    return served


# ----------------------------------------------------------------------
# hybrid phases: RecurrentGemma-9B at full width
HYBRID_CFG = ServeConfig(n_slots=8, cache_len=3072, block_steps=8,
                         max_new_tokens=64)


def long_requests(cfg, n: int, lo: int, hi: int, max_new: int,
                  seed: int) -> list:
    """n requests at t=0 with prompt lengths drawn in [lo, hi] from
    ``seed``, request i's tokens from seed i."""
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(lo, hi + 1, (n,), generator=g).tolist()
    return [dataclasses.replace(poisson_requests(
        1, 0.0, prompt_len=n_tok, vocab_size=cfg.vocab_size, seed=seed + i,
        max_new=max_new)[0], rid=i) for i, n_tok in enumerate(lens)]


def build_params(cfg, what: str) -> dict:
    t0 = time.perf_counter()
    params = T.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg, device="cuda")
    torch.cuda.synchronize()
    leaves = tree_leaves(params)
    log(f"{what} weights: {cfg.arch_id}, {cfg.n_layers} layers, "
        f"{sum(t.numel() for t in leaves)} parameters, "
        f"{sum(nbytes(t) for t in leaves) / 2 ** 30:.2f} GiB, built in "
        f"{time.perf_counter() - t0:.2f} s")
    return params


def freeze_phase(cfg, params) -> dict:
    """The reference's freeze-and-resume scenario
    (``tests/test_serve_resilience.py``, recurrent state) on the card:
    slot 0 frozen at decode steps 3-5 (under and without the stall
    watchdog) must resume bit-identically -- the RG-LRU ``h`` and ``conv``
    held while frozen -- so both requests' tokens equal the clean run's.
    Replayed blocks (one graph per plan and engine), exact launches."""
    base = ServeConfig(n_slots=2, cache_len=cfg.rglru.local_window + 256,
                       block_steps=4, max_new_tokens=12)
    reqs = poisson_requests(2, 0.0, prompt_len=8, vocab_size=cfg.vocab_size,
                            seed=19)
    plan = FaultPlan(freeze_steps=(3, 4, 5), freeze_slots=(0,))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    engines = [ServeEngine(params, cfg, base, device="cuda")]
    clean = engines[0].serve(reqs)
    runs = {}
    for stall_blocks in (2, 0):
        eng = ServeEngine(params, cfg, dataclasses.replace(
            base, stall_blocks=stall_blocks), device="cuda")
        runs[stall_blocks] = eng.serve(reqs, fault_plan=plan)
        engines.append(eng)
    torch.cuda.synchronize()
    launches = read_counts()
    want = sum_counts(*(serve_launches(cfg, e) for e in engines))
    problems = []
    for stall_blocks, recs in runs.items():
        for r in reqs:
            if (recs[r.rid].state, recs[r.rid].tokens) != (
                    "completed", clean[r.rid].tokens):
                problems.append(f"stall_blocks {stall_blocks}, rid {r.rid}: "
                                f"{recs[r.rid].state} {recs[r.rid].tokens} vs "
                                f"clean {clean[r.rid].tokens}")
    if launches != want:
        problems.append(f"launches {launches}, want {want}")
    if [e.graph_stats["captures"] for e in engines] != [1, 1, 1]:
        problems.append(f"captures {[e.graph_stats for e in engines]}")
    log(f"hybrid freeze phase ({cfg.arch_id}, {cfg.n_layers} layers, full "
        f"width, {time.perf_counter() - t0:.1f} s): slot 0 frozen at steps "
        f"3-5, stall watchdog 2 and off: tokens identical to the clean run: "
        f"{not problems}; stalls detected "
        f"{[e.stats['stalls_detected'] for e in engines[1:]]}; launches "
        f"{launches}")
    if problems:
        raise AssertionError(f"hybrid freeze phase: {problems}")
    return dict(launches=launches)


def hybrid_phases() -> dict:
    """RecurrentGemma-9B at full width and depth (38 layers: 12 stacked
    (recurrent, recurrent, attention) groups and a tail of 2 recurrent
    layers; bf16, random weights from seed 0): the serve phase (16
    requests of 2,200-3,000 prompt tokens x 64 through 8 slots x 3,072, a
    ring of 2,048), its eager oracle and a profiled run; then at 5 layers
    (one group and the tail) and full width the freeze phase and the CPU
    oracle on a prompt of ~2,100 tokens."""
    cfg = get_config("recurrentgemma-9b")
    params = build_params(cfg, "hybrid")
    reqs = long_requests(cfg, 16, 2200, 3000, 64, seed=22)
    served = serve_phase(cfg, params, HYBRID_CFG, reqs)
    served["oracle"] = serve_graph_oracle_phase(cfg, params, served)
    trace_phase(cfg, params, HYBRID_CFG, reqs)
    del params
    gc.collect()
    small = cfg.with_(n_layers=5)
    params = build_params(small, "hybrid (5 layers)")
    served["freeze"] = freeze_phase(small, params)
    oracle_phase(small, params, long_requests(cfg, 1, 2100, 2100, 8,
                                              seed=23)[0],
                 cache_len=HYBRID_CFG.cache_len)
    del params
    gc.collect()
    return served


# ----------------------------------------------------------------------
# windowed dense phases: fedmm-base's sliding-window variant
WINDOW_RT = T.Runtime(window_override=8192)
WINDOW_CFG = ServeConfig(n_slots=4, cache_len=8704, block_steps=8,
                         max_new_tokens=32)


def window_phases() -> dict:
    """fedmm-base at full width and depth under ``Runtime(window_override=
    8192)``: 4 requests of 8,300-8,600 prompt tokens x 32 through 4 slots
    x 8,704 (a ring of 8,192), replayed blocks against eager ones, exact
    launches; positions run past the config's ``max_seq_len`` (4,096),
    which the reference does not enforce either.  Then the 2-layer oracle
    against the CPU."""
    cfg = get_config("fedmm-base")
    params = build_params(cfg, "windowed dense")
    reqs = long_requests(cfg, 4, 8300, 8600, 32, seed=24)
    served = serve_phase(cfg, params, WINDOW_CFG, reqs, WINDOW_RT)
    served["oracle"] = serve_graph_oracle_phase(cfg, params, served)
    top = max(len(r.tokens) for r in reqs) + 32
    if top <= cfg.max_seq_len:
        raise AssertionError("the windowed stream stays under max_seq_len")
    log(f"  positions up to {top - 1} against max_seq_len {cfg.max_seq_len}:"
        f" served")
    del params
    small = cfg.with_(n_layers=2)
    params = build_params(small, "windowed dense (2 layers)")
    oracle_phase(small, params, reqs[0], cache_len=WINDOW_CFG.cache_len,
                 rt=WINDOW_RT)
    del params
    gc.collect()
    return served


# ----------------------------------------------------------------------
# moe phases: Llama-4-Scout at full width, 12 of its 48 layers
SCOUT_LAYERS = 12
SCOUT_CFG = ServeConfig(n_slots=8, cache_len=8832, block_steps=8,
                        max_new_tokens=32)
#: reserved device memory the moe phases accept from earlier phases
FREE_LIMIT_GIB = 4.0


def free_device(what: str) -> None:
    """Drop what earlier phases left (models, engines and their captured
    graphs' private pools), print the memory still reserved, and raise if
    more than ``FREE_LIMIT_GIB`` is held."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    gib = 2 ** 30
    res = torch.cuda.memory_reserved() / gib
    log(f"before {what}: reserved {res:.3f} GiB, allocated "
        f"{torch.cuda.memory_allocated() / gib:.3f} GiB")
    if res > FREE_LIMIT_GIB:
        raise AssertionError(f"{res:.3f} GiB still reserved before {what}")


def scout_requests(cfg) -> list:
    """8 requests x 32 new tokens: six prompts of 8,300-8,700 tokens (every
    admission crosses the chunk boundary at 8,192, every decode step runs
    in the second chunk beside the first one's ring entries) and two of
    8,170-8,190 (their decode crosses position 8,192 mid-stream)."""
    long = long_requests(cfg, 6, 8300, 8700, 32, seed=25)
    edge = long_requests(cfg, 2, 8170, 8190, 32, seed=26)
    return long + [dataclasses.replace(r, rid=6 + i)
                   for i, r in enumerate(edge)]


def expert_share_phase(cfg, params, reqs) -> None:
    """Two admissions and one eager block of 8 decode steps under
    ``torch.profiler`` with shapes: the device time of the expert GEMMs
    (``aten::mm`` with a d_model x d_ff_expert weight: the routed and the
    shared experts) in the prefills and in the decode steps, beside the
    device time of the run.  Eager, so that the decode step's ops are seen
    on the host (a replay hides them)."""
    from torch.profiler import ProfilerActivity, profile
    scfg = dataclasses.replace(SCOUT_CFG, n_slots=2, max_new_tokens=9)
    two = [dataclasses.replace(r, max_new=9) for r in reqs[:2]]
    eng = ServeEngine(params, cfg, scfg, device="cuda", eager=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        eng.serve(two)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    expert = {(cfg.d_model, cfg.moe.d_ff_expert),
              (cfg.moe.d_ff_expert, cfg.d_model)}
    by = {"prefill": 0.0, "decode": 0.0}
    for e in prof.key_averages(group_by_input_shape=True):
        shapes = e.input_shapes or []
        if e.key != "aten::mm" or len(shapes) < 2 or \
                tuple(shapes[1]) not in expert:
            continue
        us = getattr(e, "device_time_total", None)
        us = e.cuda_time_total if us is None else us
        by["decode" if shapes[0][0] <= scfg.n_slots else "prefill"] += us
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    steps = eng.stats["block_dispatches"] * scfg.block_steps
    device_summary(prof, wall_us, f"expert share ({cfg.arch_id}, eager, "
                   f"{len(two)} admissions, {steps} decode steps of "
                   f"{scfg.n_slots} slots)")
    pre, dec = by["prefill"] / 1e3, by["decode"] / 1e3
    log(f"  expert GEMMs (routed and shared): prefill {pre:.2f} ms, decode "
        f"{dec:.2f} ms ({dec / max(1, steps):.3f} ms a step); "
        f"{100 * 1e3 * (pre + dec) / busy:.1f}% of the device's "
        f"{busy / 1e3:.1f} ms busy")


def moe_routes(params, cfg, tokens, device) -> tuple:
    """The routes of every position of ``tokens`` in a 1-layer moe model,
    from the port's own blocks over the whole sequence (``rms_norm``, the
    config's attention -- ``gqa_forward`` with its mask, or
    ``mla_forward`` --, ``rms_norm``, ``router_scores``): the chosen
    experts (T, k) in ascending order, the combine scores (T, E) and the
    router's margin at each position, the k-th largest probability less
    the (k+1)-th (what a flip of the top k turns on), all on the host."""
    bp = tree_map(lambda t: t[0], params["blocks"])
    x = params["embed"][torch.tensor(tokens, device=device).long()][None]
    h = rms_norm(x, bp["ln1"]["scale"], cfg.norm_eps)
    if cfg.mla is not None:
        x = x + mla_forward(bp["attn"], h, cfg)
    else:
        kind, window = T._attn_kind(cfg, T.Runtime())
        x = x + gqa_forward(bp["attn"], h, cfg, kind=kind, window=window)
    h = rms_norm(x, bp["ln2"]["scale"], cfg.norm_eps)
    scores, idx, _ = router_scores(bp["moe"], h, cfg)
    k, n_exp = cfg.moe.top_k, cfg.moe.num_experts
    probs = torch.softmax(h.float() @ bp["moe"]["router"]["w"].float(), -1)
    top = probs[0].topk(min(k + 1, n_exp), dim=-1).values
    gap = top[:, k - 1] - top[:, k] if k < n_exp else top[:, 0]
    return (idx[0].sort(dim=-1).values.cpu(), scores[0].float().cpu(),
            gap.cpu())


def with_decode_routes(fn) -> tuple:
    """``fn()`` with the moe router's choices at every one-position call
    (a decode step of a 1-layer model) recorded in ascending order: (its
    result, [experts (k,) a step]).  These are the decode path's own
    routes: a near tie can flip there where ``moe_routes``' forward over
    the whole sequence does not, and a decode step's logits follow them."""
    orig = moe_mod.router_scores
    routes = []

    def record(p, x, cfg):
        out = orig(p, x, cfg)
        if x.shape[1] == 1:
            routes.append(out[1][0, 0].sort().values.cpu())
        return out

    moe_mod.router_scores = record
    try:
        return fn(), routes
    finally:
        moe_mod.router_scores = orig


def prefill_kept(scores: torch.Tensor, cfg) -> torch.Tensor:
    """(T, E) bool: the (position, expert) pairs a prompt's prefill keeps,
    as ``moe._expert_block`` picks them: each expert its ``capacity``
    highest combine scores, equal scores by lower index, of the positions
    routed to it."""
    m = cfg.moe
    cap = _capacity(scores.shape[0], m.top_k, m.num_experts,
                    m.capacity_factor)
    order = torch.sort(scores, dim=0, descending=True, stable=True).indices
    keep = torch.zeros(scores.shape, dtype=torch.bool)
    keep.scatter_(0, order[:cap], True)
    return keep & (scores > 0)


def moe_oracle_phase(cfg, params, req, tol=(5e-2, 1e-3),
                     cache_len=SCOUT_CHUNK, f32_may_flip=False) -> None:
    """``req`` (and 8 fed decode steps) through a 1-layer moe model on the
    card in f32 and bf16 against the plain versions on the CPU in f32.
    Routing is discontinuous, so the experts of every position are read
    from the port's blocks on each side (``moe_routes`` for the prefill,
    the decode path's own router calls for the decode steps,
    ``with_decode_routes``): the logits of
    the positions that route to the same experts as on the CPU (and that
    those experts keep, or drop, as on the CPU: a flip elsewhere can push
    a prefill token past its expert's capacity) are held to ``tol[1]`` of
    max |logit| in f32 and ``tol[0]`` in bf16, and the flips counted and
    printed with the CPU router's margins.  Unless ``f32_may_flip`` (top-6
    of 160 experts has near-ties that f32 sums in another order can flip)
    the f32 run must route every position as on the CPU."""
    log(f"moe oracle phase: {cfg.arch_id} ({cfg.n_layers} layer, full "
        f"width), request {req.rid} ({len(req.tokens)} prompt tokens) + 8 "
        f"decode steps, cache_len {cache_len}, on the card vs the plain "
        f"versions on the CPU (f32)")
    cfg32 = cfg.with_(dtype="float32")
    t0 = time.perf_counter()
    cpu_params = tree_map(lambda t: t.float().cpu(), params)
    (want, fed), want_steps = with_decode_routes(lambda: run_one(
        cpu_params, cfg32, req.tokens, "cpu", cache_len=cache_len))
    seq = list(req.tokens) + fed
    want_routes, want_scores, gaps = moe_routes(cpu_params, cfg32, seq,
                                                "cpu")
    del cpu_params
    log(f"  CPU f32 run and routes: {time.perf_counter() - t0:.1f} s")
    n = len(req.tokens)
    m = cfg.moe
    cap = _capacity(n, m.top_k, m.num_experts, m.capacity_factor)
    want_keep = prefill_kept(want_scores[:n], cfg32)
    positions = [torch.arange(n - ORACLE_LAST, n)] + [
        torch.tensor([n + i]) for i in range(len(fed))]
    for name, p, c, rel in (
            ("card f32", tree_map(lambda t: t.float(), params), cfg32, tol[1]),
            ("card bf16", params, cfg, tol[0])):
        (got, _), steps = with_decode_routes(lambda: run_one(
            p, c, req.tokens, "cuda", feed=fed, cache_len=cache_len))
        routes, scores, _ = moe_routes(p, c, seq, "cuda")
        same = (routes == want_routes).all(dim=-1)
        for i, (r, w) in enumerate(zip(steps, want_steps)):
            same[n + i] = bool((r == w).all())    # the decode path's routes
        flipped = torch.nonzero(~same)[:, 0]
        drops = (prefill_kept(scores[:n], c) != want_keep).any(dim=-1) \
            & same[:n]                        # of the positions routed alike
        same[:n] &= ~drops
        if flipped.numel():
            g = gaps[flipped]
            log(f"  {name}: flipped positions {flipped[:12].tolist()}"
                f"{' ...' if flipped.numel() > 12 else ''}, the CPU "
                f"router's top-{m.top_k} margin there min {g.min():.3g}, "
                f"max {g.max():.3g} (over all positions: median "
                f"{gaps.median():.3g})")
        if c is cfg32 and flipped.numel() and not f32_may_flip:
            raise AssertionError(f"{name}: {flipped.numel()} positions route "
                                 f"to other experts than on the CPU")
        worst = 0.0
        for i, (g, w, pos) in enumerate(zip(got, want, positions)):
            keep = same[pos]
            scale = w.abs().max().item()
            err = ((g - w).abs()[keep].max().item() if keep.any() else 0.0)
            worst = max(worst, err / scale)
            if not err <= rel * scale:
                what = "prefill" if i == 0 else f"decode step {i}"
                raise AssertionError(f"{name} {what}: logits differ by {err}"
                                     f" (max |logit| {scale})")
        log(f"  {name}: {flipped.numel()} of {len(seq)} positions routed to "
            f"other experts than on the CPU, {int(drops.sum())} more kept "
            f"or dropped otherwise by a capacity of {cap}"
            f"; logits of the others within "
            f"{worst:.3g} of max |logit| (tol {rel}) over the prefill's last "
            f"{ORACLE_LAST} positions and {len(fed)} decode steps")


def scout_phases() -> dict:
    """Llama-4-Scout-17B-16E at full width, cut to 12 of its 48 layers
    (bf16, random weights from seed 0): the serve phase (8 requests of
    8,170-8,700 prompt tokens x 32 through 8 slots x 8,832, rings of
    8,192), its eager oracle, a profiled run and the expert GEMMs' share;
    then at 1 layer the CPU oracle with its routing check."""
    t0 = time.perf_counter()
    free_device("the moe phases")
    cfg = get_config("llama4-scout-17b-a16e").with_(n_layers=SCOUT_LAYERS)
    params = build_params(cfg, f"moe ({SCOUT_LAYERS} of "
                          f"{get_config(cfg.arch_id).n_layers} layers)")
    reqs = scout_requests(cfg)
    served = serve_phase(cfg, params, SCOUT_CFG, reqs)
    served["oracle"] = serve_graph_oracle_phase(cfg, params, served)
    trace_phase(cfg, params, SCOUT_CFG, reqs)
    expert_share_phase(cfg, params, reqs)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    small = cfg.with_(n_layers=1)
    params = build_params(small, "moe (1 layer)")
    moe_oracle_phase(small, params, long_requests(cfg, 1, 1000, 1000, 8,
                                                  seed=27)[0])
    del params
    gc.collect()
    served["phase_s"] = time.perf_counter() - t0
    log(f"moe phases: {served['phase_s']:.1f} s")
    return served


DEEPSEEK_LAYERS = 7
DEEPSEEK_CFG = ServeConfig(n_slots=8, cache_len=4352, block_steps=8,
                           max_new_tokens=32)


def host_free_gib() -> float:
    """MemAvailable of the host, GiB (``/proc/meminfo``)."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) / 2 ** 20
    return float("nan")


def deepseek_phases() -> dict:
    """DeepSeek-V2-236B at full width, cut to 7 of its 60 layers (bf16,
    random weights from seed 0): the serve phase (8 requests of
    1,000-4,200 prompt tokens x 32 through 8 slots x 4,352), its eager
    oracle and a profiled run; then at 1 layer the CPU oracle with its
    routing check (top-6 of 160: f32 may flip a near-tie, and is then held
    where it routes as the CPU)."""
    t0 = time.perf_counter()
    free_device("the MLA phases")
    full = get_config("deepseek-v2-236b")
    cfg = full.with_(n_layers=DEEPSEEK_LAYERS)
    params = build_params(cfg, f"moe with MLA ({DEEPSEEK_LAYERS} of "
                          f"{full.n_layers} layers)")
    gib = 2 ** 30
    per = {k: sum(nbytes(t) for t in tree_leaves(v)) / DEEPSEEK_LAYERS
           for k, v in params["blocks"].items()}
    outer = sum(nbytes(t) for k, v in params.items() if k != "blocks"
                for t in tree_leaves(v))
    layer = sum(per.values())
    log(f"  the cut: a layer holds {layer / gib:.3f} GiB (attention "
        f"{per['attn'] / gib:.3f}, MoE {per['moe'] / gib:.3f}: 160 routed "
        f"experts top-6 + 2 shared, the f32 router), embedding, norm and "
        f"head {outer / gib:.3f} GiB; {DEEPSEEK_LAYERS} layers "
        f"{(DEEPSEEK_LAYERS * layer + outer) / gib:.2f} GiB, all "
        f"{full.n_layers} {(full.n_layers * layer + outer) / gib:.1f} GiB "
        f"(sharding waits for the mesh slice)")
    reqs = long_requests(cfg, 8, 1000, 4200, 32, seed=28)
    served = serve_phase(cfg, params, DEEPSEEK_CFG, reqs)
    served["oracle"] = serve_graph_oracle_phase(cfg, params, served)
    # 4 admissions: each runs ~55,000 kernels that the profiler records
    trace_phase(cfg, params, DEEPSEEK_CFG, reqs[:4])
    del params
    gc.collect()
    torch.cuda.empty_cache()
    small = cfg.with_(n_layers=1)
    params = build_params(small, "moe with MLA (1 layer)")
    log(f"  host memory available before the oracle: {host_free_gib():.1f} "
        f"GiB (the CPU f32 copy of a layer takes ~20 GB)")
    moe_oracle_phase(small, params, long_requests(cfg, 1, 1000, 1000, 8,
                                                  seed=29)[0],
                     cache_len=1024, f32_may_flip=True)
    del params
    gc.collect()
    served["phase_s"] = time.perf_counter() - t0
    log(f"MLA phases: {served['phase_s']:.1f} s")
    return served


# ----------------------------------------------------------------------
# federation phases: the paper's round on fedmm-small at full width
def federation_phase(rounds: int = 2, lora_rank: int = 8,
                     n_layers: int = 0):
    """``rounds`` rounds of fedmm-small at full width (at full depth, or cut
    to ``n_layers``), geodora at ``lora_rank``; exact launch counts and
    finite records each round."""
    cfg = get_config("fedmm-small")
    if n_layers:
        cfg = cfg.with_(n_layers=n_layers)
    fcfg = FederationConfig(method="geodora", aggregation="precision",
                            rounds=rounds, lora_rank=lora_rank)
    log(f"federation phase: fedmm-small ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} KV, "
        f"{cfg.dtype}), geodora, precision aggregation, {fcfg.n_nodes} "
        f"nodes x {fcfg.local_steps} local steps, batch {fcfg.local_batch} "
        f"x {fcfg.n_tokens} tokens, {fcfg.anchors_per_class * fcfg.n_classes}"
        f" anchors, rank {fcfg.lora_rank}, {rounds} rounds")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fed = SequentialFederation(fcfg, cfg, device="cuda")
    torch.cuda.synchronize()
    log(f"  set-up {time.perf_counter() - t0:.3f} s (weights, tokenizers, "
        f"anchors, initial consensus)")
    attn = fed.frozen["blocks"]["attn"]
    n_lin = cfg.n_layers * sum(1 for lin in attn.values()
                               if lin.get("lora_A") is not None)
    steps, passes = fcfg.n_nodes * fcfg.local_steps, 2  # task and geo passes
    want = {"decode_attention": 0,
            "lora_matmul": steps * passes * n_lin * 2,   # forward and dx
            "flash_attention": steps * passes * cfg.n_layers,
            "gram": steps + fcfg.n_nodes,                # loss, then upload
            "selective_scan": 0, "mla_decode": 0}
    total = dict.fromkeys(want, 0)
    walls = []
    for r in range(rounds):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        rec = fed.run_round()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        got = read_counts()
        log(f"  round {r}: wall {walls[-1]:.3f} s, task {rec['task_loss']:.4f}"
            f", geo {rec['geo_loss']:.4f}, acc {rec['acc']:.3f}, cross-node "
            f"CKA {rec['cross_node_cka']:.4f}, weights "
            f"{[round(w, 4) for w in rec['weights']]}, uplink "
            f"{rec['uplink_bytes']} of {rec['full_model_bytes']} bytes; "
            f"launches {got}")
        if got != want:
            raise AssertionError(f"round {r}: kernel launches {got}, want "
                                 f"{want} ({n_lin} GeoLoRA linears)")
        values = [rec[k] for k in ("task_loss", "geo_loss", "acc",
                                   "cross_node_cka")] + rec["weights"]
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"round {r}: non-finite record {rec}")
        if not abs(sum(rec["weights"]) - 1.0) <= 1e-5:
            raise AssertionError(f"round {r}: weights sum to "
                                 f"{sum(rec['weights'])}")
        for k in total:
            total[k] += got[k]
    leaves = [t for n in fed.nodes for t in tree_leaves(n["trainable"])]
    if not all(bool(torch.isfinite(t).all()) for t in leaves + [fed.gbar]):
        raise AssertionError("non-finite trainables or consensus Gram")
    log(f"  launches per round as required: {want}")
    memory(f"the federation phase ({cfg.n_layers} layers, rank "
           f"{fcfg.lora_rank})")
    return fed, dict(launches=total, walls=walls)


def federation_trace_phase(fed) -> None:
    """One local step of node 0 under ``torch.profiler``, after the rounds
    above have run its shapes.  Its results are dropped: the state stays
    as the rounds left it."""
    from torch.profiler import ProfilerActivity, profile
    node = fed.nodes[0]
    tokens, labels, _ = fed._draw(0, node)
    anchors = fed.anchor_tokens[node["modality"]]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fed._local_step(node["trainable"], node["opt_state"], fed.frozen,
                        tokens, labels, anchors, fed.gbar)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    device_summary(prof, wall_us, "federation trace (one profiled local "
                   "step of node 0, forward, backward and AdamW)")


def federation_oracle_phase(fed) -> dict:
    """One local step of node 0 (the state after the rounds, one fresh
    batch) through the port's plain path on the CPU in f32, and on the
    card in bf16 and f32: losses, pooled activations and every gradient."""
    node = fed.nodes[0]
    tokens, labels, _ = fed._draw(0, node)
    anchors = fed.anchor_tokens[node["modality"]]
    cfg32 = fed.cfg.with_(dtype="float32")

    def step(device, cfg, cast):
        f = copy.copy(fed)
        f.cfg = cfg

        def move(t):
            return None if t is None else cast(t.detach().to(device))
        return f._grads(tree_map(move, node["trainable"]),
                        tree_map(move, fed.frozen), tokens.to(device),
                        labels.to(device), anchors.to(device),
                        fed.gbar.to(device))

    t0 = time.perf_counter()
    want_g, want_m = step("cpu", cfg32, lambda t: t.float())
    log(f"federation oracle: one local step of node 0 ({node['modality']}, "
        f"full depth {fed.cfg.n_layers} layers) on the card vs the plain "
        f"versions on the CPU in f32 ({time.perf_counter() - t0:.1f} s on "
        f"the CPU)")
    want_leaves = tree_leaves(want_g)
    errs = {}
    for name, cfg, cast, tol, gtol in (
            ("card bf16", fed.cfg, lambda t: t, 5e-2, 1e-1),
            ("card f32", cfg32, lambda t: t.float(), 1e-3, 1e-3)):
        got_g, got_m = step("cuda", cfg, cast)
        torch.cuda.synchronize()
        rel = {}
        for k in ("task", "geo", "pooled", "pooled_a"):
            w = want_m[k].float()
            rel[k] = ((got_m[k].float().cpu() - w).abs().max().item()
                      / max(w.abs().max().item(), 1e-30))
        grad = [((g.float().cpu() - w.float()).abs().max().item()
                 / max(w.float().abs().max().item(), 1e-30))
                for g, w in zip(tree_leaves(got_g), want_leaves)]
        rel["grads"] = max(grad)
        log(f"  {name}: task {got_m['task'].item():.6f} (CPU "
            f"{want_m['task'].item():.6f}), geo {got_m['geo'].item():.6f} "
            f"(CPU {want_m['geo'].item():.6f}); errors of max |value|: "
            + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
            + f" over {len(grad)} gradient leaves (tol {tol}, gradients "
            f"{gtol})")
        bad = {k: v for k, v in rel.items()
               if not v <= (gtol if k == "grads" else tol)}
        if bad:
            raise AssertionError(f"federation oracle {name}: {bad}")
        errs[name] = rel
    return errs


# ----------------------------------------------------------------------
# engine phases: the node-stacked round (Federation), replayed
def engine_launches(fed, rounds: int = 1) -> dict:
    """Launches of ``rounds`` stacked rounds by the design: per local step
    the task and anchor passes each run the trunk once over all K nodes'
    rows -- every GeoLoRA linear one forward and one dx launch, every layer
    one flash launch -- and the loss one gram launch over (K, Ba, D); the
    server one more gram launch."""
    cfg, fcfg = fed.cfg, fed.fed
    attn = fed.frozen["blocks"]["attn"]
    n_lin = cfg.n_layers * sum(1 for lin in attn.values()
                               if lin.get("lora_A") is not None)
    steps, passes = fcfg.local_steps, 2 + fed._has_bridges
    return {"decode_attention": 0,
            "lora_matmul": rounds * steps * passes * n_lin * 2,
            "flash_attention": rounds * steps * passes * cfg.n_layers,
            "gram": rounds * (steps + 1), "selective_scan": 0,
            "mla_decode": 0}


def check_record(what: str, rec: dict) -> None:
    values = [rec[k] for k in ("task_loss", "geo_loss", "acc",
                               "cross_node_cka")] + rec["weights"]
    if not all(math.isfinite(v) for v in values):
        raise AssertionError(f"{what}: non-finite record {rec}")
    if not abs(sum(rec["weights"]) - 1.0) <= 1e-5:
        raise AssertionError(f"{what}: weights sum to {sum(rec['weights'])}")


def engine_phase(rounds: int = 2, block: int = 2):
    """``Federation`` (the node-stacked round) on fedmm-small at full width
    and depth, geodora, precision aggregation, 4 nodes x 10 local steps:
    the round and the M-round block captured once each, then ``rounds``
    single rounds and one block replayed, each with exact launch counts,
    finite records, weights summing to 1 and one readback."""
    cfg = get_config("fedmm-small")
    fcfg = FederationConfig(method="geodora", aggregation="precision",
                            rounds=rounds)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fed = Federation(fcfg, cfg, device="cuda")
    torch.cuda.synchronize()
    log(f"engine phase: Federation on fedmm-small ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.dtype}), geodora, precision, "
        f"{fcfg.n_nodes} nodes x {fcfg.local_steps} local steps, batch "
        f"{fcfg.local_batch} x {fcfg.n_tokens}, rank {fcfg.lora_rank}; "
        f"buckets {[len(b) for b in fed._buckets]} of widths "
        f"{fed._bucket_widths}; set-up {time.perf_counter() - t0:.3f} s")
    want = engine_launches(fed)
    for m in (1, block):
        captured(f"the {m}-round graph (one eager warm-up, then the "
                 f"capture)", lambda: fed.capture(m))
        recorded = fed.engine.captured_launches(m)
        got = {name: recorded[fn.__name__] for name, fn in WRAPPERS.items()}
        log(f"  one replay of the {m}-round graph launches {got}")
        if got != {k: m * v for k, v in want.items()}:
            raise AssertionError(f"{m}-round graph records {got}, want "
                                 f"{m} x {want}")
    total = dict.fromkeys(want, 0)
    walls = []
    stats = fed.engine.stats
    for r in range(rounds):
        torch.cuda.synchronize()
        reset_counts()
        reads, replays = stats["readbacks"], stats["replays"]
        t0 = time.perf_counter()
        rec = fed.run_round()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        got = read_counts()
        log(f"  round {r} (replayed): wall {walls[-1]:.3f} s, task "
            f"{rec['task_loss']:.4f}, geo {rec['geo_loss']:.4f}, acc "
            f"{rec['acc']:.3f}, cross-node CKA {rec['cross_node_cka']:.4f}, "
            f"weights {[round(w, 4) for w in rec['weights']]}; launches "
            f"{got}")
        if got != want:
            raise AssertionError(f"engine round {r}: launches {got}, want "
                                 f"{want}")
        if (stats["readbacks"] - reads, stats["replays"] - replays) != (1, 1):
            raise AssertionError(f"engine round {r}: {stats} (one replay "
                                 f"and one readback expected)")
        check_record(f"engine round {r}", rec)
        for k in total:
            total[k] += got[k]
    torch.cuda.synchronize()
    reset_counts()
    reads, replays = stats["readbacks"], stats["replays"]
    t0 = time.perf_counter()
    recs = fed.run_rounds(block, block_size=block)
    torch.cuda.synchronize()
    block_wall = time.perf_counter() - t0
    got = read_counts()
    want_block = {k: block * v for k, v in want.items()}
    log(f"  block of {block} rounds (one replay): wall {block_wall:.3f} s, "
        f"task {[round(x['task_loss'], 4) for x in recs]}, launches {got}")
    if got != want_block:
        raise AssertionError(f"engine block: launches {got}, want "
                             f"{want_block}")
    if (stats["readbacks"] - reads, stats["replays"] - replays) != (1, 1):
        raise AssertionError(f"engine block: {stats} (one replay and one "
                             f"readback expected)")
    for i, x in enumerate(recs):
        check_record(f"engine block round {i}", x)
    leaves = [t for n in fed.nodes for t in tree_leaves(n["trainable"])]
    if not all(bool(torch.isfinite(t).all()) for t in leaves + [fed.gbar]):
        raise AssertionError("engine: non-finite trainables or consensus "
                             "Gram")
    log(f"  engine launches per round as required: {want}")
    memory("the engine phase")
    return fed, dict(launches=total, block_launches=got, walls=walls,
                     block_wall=block_wall)


def engine_trace_phase(fed) -> None:
    """One replayed round under ``torch.profiler``: wall, device busy share
    and launches (the sequential local step's are in the federation
    trace)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fed.run_round()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    device_summary(prof, wall_us, "engine trace (one replayed round of 4 "
                   "nodes x 10 local steps: staged draws, the replay, one "
                   "readback)")


def _state_errors(a_nodes, b_nodes) -> dict:
    """Per-leaf errors of the nodes' trainables: max |a - b| over max |b|,
    and ||a - b|| / ||b||, the worst leaf of each."""
    worst_max, worst_norm = 0.0, 0.0
    for na, nb in zip(a_nodes, b_nodes):
        for x, y in zip(tree_leaves(na["trainable"]),
                        tree_leaves(nb["trainable"])):
            x, y = x.float(), y.float()
            d = (x - y)
            worst_max = max(worst_max, d.abs().max().item()
                            / max(y.abs().max().item(), 1e-30))
            worst_norm = max(worst_norm, d.norm().item()
                             / max(y.norm().item(), 1e-30))
    return {"trainables (max)": worst_max, "trainables (norm)": worst_norm}


def _record_errors(a: dict, b: dict) -> dict:
    out = {k: abs(a[k] - b[k]) for k in ("task_loss", "geo_loss", "acc",
                                         "cross_node_cka")}
    out["weights"] = max(abs(x - y) for x, y in zip(a["weights"],
                                                    b["weights"]))
    return out


#: engine oracle limits: (records, trainables (norm)) by dtype.  f32 sums in
#: other orders only (~1e-6).  In bf16 the stacked trunk's activations round
#: at other points than the sequential round's (another tile plan, another
#: split of the K loop), and AdamW's first steps, u = g / (|g| + eps),
#: turn a gradient near 0 into +-1 of either sign: the records hold to a
#: bf16 tolerance, the trainables to a norm-wise one
ENGINE_TOL = {torch.bfloat16: (5e-2, 2.5e-1), torch.float32: (1e-3, 1e-3)}


def engine_oracle_phase() -> dict:
    """From one seed, one round through ``Federation`` (replayed) and one
    through ``SequentialFederation`` on the card, in bf16 and in f32:
    records and trainables within ``ENGINE_TOL``.  Then, in bf16, one
    eager round of the engine against its replay from the same state and
    the same draws."""
    base = get_config("fedmm-small")
    fcfg = FederationConfig(method="geodora", aggregation="precision")
    errs = {}
    for dtype, cfg in ((torch.bfloat16, base),
                       (torch.float32, base.with_(dtype="float32"))):
        tol_rec, tol_state = ENGINE_TOL[dtype]
        t0 = time.perf_counter()
        seq = SequentialFederation(fcfg, cfg, device="cuda")
        want = seq.run_round()
        eng = Federation(fcfg, cfg, device="cuda")
        got = eng.run_round()
        torch.cuda.synchronize()
        err = dict(_record_errors(got, want), **_state_errors(eng.nodes,
                                                               seq.nodes))
        log(f"engine oracle ({dtype}, one round from seed {fcfg.seed}, "
            f"{time.perf_counter() - t0:.1f} s): Federation (replayed) vs "
            f"SequentialFederation: " + ", ".join(
                f"{k} {v:.3g}" for k, v in err.items())
            + f" (tol: records {tol_rec}, trainables (norm) {tol_state})")
        bad = {k: v for k, v in err.items() if k != "trainables (max)"
               and not v <= (tol_state if k.startswith("trainables")
                             else tol_rec)}
        if bad:
            raise AssertionError(f"engine oracle {dtype}: {bad}")
        errs[str(dtype)] = err
        del seq
        gc.collect()
        if dtype != torch.bfloat16:
            continue
        # eager against replay, from the state the round left
        gens = [n["gen"] for n in eng._nodes]
        g_saved = [g.get_state() for g in gens]
        state = eng._state()
        saved = [t.clone() for t in tree_leaves(state)]
        batches = eng._stage(1)
        _, eager = eng.engine.run_block(state, 1, statics=eng._statics,
                                        batches=batches, eager=True)
        eager_state = [t.clone() for t in tree_leaves(state)]
        for t, v in zip(tree_leaves(state), saved):
            t.copy_(v)
        for g, st in zip(gens, g_saved):
            g.set_state(st)
        _, replay = eng.engine.run_block(state, 1, statics=eng._statics,
                                         batches=eng._stage(1))
        rec_err = max(max(abs(x - y) for x, y in zip(
            (eager[0][k] if isinstance(eager[0][k], list) else [eager[0][k]]),
            (replay[0][k] if isinstance(replay[0][k], list)
             else [replay[0][k]]))) for k in eager[0])
        state_err = max((a.float() - b.float()).abs().max().item()
                        / max(b.float().abs().max().item(), 1e-30)
                        for a, b in zip(tree_leaves(state), eager_state))
        log(f"engine oracle (bf16): eager round vs its replay from the same "
            f"state and draws: records max |diff| {rec_err:.3g}, state max "
            f"|diff| of max |value| {state_err:.3g} (tol {tol_rec}, "
            f"{tol_state})")
        if not (rec_err <= tol_rec and state_err <= tol_state):
            raise AssertionError(f"engine eager vs replay: {rec_err}, "
                                 f"{state_err}")
        errs["eager vs replay"] = dict(records=rec_err, state=state_err)
        del eng
        gc.collect()                  # the engine and its graphs
    return errs


# ----------------------------------------------------------------------
# participation phases: sampled cohorts and async rounds on the engine
PART_NODES = 8                 # 4 modalities x 2: 4 width buckets of 2 nodes
UNIFORM = ParticipationPlan(strategy="uniform", cohort_size=4, seed=0)
PRECISION = ParticipationPlan(strategy="precision", cohort_size=4, seed=1)
DROPOUT = ParticipationPlan(strategy="dropout", dropout_rate=0.25, seed=2)
ASYNC = ParticipationPlan(strategy="async", lag_dist="geometric", lag_p=0.5,
                          max_lag=3, transient_rate=0.2, crash_rate=0.1,
                          rejoin_rate=0.5, poison_nodes=(1,), seed=3)


def part_federation(n_layers: int = 0, dtype: str = "") -> Federation:
    """``Federation`` on fedmm-small at full width (cut to ``n_layers``,
    cast to ``dtype`` where given), geodora, precision aggregation, 8
    nodes x 10 local steps, batch 32 x 16, rank 8."""
    cfg = get_config("fedmm-small")
    if n_layers:
        cfg = cfg.with_(n_layers=n_layers)
    if dtype:
        cfg = cfg.with_(dtype=dtype)
    return Federation(FederationConfig(method="geodora",
                                       aggregation="precision",
                                       n_nodes=PART_NODES), cfg,
                      device="cuda")


def _node_rows(fed) -> dict:
    """Per node: clones of its local adapters and of its AdamW state (both
    moments, step, round) -- what a round must not touch on a node that
    sits it out."""
    out = {}
    for i, (b, r) in fed._node_bucket.items():
        out[i] = ([fed._trains[b][k]["w"][r].clone() for k in LOCAL_KEYS
                   if k in fed._trains[b]]
                  + [t[r].clone() for t in tree_leaves(fed._opts[b])])
    return out


def _shipped_leaves(fed, b: int) -> list:
    out = []
    tree_map(lambda l, m: out.append(l) if l is not None and m else None,
             fed._trains[b], fed.engine.shipped_masks[b])
    return out


def check_part_block(what: str, fed, plan, recs, before, prev_q) -> list:
    """Every record of a block under ``plan``: finite, weights summing to
    1 (or 0 where an async round delivers nothing) and zero off the
    reporters; a static cohort's size and per-bucket split; the async
    events (staleness >= 0 exactly where delivered; each poisoned node
    quarantined once in every round it starts).  Then the state: the
    nodes that sat out every round unchanged bit for bit, the shipped
    leaves equal on every node, every trainable and the consensus Gram
    finite.  Returns the quarantine counts after the block."""
    k = fed.fed.n_nodes
    for j, rec in enumerate(recs):
        tag = f"{what} round {j}"
        values = [rec[x] for x in ("task_loss", "geo_loss", "acc",
                                   "cross_node_cka")] + rec["weights"]
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"{tag}: non-finite record {rec}")
        total = sum(rec["weights"])
        sums = (0.0, 1.0) if plan.strategy == "async" else (1.0,)
        if min(abs(total - x) for x in sums) > 1e-5:
            raise AssertionError(f"{tag}: weights sum to {total}")
        reporters = (rec["delivered"] if plan.strategy == "async"
                     else rec["participation"])
        if any(w != 0.0 for w, p in zip(rec["weights"], reporters) if not p):
            raise AssertionError(f"{tag}: weight off the reporters {rec}")
        if plan.strategy in ("uniform", "precision"):
            split = allocate_cohort(plan.cohort_size,
                                    [len(m) for m in fed._buckets])
            got = [sum(rec["participation"][i] for i in m)
                   for m in fed._buckets]
            if rec["cohort_size"] != plan.cohort_size or got != list(split):
                raise AssertionError(f"{tag}: cohort {rec['participation']}"
                                     f", want {split} per bucket")
        if plan.strategy == "async":
            if any((s >= 0) != (d == 1.0) for s, d in zip(
                    rec["staleness"], rec["delivered"])):
                raise AssertionError(f"{tag}: staleness {rec['staleness']} "
                                     f"vs delivered {rec['delivered']}")
            for i in plan.poison_nodes:
                if rec["quarantined"][i] != prev_q[i] + rec[
                        "participation"][i]:
                    raise AssertionError(
                        f"{tag}: node {i} quarantined "
                        f"{rec['quarantined'][i]} after {prev_q[i]}, "
                        f"started {rec['participation'][i]}")
            prev_q = rec["quarantined"]
    sat_out = [i for i in range(k)
               if not any(r["participation"][i] for r in recs)]
    after = _node_rows(fed)
    for i in sat_out:
        if not all(torch.equal(a, b) for a, b in zip(after[i], before[i])):
            raise AssertionError(f"{what}: node {i} sat out and its local "
                                 f"leaves or moments moved")
    first = [l[0] for l in _shipped_leaves(fed, 0)]
    for b in range(len(fed._buckets)):
        for l, f in zip(_shipped_leaves(fed, b), first):
            if not bool((l == f).all()):
                raise AssertionError(f"{what}: shipped leaves differ "
                                     f"across nodes (bucket {b})")
    leaves = tree_leaves(fed._trains) + [fed.gbar]
    if not all(bool(torch.isfinite(t).all()) for t in leaves):
        raise AssertionError(f"{what}: non-finite trainables or consensus "
                             f"Gram")
    log(f"  {what}: checks passed ({len(sat_out)} nodes sat out every "
        f"round, bit for bit unchanged)")
    return prev_q


def participation_phase(fed, plan, name: str, rounds: int = 2,
                        block: int = 2) -> dict:
    """``plan`` on ``fed``: the round graph (and the ``block``-round graph)
    captured outside the counted window, then ``rounds`` replayed rounds
    and one replayed block, each with exact launch counts (the engine
    round's: one trunk pass over the cohort's -- or, masked, all nodes'
    -- rows per pass), one replay and one readback, and
    ``check_part_block``."""
    want = engine_launches(fed)
    caps = []
    torch.cuda.reset_peak_memory_stats()
    for m in (1, block) if block else (1,):
        caps.append(captured(f"the {m}-round graph ({name})",
                             lambda: fed.capture(m, participation=plan)))
        recorded = fed.engine.captured_launches(m, plan)
        got = {n: recorded[fn.__name__] for n, fn in WRAPPERS.items()}
        log(f"  {name}: one replay of the {m}-round graph launches {got}")
        if got != {k: m * v for k, v in want.items()}:
            raise AssertionError(f"{name}: {m}-round graph records {got}, "
                                 f"want {m} x {want}")
    stats = fed.engine.stats
    prev_q = [0.0] * fed.fed.n_nodes

    def run(m: int, tag: str):
        nonlocal prev_q
        before = _node_rows(fed)
        torch.cuda.synchronize()
        reset_counts()
        reads, replays = stats["readbacks"], stats["replays"]
        t0 = time.perf_counter()
        recs = fed.run_rounds(m, block_size=m, participation=plan)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counts()
        log(f"  {name} {tag}: wall {wall:.3f} s, task "
            f"{[round(r['task_loss'], 4) for r in recs]}, participation "
            f"{[r['participation'] for r in recs]}, weights "
            f"{[[round(w, 4) for w in r['weights']] for r in recs]}"
            + ("".join(f", {x} {[r[x] for r in recs]}" for x in (
                "delivered", "staleness", "quarantined"))
               if plan.strategy == "async" else "") + f"; launches {got}")
        if got != {k: m * v for k, v in want.items()}:
            raise AssertionError(f"{name} {tag}: launches {got}, want "
                                 f"{m} x {want}")
        if (stats["readbacks"] - reads, stats["replays"] - replays) != (1, 1):
            raise AssertionError(f"{name} {tag}: {stats} (one replay and "
                                 f"one readback expected)")
        prev_q = check_part_block(f"{name} {tag}", fed, plan, recs, before,
                                  prev_q)
        return got, wall

    total, walls = dict.fromkeys(want, 0), []
    for r in range(rounds):
        got, wall = run(1, f"round {r} (replayed)")
        walls.append(wall)
        total = sum_counts(total, got)
    out = dict(launches=total, walls=walls, capture_s=caps)
    if block:
        out["block_launches"], out["block_wall"] = run(
            block, f"block of {block} rounds (one replay)")
    if any(prev_q[i] < 1 for i in plan.poison_nodes):
        raise AssertionError(f"{name}: a poisoned node never started, so "
                             f"the quarantine guard was not tried")
    out["memory"] = memory(f"the participation phase ({name})")
    return out


def participation_trace_phase(fed, plan, name: str) -> None:
    """One replayed round under ``plan`` with ``torch.profiler``: wall,
    device busy share and launches."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fed.run_rounds(1, participation=plan)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    device_summary(prof, wall_us, f"participation trace ({name}, one "
                   f"replayed round of {fed.fed.n_nodes} nodes x "
                   f"{fed.fed.local_steps} local steps: staged draws and "
                   f"uniforms, the replay, one readback)")


def _snapshot(fed, plan) -> tuple:
    return ([t.clone() for t in tree_leaves(fed._state(plan))],
            [n["gen"].get_state() for n in fed._nodes],
            fed._part_gen.get_state())


def _restore(fed, plan, snap) -> None:
    tensors, gens, part_gen = snap
    for t, v in zip(tree_leaves(fed._state(plan)), tensors):
        t.copy_(v)
    for n, st in zip(fed._nodes, gens):
        n["gen"].set_state(st)
    fed._part_gen.set_state(part_gen)


def participation_oracle_phase() -> dict:
    """At 2 layers in f32, 8 nodes, from one seed: one ``uniform`` C 4
    round and (afresh) one ``async`` round, each replayed and held against
    (1) an eager run of the same round from the same state, draws and
    uniforms: records and state bit-identical; (2) the same round through
    ``SequentialFederation`` on the card: cohorts and events exact,
    records and trainables within ``ENGINE_TOL`` (f32)."""
    tol_rec, tol_state = ENGINE_TOL[torch.float32]
    errs = {}
    for plan in (UNIFORM, ASYNC):
        t0 = time.perf_counter()
        fed = part_federation(n_layers=2, dtype="float32")
        seq = SequentialFederation(fed.fed, fed.cfg, device="cuda")
        fed.capture(1, participation=plan)
        snap = _snapshot(fed, plan)
        state = fed._state(plan)
        batches, uniforms, _ = fed._stage_part(1, plan)
        _, eager = fed.engine.run_block(state, 1, statics=fed._statics,
                                        batches=batches, plan=plan,
                                        uniforms=uniforms, eager=True)
        eager_state = [t.clone() for t in tree_leaves(state)]
        _restore(fed, plan, snap)
        got = fed.run_rounds(1, participation=plan)[0]
        same_state = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(fed._state(plan)), eager_state))
        if fed._metrics_record(eager[0]) != got or not same_state:
            raise AssertionError(f"participation oracle ({plan.strategy}): "
                                 f"eager and replayed rounds differ "
                                 f"(state equal: {same_state})")
        want = seq.run_rounds(1, participation=plan)[0]
        torch.cuda.synchronize()
        keys = ("participation", "cohort_size") + (
            ("delivered", "staleness", "quarantined", "n_delivered")
            if plan.strategy == "async" else ())
        if any(got[x] != want[x] for x in keys):
            raise AssertionError(f"participation oracle ({plan.strategy}): "
                                 f"cohort or events differ: "
                                 f"{[(x, got[x], want[x]) for x in keys]}")
        err = dict(_record_errors(got, want), **_state_errors(fed.nodes,
                                                               seq.nodes))
        log(f"participation oracle ({plan.strategy}, 2 layers, f32, "
            f"{time.perf_counter() - t0:.1f} s): replay == eager bit for "
            f"bit; vs SequentialFederation: participation "
            f"{got['participation']} (equal), " + ", ".join(
                f"{k} {v:.3g}" for k, v in err.items())
            + f" (tol: records {tol_rec}, trainables (norm) {tol_state})")
        bad = {k: v for k, v in err.items() if k != "trainables (max)"
               and not v <= (tol_state if k.startswith("trainables")
                             else tol_rec)}
        if bad:
            raise AssertionError(f"participation oracle {plan.strategy}: "
                                 f"{bad}")
        errs[plan.strategy] = err
        del fed, seq
        gc.collect()                  # the engine and its graph
    return errs


# ----------------------------------------------------------------------
# memory: peaks since the last reset, and what a capture's pool adds
def memory(what: str) -> dict:
    """Print and return the peak allocated and reserved device memory since
    the last ``torch.cuda.reset_peak_memory_stats()``, and the reserved
    memory now (GiB)."""
    gib = 2 ** 30
    out = dict(peak_allocated_gib=torch.cuda.max_memory_allocated() / gib,
               peak_reserved_gib=torch.cuda.max_memory_reserved() / gib,
               reserved_gib=torch.cuda.memory_reserved() / gib)
    log(f"  memory after {what}: peak allocated "
        f"{out['peak_allocated_gib']:.3f} GiB, peak reserved "
        f"{out['peak_reserved_gib']:.3f} GiB, reserved now "
        f"{out['reserved_gib']:.3f} GiB")
    return out


def captured(what: str, capture) -> float:
    """Run ``capture()``; print its seconds, the reserved memory it added
    (the graph's private pool and the warm-up's blocks) and the peaks."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    capture()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    added = (torch.cuda.memory_reserved() - before) / 2 ** 30
    log(f"  captured {what} in {secs:.3f} s; reserved memory +{added:.3f} "
        f"GiB")
    memory(f"capturing {what}")
    return secs


# ----------------------------------------------------------------------
# checkpoint phases: in-block checkpoints, kill and resume, on the card
CKPT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"


def _live(fed, plan) -> tuple:
    """Clones of the state tensors, and every generator's state."""
    part_gen = getattr(fed, "_part_gen", None)
    return ([t.clone() for t in tree_leaves(fed._state(plan))],
            [n["gen"].get_state() for n in fed._nodes]
            + ([] if part_gen is None else [part_gen.get_state()]))


def _same(a, b) -> bool:
    return all(len(x) == len(y) and all(torch.equal(u, v)
                                        for u, v in zip(x, y))
               for x, y in zip(a, b))


def checkpoint_phase(name: str, make, plan) -> dict:
    """``make()`` (a ``Federation``) runs 4 rounds in blocks of 2 with a
    checkpoint after every round (design (a): each block of 2 runs as two
    sub-blocks of 1, so 4 replays, 4 readbacks, 4 files at steps 1-4, with
    exact launches); then ``ck_2`` is restored into the same federation
    (in place: no capture, the same tensors) and into a fresh one, each
    followed by 2 rounds that must end in the uninterrupted run's state
    and generators bit for bit."""
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    fed = make()
    log(f"checkpoint phase ({name}): Federation on fedmm-small "
        f"({fed.cfg.n_layers} layers, {fed.cfg.dtype}), {fed.fed.n_nodes} "
        f"nodes, buckets {[len(b) for b in fed._buckets]}")
    stats = fed.engine.stats
    caps = [captured(f"the 1-round graph ({name})",
                     lambda: fed.capture(1, participation=plan))]
    want = engine_launches(fed)
    out_dir = CKPT_DIR / f"ck_{name.split()[0]}"
    shutil.rmtree(out_dir, ignore_errors=True)
    path = str(out_dir / "ck_{step}.npz")
    before = dict(stats)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    recs = fed.run_rounds(4, block_size=2, participation=plan,
                          checkpoint_path=path, checkpoint_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    delta = {k: stats[k] - before[k] for k in stats}
    files = sorted(p.name for p in out_dir.iterdir())
    writes = list(fed.checkpoint_writes)      # the resume below adds more
    log(f"  4 rounds, blocks of 2, a checkpoint every round: wall "
        f"{wall:.3f} s, task {[round(r['task_loss'], 4) for r in recs]}, "
        f"engine {delta}, files {files}, sizes "
        f"{[w['bytes'] for w in writes]} bytes, write seconds "
        f"{[round(w['seconds'], 4) for w in writes]}; launches {got}")
    if got != {k: 4 * v for k, v in want.items()}:
        raise AssertionError(f"checkpoint {name}: launches {got}, want 4 x "
                             f"{want}")
    if delta != {"captures": 0, "replays": 4, "readbacks": 4}:
        raise AssertionError(f"checkpoint {name}: engine {delta}, want 4 "
                             f"replays, 4 readbacks, no capture")
    if files != [f"ck_{s}.npz" for s in (1, 2, 3, 4)] or \
            [w["step"] for w in writes] != [1, 2, 3, 4]:
        raise AssertionError(f"checkpoint {name}: files {files}")
    for r in recs:
        if not all(math.isfinite(r[k]) for k in ("task_loss", "geo_loss")):
            raise AssertionError(f"checkpoint {name}: non-finite {r}")
    final = _live(fed, plan)
    ck2 = path.format(step=2)

    # kill after round 2, restore in place: the same tensors, no capture
    ptrs = [t.data_ptr() for t in tree_leaves(fed._state(plan))]
    t0 = time.perf_counter()
    step = fed.restore(ck2)
    restore_s = time.perf_counter() - t0
    del fed.history[2:]
    caps_before = stats["captures"]
    fed.run_rounds(2, block_size=2, participation=plan,
                   checkpoint_path=str(out_dir / "again_{step}.npz"),
                   checkpoint_every=1)
    same_ptrs = ptrs == [t.data_ptr() for t in tree_leaves(
        fed._state(plan))]
    in_place = _same(_live(fed, plan), final)
    log(f"  restore of ck_2 in place: step {step}, {restore_s:.3f} s, "
        f"captures after it {stats['captures'] - caps_before}, same tensors "
        f"{same_ptrs}; 2 rounds later the state and generators equal the "
        f"uninterrupted run's: {in_place}")
    if step != 2 or stats["captures"] != caps_before or not same_ptrs \
            or not in_place:
        raise AssertionError(f"checkpoint {name}: in-place resume differs")
    mem = memory(f"the checkpointed run ({name})")
    del fed
    gc.collect()

    # restore into a fresh federation (same seeds)
    fresh = make()
    caps.append(captured(f"the 2-round graph ({name}, fresh federation)",
                         lambda: fresh.capture(2, participation=plan)))
    fresh.restore(ck2)
    fresh.run_rounds(2, block_size=2, participation=plan)
    resumed = _same(_live(fresh, plan), final)
    log(f"  restore of ck_2 into a fresh federation, then one block of 2: "
        f"state and generators equal the uninterrupted run's: {resumed}; "
        f"engine {fresh.engine.stats}")
    if not resumed or fresh.engine.stats != {"captures": 1, "replays": 1,
                                             "readbacks": 1}:
        raise AssertionError(f"checkpoint {name}: fresh resume differs")
    del fresh
    gc.collect()
    shutil.rmtree(out_dir, ignore_errors=True)
    return dict(launches=got, wall=wall, capture_s=caps, memory=mem,
                file_bytes=[w["bytes"] for w in writes],
                write_s=[w["seconds"] for w in writes],
                phase_s=time.perf_counter() - t_phase)


def checkpoint_phases() -> dict:
    """The checkpoint phase under no plan (4 nodes, full depth), ``uniform``
    C 4 (8 nodes, full depth) and ``async`` (8 nodes, 2 layers)."""
    def four():
        return Federation(FederationConfig(method="geodora",
                                           aggregation="precision"),
                          get_config("fedmm-small"), device="cuda")
    return {"none": checkpoint_phase("none (4 nodes)", four, None),
            "uniform": checkpoint_phase("uniform C 4 (8 nodes)",
                                        part_federation, UNIFORM),
            "async": checkpoint_phase("async (8 nodes, 2 layers)",
                                      lambda: part_federation(n_layers=2),
                                      ASYNC)}


# ----------------------------------------------------------------------
# the LM training driver (repro_torch.launch.train)
DRIVER_ARGV = ["--arch", "fedmm-small", "--device", "cuda"]   # the defaults


def driver_launches(args, cfg) -> dict:
    """Launches of one driver round by the design: per local step a task
    pass over the cohort's B x S-token sequences and an anchor pass over
    its copies of the anchors, each running the trunk once over all the
    cohort's rows -- every attention linear (wq, wk, wv, wo) one forward
    launch, and one dx launch wherever its input needs a gradient, which
    is all but layer 0's wq, wk and wv (their input is the frozen
    embedding); one flash launch per layer -- and one gram launch on the
    (K, A, d) anchors; the server one more gram launch."""
    n_lin = 4 * cfg.n_layers
    steps = args.local_steps
    return {"decode_attention": 0,
            "lora_matmul": steps * 2 * (n_lin + n_lin - 3),
            "flash_attention": steps * 2 * cfg.n_layers,
            "gram": steps + 1, "selective_scan": 0, "mla_decode": 0}


def _random_block(run, args, m: int, seed: int = 0):
    """Batches and uniforms of the driver's block shapes, random tokens
    from a generator of their own (the streams do not move): a capture's
    warm-up inputs, or the oracle's."""
    k = args.nodes
    g = torch.Generator(device="cuda").manual_seed(seed)
    b = make_lm_batch(g, run.cfg, m * args.local_steps * k * args.batch,
                      args.seq)
    block = {name: v.reshape(m, args.local_steps, k, args.batch, args.seq)
             for name, v in b.items()}
    uniforms = None
    if run.part_gen is not None:
        uniforms = torch.rand((m, n_uniforms(run.plan), k), generator=g,
                              device="cuda")
    return (block,), uniforms


def driver_phase(name: str, argv: list, rounds: int = 4) -> dict:
    """``repro_torch.launch.train`` (``parse_args``, ``build``, ``Trainer``:
    ``main``'s body) on fedmm-small at full width and depth with the
    default flags plus ``argv``: the block graph captured outside the
    counted window, then ``rounds`` rounds in blocks (the next block
    staged while the card runs this one), with exact launches, one replay
    and one readback per block and finite losses; then 2 more blocks under
    ``torch.profiler``: busy share and top device operations."""
    torch.cuda.reset_peak_memory_stats()
    args = train.parse_args(DRIVER_ARGV + argv)
    m = int(args.block_size)
    t0 = time.perf_counter()
    run = train.build(args)
    trainer = train.Trainer(run, args)
    build_s = time.perf_counter() - t0
    log(f"driver phase ({name}): {run.cfg.arch_id} ({run.cfg.n_layers} "
        f"layers, d_model {run.cfg.d_model}, vocab {run.cfg.vocab_size}, "
        f"{run.cfg.dtype}), {args.method}, {args.nodes} nodes x "
        f"{args.local_steps} local steps, batch {args.batch} x {args.seq}, "
        f"{args.anchors} anchors, rank {args.rank}, blocks of {m}; build "
        f"{build_s:.3f} s (weights; the streams start on first use)")
    stats = run.engine.stats
    dummy, dummy_u = _random_block(run, args, m)
    cap = captured(f"the {m}-round driver graph ({name})",
                   lambda: run.engine.capture(m, run.state, (None,), dummy,
                                              plan=run.plan,
                                              uniforms=dummy_u))
    per_round = driver_launches(args, run.cfg)
    recorded = run.engine.captured_launches(m, run.plan)
    rec = {n: recorded[fn.__name__] for n, fn in WRAPPERS.items()}
    if rec != {k: m * v for k, v in per_round.items()}:
        raise AssertionError(f"driver {name}: the graph records {rec}, want "
                             f"{m} x {per_round}")
    before = dict(stats)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    final = trainer.train(rounds, m)
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    got = read_counts()
    delta = {k: stats[k] - before[k] for k in stats}
    recs = list(trainer.records)
    log(f"  {rounds} rounds in blocks of {m} (the streams start inside): "
        f"wall {first_wall:.3f} s, final task {final:.4f}, engine {delta}; "
        f"launches {got}")
    if got != {k: rounds * v for k, v in per_round.items()}:
        raise AssertionError(f"driver {name}: launches {got}, want "
                             f"{rounds} x {per_round}")
    if delta != {"captures": 0, "replays": rounds // m,
                 "readbacks": rounds // m}:
        raise AssertionError(f"driver {name}: engine {delta}, want one "
                             f"replay and one readback per block")
    if not all(math.isfinite(v) for r in recs
               for v in r["task"] + r["geo"] + r["weights"]):
        raise AssertionError(f"driver {name}: non-finite records")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(2 * rounds, m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    trainer.stage(m)
    stage_block_s = time.perf_counter() - t0
    log(f"  {2 * rounds} more rounds (streams started): wall {wall:.3f} s, "
        f"{wall / (2 * rounds):.3f} s a round; host staging of one block "
        f"alone {stage_block_s:.3f} s")
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train(2 * m, m)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    device_summary(prof, wall_us, f"driver trace ({name}, 2 blocks of {m} "
                   f"rounds: the first block's staging, then each replay "
                   f"with the next block staged meanwhile; host staging of "
                   f"a block alone {stage_block_s:.3f} s)")
    mem = memory(f"the driver phase ({name})")
    del run, trainer
    gc.collect()
    return dict(launches=got, per_round=per_round, first_wall=first_wall,
                wall=wall, round_s=wall / (2 * rounds), capture_s=cap,
                stage_s=stage_block_s, memory=mem)


def driver_oracle_phase() -> None:
    """At 2 layers in f32 (full width), a block of 2 driver rounds replayed
    and the same block run eagerly from the same state and batches: the
    records and the state bit for bit, under full participation and
    ``uniform`` C 2.  The graph is captured on other batches and
    uniforms, so the replay must read the ones staged for it."""
    for extra in ([], ["--participation", "uniform", "--cohort-size", "2"]):
        args = train.parse_args(DRIVER_ARGV + extra)
        cfg = train.model_config(args).with_(n_layers=2, dtype="float32")
        run = train.build(args, cfg=cfg)
        warm, warm_u = _random_block(run, args, 2, seed=1)
        run.engine.capture(2, run.state, (None,), warm, plan=run.plan,
                           uniforms=warm_u)
        batches, uniforms = _random_block(run, args, 2, seed=2)
        start = [t.clone() for t in tree_leaves(run.state)]
        _, replayed = run.engine.run_block(run.state, 2, statics=(None,),
                                           batches=batches, plan=run.plan,
                                           uniforms=uniforms)
        after = [t.clone() for t in tree_leaves(run.state)]
        for t, v in zip(tree_leaves(run.state), start):
            t.copy_(v)
        _, eager = run.engine.run_block(run.state, 2, statics=(None,),
                                        batches=batches, plan=run.plan,
                                        uniforms=uniforms, eager=True)
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(run.state), after))
        log(f"driver oracle (2 layers, f32, {args.participation}): replayed "
            f"block == eager block: records {replayed == eager}, state "
            f"{same}; task {[round(sum(r['task']), 4) for r in replayed]}")
        if replayed != eager or not same:
            raise AssertionError("driver oracle: replay and eager differ")
        del run
        gc.collect()


# ----------------------------------------------------------------------
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the port's smoke run "
              "needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_run = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"card: {card}")
    log(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"device {name}, count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a, all "
        f"sources at once)")
    build_report()

    def stamp(what: str) -> None:
        log(f"[{time.perf_counter() - t_run:.1f} s] {what} done")

    rows = {"decode_attention": decode_phase(),
            "flash_attention": flash_phase(),
            "gram": gram_phase(),
            "lora_matmul": lora_phase(),
            "selective_scan": scan_phase(),
            "mla_decode": mla_decode_phase()}
    rows["lora_matmul"]["timings"] += lora_nodes_phase()
    rows["flash_attention"]["timings"] += window_flash_phase()
    rows["decode_attention"]["timings"] += window_decode_phase()
    rows["flash_attention"]["timings"] += chunk_flash_phase()
    rows["decode_attention"]["timings"] += chunk_decode_phase()
    rows["flash_attention"]["timings"] += mla_flash_phase()
    stamp("kernel phases")

    cfg = get_config("fedmm-base")
    params = T.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg, device="cuda")
    served = serve_phase(cfg, params)
    served["oracle"] = serve_graph_oracle_phase(cfg, params, served)
    trace_phase(cfg, params)
    oracle_phase(cfg, params, served["first"])
    chaos = {t: chaos_phase(cfg, params, temperature=t) for t in (0.0, 0.7)}
    del params
    stamp("fedmm-base serve, oracle and chaos phases")

    ssm_served = ssm_phases()
    stamp("ssm phases")
    t_new = time.perf_counter()
    hybrid = hybrid_phases()
    windowed = window_phases()
    new_s = time.perf_counter() - t_new
    stamp("hybrid and windowed phases")
    scout = scout_phases()
    stamp("moe phases")
    deepseek = deepseek_phases()
    stamp("MLA phases")

    fed, rounds = federation_phase()
    federation_trace_phase(fed)
    federation_oracle_phase(fed)
    del fed
    _, rank64 = federation_phase(rounds=1, lora_rank=64, n_layers=2)
    stamp("federation phases")

    efed, engine = engine_phase()
    engine_trace_phase(efed)
    del efed
    gc.collect()                      # the engine and its graphs
    engine_oracle_phase()
    stamp("engine phases")

    t_part = time.perf_counter()
    pfed = part_federation()
    log(f"participation phase: Federation on fedmm-small ({pfed.cfg.n_layers}"
        f" layers, d_model {pfed.cfg.d_model}, {pfed.cfg.dtype}), geodora, "
        f"precision, {PART_NODES} nodes x {pfed.fed.local_steps} local steps,"
        f" buckets {[len(b) for b in pfed._buckets]} of widths "
        f"{pfed._bucket_widths}")
    part = {"uniform": participation_phase(pfed, UNIFORM, "uniform C 4")}
    participation_trace_phase(pfed, UNIFORM, "uniform C 4")
    part["async"] = participation_phase(pfed, ASYNC, "async")
    participation_trace_phase(pfed, ASYNC, "async")
    del pfed
    gc.collect()
    pfed = part_federation(n_layers=2)
    part["precision"] = participation_phase(pfed, PRECISION,
                                            "precision C 4 (2 layers)",
                                            rounds=1, block=0)
    part["dropout"] = participation_phase(pfed, DROPOUT,
                                          "dropout 0.25 (2 layers)",
                                          rounds=1, block=0)
    del pfed
    gc.collect()
    participation_oracle_phase()
    part_s = time.perf_counter() - t_part

    t_ck = time.perf_counter()
    ckpt = checkpoint_phases()
    ckpt_s = time.perf_counter() - t_ck
    t_drv = time.perf_counter()
    driver = {"full": driver_phase("full participation",
                                   ["--block-size", "2"]),
              "uniform": driver_phase("uniform C 2",
                                      ["--block-size", "2", "--participation",
                                       "uniform", "--cohort-size", "2"])}
    driver_oracle_phase()
    driver_s = time.perf_counter() - t_drv

    sources = {"decode_attention": "src/repro/kernels/decode_attention.py:77",
               "flash_attention": "src/repro/kernels/flash_attention.py:69",
               "gram": "src/repro/kernels/gram.py:31",
               "lora_matmul": "src/repro/kernels/lora_matmul.py:44",
               "selective_scan": "src/repro/kernels/selective_scan.py:49",
               # no Pallas kernel: the jnp einsums of mla_decode_slots
               "mla_decode": "src/repro/models/attention.py:466"}
    by_path = {k: {"serve (replayed blocks)": served["launches"][k],
                   "serve graph oracle (eager blocks)":
                       served["oracle"]["launches"][k],
                   "chaos + crash + resume (greedy)":
                       chaos[0.0]["launches"][k],
                   "chaos + crash + resume (temperature 0.7)":
                       chaos[0.7]["launches"][k],
                   "ssm serve (replayed blocks)": ssm_served["launches"][k],
                   "ssm serve graph oracle (eager blocks)":
                       ssm_served["oracle"]["launches"][k],
                   "hybrid serve (replayed blocks)": hybrid["launches"][k],
                   "hybrid serve graph oracle (eager blocks)":
                       hybrid["oracle"]["launches"][k],
                   "hybrid freeze + resume (5 layers)":
                       hybrid["freeze"]["launches"][k],
                   "windowed fedmm-base serve (replayed blocks)":
                       windowed["launches"][k],
                   "windowed fedmm-base serve graph oracle (eager blocks)":
                       windowed["oracle"]["launches"][k],
                   "moe serve, Llama-4-Scout 12 layers (replayed blocks)":
                       scout["launches"][k],
                   "moe serve graph oracle (eager blocks)":
                       scout["oracle"]["launches"][k],
                   "moe serve with MLA, DeepSeek-V2 7 layers (replayed "
                   "blocks)": deepseek["launches"][k],
                   "moe serve with MLA graph oracle (eager blocks)":
                       deepseek["oracle"]["launches"][k],
                   "federation": rounds["launches"][k],
                   "federation at rank 64 (2 layers)":
                       rank64["launches"][k],
                   "engine (2 replayed rounds)": engine["launches"][k],
                   "engine (one replayed block of 2 rounds)":
                       engine["block_launches"][k],
                   "participation uniform C 4 (2 replayed rounds)":
                       part["uniform"]["launches"][k],
                   "participation uniform C 4 (one replayed block of 2)":
                       part["uniform"]["block_launches"][k],
                   "participation async (2 replayed rounds)":
                       part["async"]["launches"][k],
                   "participation async (one replayed block of 2)":
                       part["async"]["block_launches"][k],
                   "participation precision C 4 (2 layers, one round)":
                       part["precision"]["launches"][k],
                   "participation dropout 0.25 (2 layers, one round)":
                       part["dropout"]["launches"][k],
                   "checkpoint, no plan (4 rounds, a file a round)":
                       ckpt["none"]["launches"][k],
                   "checkpoint, uniform C 4 (4 rounds, a file a round)":
                       ckpt["uniform"]["launches"][k],
                   "checkpoint, async (2 layers, 4 rounds, a file a round)":
                       ckpt["async"]["launches"][k],
                   "LM driver (4 rounds, blocks of 2)":
                       driver["full"]["launches"][k],
                   "LM driver uniform C 2 (4 rounds, blocks of 2)":
                       driver["uniform"]["launches"][k]} for k in rows}
    # the top-level times are the first timed shape's; ``timings`` holds
    # every timed shape with its path
    kernels = [dict(name=k, route="cuda",
                    source=f"src/repro_torch/csrc/{k}.cu",
                    replaces=sources[k], launches=sum(by_path[k].values()),
                    launches_by_path=by_path[k],
                    max_abs_err=r["max_abs_err"],
                    **{key: r["timings"][0][key] for key in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms")},
                    timings=r["timings"])
               for k, r in rows.items()]
    for what, run in (("serve", served), ("ssm serve", ssm_served),
                      ("hybrid serve", hybrid),
                      ("windowed fedmm-base serve", windowed),
                      ("moe serve (Llama-4-Scout, 12 of 48 layers)", scout),
                      ("moe serve with MLA (DeepSeek-V2-236B, 7 of 60 "
                       "layers)", deepseek)):
        log(f"{what}: {run['tokens'] / run['wall_s']} tokens/s replayed "
            f"(eager blocks: {run['tokens'] / run['oracle']['wall_s']}), "
            f"wall {run['wall_s']} s, capture {run['capture_s']} s, "
            f"{run['replays']} replays, peak memory {run['peak_gib']} GiB, "
            f"time to first token min / median / max {run['ttft'][0]} / "
            f"{run['ttft'][len(run['ttft']) // 2]} / {run['ttft'][-1]} s, "
            f"a replayed decode step {run['step_ms']} ms")
    log(f"hybrid and windowed dense phases: {new_s:.1f} s; moe phases "
        f"{scout['phase_s']:.1f} s; MLA phases {deepseek['phase_s']:.1f} s")
    log(f"federation: round wall {rounds['walls']} s; at rank 64 (2 "
        f"layers) {rank64['walls']} s")
    log(f"engine: replayed round wall {engine['walls']} s; block of 2 "
        f"rounds {engine['block_wall']} s")
    for k, v in part.items():
        log(f"participation {k}: replayed round wall {v['walls']} s"
            + (f"; block of 2 rounds {v['block_wall']} s"
               if "block_wall" in v else "")
            + f"; captures {v['capture_s']} s")
    log(f"participation phases (captures, rounds, traces, oracle): "
        f"{part_s:.1f} s")
    for k, v in ckpt.items():
        log(f"checkpoint {k}: 4 rounds with a file a round {v['wall']} s; "
            f"files {v['file_bytes']} bytes written in {v['write_s']} s; "
            f"captures {v['capture_s']} s; peak allocated "
            f"{v['memory']['peak_allocated_gib']} GiB, reserved "
            f"{v['memory']['peak_reserved_gib']} GiB")
    log(f"checkpoint phases: {ckpt_s:.1f} s")
    for k, v in driver.items():
        log(f"LM driver {k}: {v['round_s']} s a round (blocks of 2, "
            f"streams started), first 4 rounds {v['first_wall']} s, host "
            f"staging of a block {v['stage_s']} s, capture "
            f"{v['capture_s']} s, launches per round {v['per_round']}, peak "
            f"allocated {v['memory']['peak_allocated_gib']} GiB, reserved "
            f"{v['memory']['peak_reserved_gib']} GiB")
    log(f"driver phases: {driver_s:.1f} s")
    log(f"whole run: {time.perf_counter() - t_run:.1f} s")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
