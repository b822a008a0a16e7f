"""CUDA-graph capture and replay with exact kernel launch counts.

Where the reference compiles a unit of work into one dispatch -- a
federated round or a block of M rounds (``jit`` + ``lax.scan``), a serving
block of M decode steps -- the port captures the same work into one CUDA
graph and replays it (``core/engine.py``, ``serve/engine.py``).  This is
the capture both share:

- one warm-up run of the work on a side stream, whose launches are real
  and count; the state tensors are restored after it, so the warm-up
  leaves no trace in them;
- the capture, with garbage collection held off: a collected cycle that
  holds another graph (a dropped engine) would destroy it, and that CUDA
  call invalidates the capture;
- the kernel wrappers' launch counters (``decode_attention.launches``
  ...) are Python integers, which a replay does not touch: the capture
  takes back what it recorded (a capture launches nothing) and every
  ``Captured.replay`` adds it again, so the counters stay exact.

The work must make every tensor on the card (a host-to-device copy of a
CPU tensor breaks the capture) and write its state back in place, so
each replay reads and writes the same buffers.  A capture that fails
raises; there is no eager fallback.
"""
from __future__ import annotations

import gc
from dataclasses import dataclass
from typing import Any, Callable, Sequence, Tuple

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.gram import cosine_gram
from repro_torch.kernels.lora_matmul import lora_matmul
from repro_torch.kernels.mla_decode import mla_decode
from repro_torch.kernels.selective_scan import selective_scan

#: every kernel wrapper's launch counter, which replays keep exact
COUNTED = (decode_attention, flash_attention, cosine_gram, lora_matmul,
           selective_scan, mla_decode)


@dataclass
class Captured:
    graph: Any
    out: Any                   # the work's outputs, rewritten by each replay
    launches: Tuple[int, ...]  # per COUNTED wrapper, what one replay launches

    def replay(self):
        """Replay the graph on the current stream; returns ``out``."""
        self.graph.replay()
        for fn, n in zip(COUNTED, self.launches):
            fn.launches += n
        return self.out

    def launches_by_name(self) -> dict:
        return {fn.__name__: n for fn, n in zip(COUNTED, self.launches)}


def capture(run: Callable[[], Any], state: Sequence[torch.Tensor]
            ) -> Captured:
    """Capture ``run()`` on the card after one warm-up run; ``state`` is
    every tensor the work updates in place, restored after the warm-up."""
    saved = [t.clone() for t in state]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    for t, s in zip(state, saved):
        t.copy_(s)
    del saved
    before = tuple(fn.launches for fn in COUNTED)
    graph = torch.cuda.CUDAGraph()
    collect = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph):
            out = run()
    finally:
        if collect:
            gc.enable()
    launches = tuple(fn.launches - b for fn, b in zip(COUNTED, before))
    for fn, b in zip(COUNTED, before):
        fn.launches = b
    return Captured(graph, out, launches)


__all__ = ["COUNTED", "Captured", "capture"]
