"""CUDA graphs of the paged decode step: one graph per shape of the step's
inputs, captured on the first step at that shape and replayed after.

A paged decode step (``models.transformer.decode_step_paged``) is a chain
of some 80 launches a layer (norms, projections, the K/V write, the paged
decode kernel and its merge, the FFN or the MoE FFN) that the host
enqueues one at a time; at serving batch sizes that enqueue, not the
device, sets the step's time. A graph enqueues the whole chain with one
launch. The kernels inside it are the port's own, unchanged.

What a replay takes as given, and what ``DecodeGraphs.run`` checks:

- every tensor the step reads or writes besides its inputs (the weights,
  the block pool) stays where it was at capture and is updated in place:
  the pinned tensors' data pointers are held against the capture's before
  every replay, and a moved one raises;
- the inputs (tables, positions, tokens) are the capture's own tensors
  (the engine stages them in fixed buffers, so nothing is copied), or are
  copied into those before the replay;
- the step neither synchronises with the host nor chooses anything on the
  host from a tensor's values: its host-side choices (the paged kernel's
  pages per split, the MoE capacity) are functions of the shapes, and the
  shapes are the key;
- the outputs are the capture's tensors, which the next replay
  overwrites: a caller reads them before its next step.

An engine's graphs share one private memory pool and are replayed one at
a time, in the order the engine steps, on the current stream. Each
replay adds to a kernel wrapper's ``launches`` what its capture added, so
that count still says how many times the kernel ran.

Under a ``torch.profiler`` session the replay is the span
``repro_torch.engine.decode.replay``; a capturing step runs the step's
Python body once (its model spans open then) and then replays.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch.serving.tracing import span

Key = Tuple[Tuple[Tuple[int, ...], torch.dtype], ...]


def graph_key(inputs: Sequence[torch.Tensor]) -> Key:
    """The shapes and dtypes of a step's inputs: one graph each."""
    return tuple((tuple(t.shape), t.dtype) for t in inputs)


class _Graph:
    __slots__ = ("graph", "inputs", "outputs", "pinned", "launches")

    def __init__(self, graph, inputs, outputs, pinned, launches):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.pinned = pinned
        self.launches = launches


class DecodeGraphs:
    """One engine's graphs of its decode step, by ``graph_key``.
    ``captures`` counts the graphs captured, ``replays`` the steps run
    through one (a capturing step included), ``capture_s`` the host
    seconds spent capturing (the step's body run once, the graph built),
    a one-off cost of each window that the engine keeps off its step
    times as it keeps its warm-up."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0
        self._graphs: Dict[Key, _Graph] = {}
        self._mempool = None
        self._stream = None

    def run(self, fn: Callable[..., Tuple[torch.Tensor, ...]],
            inputs: Sequence[torch.Tensor], *,
            pinned: Sequence[torch.Tensor] = (), counters: Sequence = ()
            ) -> Tuple[torch.Tensor, ...]:
        """``fn(*inputs)``, a tuple of tensors, by replaying the graph of
        the inputs' shapes, captured from ``fn`` first on a miss.
        ``pinned``: the tensors the step reads or writes in place besides
        its inputs; ``counters``: the kernel wrappers whose ``launches``
        a replay advances."""
        key = graph_key(inputs)
        ptrs = [t.data_ptr() for t in pinned]
        g = self._graphs.get(key)
        if g is None:
            g = self._capture(key, fn, inputs, ptrs, counters)
        else:
            if ptrs != g.pinned:
                raise RuntimeError("a tensor the decode graph reads in place "
                                   "has moved since its capture")
            for dst, src in zip(g.inputs, inputs):
                if (src.data_ptr() != dst.data_ptr()
                        or src.stride() != dst.stride()):
                    dst.copy_(src)
            for c, n in zip(counters, g.launches):
                c.launches += n
        with span("repro_torch.engine.decode.replay"):
            g.graph.replay()
        self.replays += 1
        return g.outputs

    def _capture(self, key: Key, fn, inputs, ptrs: List[int],
                 counters) -> _Graph:
        """Capture ``fn(*inputs)`` on a side stream into the shared pool.
        Capture enqueues nothing: the caller replays it."""
        t0 = time.perf_counter()
        if self._mempool is None:
            self._mempool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        graph = torch.cuda.CUDAGraph()
        before = [c.launches for c in counters]
        current = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            graph.capture_begin(pool=self._mempool,
                                capture_error_mode="thread_local")
            try:
                outputs = tuple(fn(*inputs))
            finally:
                graph.capture_end()
        current.wait_stream(self._stream)
        g = _Graph(graph, tuple(inputs), outputs, ptrs,
                   [c.launches - n for c, n in zip(counters, before)])
        self._graphs[key] = g
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return g
