"""A fixed-shape cycle captured once as a CUDA graph and replayed.

Each float32 cycle of the mixed route (``SoAVCycle``, ``RolledVCycle``,
``SoAStokesVCycle``, ``StreamedVCycle``, ``StreamedStokesVCycle``) and the
Stokes ``build_matvec`` is a fixed sequence of kernel launches with no host
synchronisation inside.  Launched eagerly, every kernel pays the host's
launch path (argument checks, ``torch.empty``, a ctypes call): 24-61 us
against 1-90 us of device time, so the host sets the cycle's pace.  dgtpu
compiles its whole refined solve into one XLA program and pays no dispatch
per phase; ``CycleGraph`` is the port's counterpart: the first call
captures the cycle with ``torch.cuda.graph``, every later call replays it.

The kernels launch on ``torch.cuda.current_stream()`` (``ops/_kernels.py``),
which inside ``torch.cuda.graph`` is the capture stream, so the ctypes
launches are captured as they are; the capture allocates its outputs and
intermediates from the graph's private memory pool.

The launch counters stay truthful: the capture records each kernel
wrapper's ``launches`` delta (the launches the graph holds, which the
capture itself does not run) and takes it back, and every replay adds it
again.  ``CycleGraph.captures`` and ``CycleGraph.replays`` count captures
and replays over all graphs.

No CPU mode and no fallback: CPU tensors raise, and a capture that fails
raises; the caller never gets the eager cycle in its place.
"""

import time

import torch

from dgtpu_torch.ops import stream, vcycle
from dgtpu_torch.ops import stokes_soa as ss

# every kernel wrapper a cycle can launch (each keeps a ``launches`` count)
COUNTED = ss.CYCLE_KERNELS + stream.KERNELS + vcycle.KERNELS


class CycleGraph:
    """``CycleGraph(fn)`` wraps a fixed-shape callable of CUDA tensors
    returning one tensor, ``(rhs, u) -> u`` for a cycle or ``x -> y`` for a
    matvec.

    First call: one eager warm-up call on a side stream (it loads the kernel
    libraries and fills their caches), then the capture of one call on static
    copies of the inputs, then a replay.  Later calls copy the inputs into
    the static buffers and replay.  Every call returns a fresh tensor (a
    clone of the static output), so nothing the caller keeps is overwritten
    by the next replay.  ``launches``: {kernel wrapper: launches per replay};
    ``capture_seconds``: the warm-up and capture, host clock, synchronised."""

    captures = 0
    replays = 0

    def __init__(self, fn):
        self.fn = fn
        self.graph = None
        self.launches = {}
        self.capture_seconds = 0.0

    @classmethod
    def reset_counts(cls):
        cls.captures = cls.replays = 0

    def __call__(self, *inputs):
        for x in inputs:
            if not (isinstance(x, torch.Tensor) and x.is_cuda):
                raise ValueError("CycleGraph replays CUDA work: its inputs must be "
                                 "CUDA tensors (run the cycle itself on the CPU)")
        if self.graph is None:
            self._capture(inputs)
        else:
            if len(inputs) != len(self.static_in) or any(
                    x.shape != s.shape or x.dtype != s.dtype or x.device != s.device
                    for x, s in zip(inputs, self.static_in)):
                raise ValueError("CycleGraph: the inputs' shapes, dtypes or device "
                                 "differ from the captured call's")
            for s, x in zip(self.static_in, inputs):
                s.copy_(x)
        self.graph.replay()
        for kern, n in self.launches.items():
            kern.launches += n
        CycleGraph.replays += 1
        return self.static_out.clone()

    def _capture(self, inputs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.static_in = [x.clone() for x in inputs]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.fn(*self.static_in)
        torch.cuda.current_stream().wait_stream(side)
        before = {k: k.launches for k in COUNTED}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.static_out = self.fn(*self.static_in)
        self.launches = {k: k.launches - before[k] for k in COUNTED
                         if k.launches != before[k]}
        for kern, n in self.launches.items():
            kern.launches -= n                  # captured, not run
        self.graph = graph
        CycleGraph.captures += 1
        torch.cuda.synchronize()
        self.capture_seconds = time.perf_counter() - t0
