"""A fixed-shape step captured once as a CUDA graph and replayed.

Each float32 cycle of the mixed route (``SoAVCycle``, ``RolledVCycle``,
``SoAStokesVCycle``, ``StreamedVCycle``, ``StreamedStokesVCycle``) and the
Stokes ``build_matvec`` is a fixed sequence of kernel launches with no host
synchronisation inside.  So are the float64 programs that dgtpu compiles
and replays many times in one solve: ``MultigridSolver.step`` (a cycle and
its residual norm, once per cycle of ``-m`` in full precision), the
zero-guess cycle of the Krylov multigrid preconditioner, and the GMRES(16)
correction step of the refinement (``solvers/refinement.gmres_step``).  Launched eagerly, every kernel pays the host's
launch path (argument checks, ``torch.empty``, a ctypes call): 24-61 us
against 1-90 us of device time, so the host sets the cycle's pace.  dgtpu
compiles its whole refined solve into one XLA program and pays no dispatch
per phase; ``CycleGraph`` is the port's counterpart: the first call
captures the step with ``torch.cuda.graph``, every later call replays it.

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
from dgtpu_torch.utils import trace

# every kernel wrapper a cycle can launch (each keeps a ``launches`` count)
COUNTED = ss.CYCLE_KERNELS + stream.KERNELS + vcycle.KERNELS


class CycleGraph:
    """``CycleGraph(fn, name)`` wraps a fixed-shape callable of CUDA tensors
    returning one tensor or a tuple of tensors: ``(rhs, u) -> u`` for a
    cycle, ``x -> y`` for a matvec, ``(rhs, u) -> (u, ||r||)`` for a step
    that hands back its residual norm.  ``fn`` must not write into its
    inputs: the warm-up runs on the static inputs that the first replay
    reads.  The graph drops ``fn`` once captured: a solver that keeps the
    graph of its own bound method would otherwise sit in a reference cycle
    that holds the graph's device memory until the garbage collector runs.
    The warm-ups of all graphs on a card share one side stream: PyTorch
    keeps a cuBLAS workspace (32 MiB on the H100) for every stream a cuBLAS
    call ran on, so a fresh stream per capture would pile them up, to ~1 GB
    over the 32 streams of its pool.  ``name``: the span of the capture.

    First call: one eager warm-up call on a side stream (it loads the kernel
    libraries and fills their caches), then the capture of one call on static
    copies of the inputs, then a replay.  Later calls copy the inputs into
    the static buffers and replay.  Every call returns fresh tensors (clones
    of the static outputs), so nothing the caller keeps is overwritten by
    the next replay.  ``launches``: {kernel wrapper: launches per replay};
    ``capture_seconds``: the warm-up and capture, host clock, synchronised,
    split into ``warmup_seconds`` (the eager call), ``record_seconds`` (the
    call under capture, which records and runs nothing, after the garbage
    collection and cache release that ``torch.cuda.graph`` starts with) and
    ``instantiate_seconds`` (ending the capture, ``cudaGraphInstantiate``).

    The capture costs about two eager calls (the warm-up, and the recording,
    whose host work is the eager call's) plus the instantiation, and saves
    an eager call's host work less a replay on every later call.  With a
    replay much faster than the eager call (t_r << t_e) it pays for itself
    after about 2 + instantiate / t_e replays, so three or four for a step
    that one solve replays ten times or more."""

    captures = 0
    replays = 0
    _warmup_streams = {}        # {device index: the warm-ups' side stream}

    def __init__(self, fn, name="solve.capture"):
        self.fn = fn
        self.name = name
        self.graph = None
        self.launches = {}
        self.capture_seconds = 0.0
        self.warmup_seconds = self.record_seconds = self.instantiate_seconds = 0.0

    @classmethod
    def reset_counts(cls):
        cls.captures = cls.replays = 0

    def __call__(self, *inputs):
        for x in inputs:
            if not (isinstance(x, torch.Tensor) and x.is_cuda):
                raise ValueError("CycleGraph replays CUDA work: its inputs must be "
                                 "CUDA tensors (run the cycle itself on the CPU)")
        if self.graph is None:
            with trace.span(self.name):
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
        trace.count("graph.replays")
        if isinstance(self.static_out, tuple):
            return tuple(o.clone() for o in self.static_out)
        return self.static_out.clone()

    def _capture(self, inputs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.static_in = [x.clone() for x in inputs]
        device = torch.cuda.current_device()
        if device not in CycleGraph._warmup_streams:
            CycleGraph._warmup_streams[device] = torch.cuda.Stream()
        side = CycleGraph._warmup_streams[device]
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.fn(*self.static_in)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        before = {k: k.launches for k in COUNTED}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.static_out = self.fn(*self.static_in)
            t2 = time.perf_counter()
        self.launches = {k: k.launches - before[k] for k in COUNTED
                         if k.launches != before[k]}
        for kern, n in self.launches.items():
            kern.launches -= n                  # captured, not run
        self.graph, self.fn = graph, None
        CycleGraph.captures += 1
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        self.warmup_seconds, self.record_seconds = t1 - t0, t2 - t1
        self.instantiate_seconds = t3 - t2
        self.capture_seconds = t3 - t0
        trace.count("graph.captures")
