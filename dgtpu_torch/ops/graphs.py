"""A fixed-shape step captured once as a CUDA graph and replayed.

Each float32 cycle of the mixed route (``SoAVCycle``, ``RolledVCycle``,
``SoAStokesVCycle``, ``StreamedVCycle``, ``StreamedStokesVCycle``) and the
Stokes ``build_matvec`` is a fixed sequence of kernel launches with no host
synchronisation inside.  So are the float64 programs that dgtpu compiles
and replays many times in one solve: ``MultigridSolver.step`` (a cycle and
its residual norm, once per cycle of ``-m`` in full precision) and the
GMRES(16) correction step of the refinement
(``solvers/refinement.gmres_step``).  Launched eagerly, every kernel pays
the host's launch path (argument checks, ``torch.empty``, a ctypes call):
24-61 us against 1-90 us of device time, so the host sets the cycle's
pace.  dgtpu
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
again; so with the sharded multigrid's halo exchanges
(``parallel/halo.EXCHANGES``), which a replay copies on the card without
the host's count.  ``CycleGraph.captures`` and ``CycleGraph.replays`` count
captures and replays over all graphs.

No CPU mode and no fallback: CPU tensors raise, and a capture that fails
raises; the caller never gets the eager cycle in its place.

The loops that dgtpu compiles as ``jax.lax.while_loop`` (CG and restarted
GMRES with their preconditioner, the Krylov multigrid cycle included, the
residual-tracked smoothers, the AMG cycle loop) need more than a graph of
one step: their loop test must stay on the device too.  ``while_loop`` / ``run_while`` are their counterpart.  One
iteration is ``state = where(cond(state), body(state), state)`` written into
the state's own tensors, and the loop test of the result into a flag: once
the test is false the state is frozen, so iterations past the stop change
nothing, bit for bit.  On the card (``LoopGraph``) the iteration is captured
once and replayed in runs (``chunk``), and the host reads the flag once per
run; on the CPU (``MaskedLoop``) the same iteration runs eagerly in the same
runs.  PyTorch exposes CUDA's conditional graph nodes only as an if/else
node for ``torch.cond`` inside its compiler's graph trees, with no while
node, so the loop test is a mask and the frozen iterations after the stop
are paid for.  As for ``CycleGraph``, CPU state raises and a failed
capture raises.
"""

import time
from contextlib import contextmanager

import torch

from dgtpu_torch.ops import stream, vcycle
from dgtpu_torch.ops import stokes_soa as ss
from dgtpu_torch.utils import trace

# every kernel wrapper a cycle can launch (each keeps a ``launches`` count)
COUNTED = ss.CYCLE_KERNELS + stream.KERNELS + vcycle.KERNELS
# the host time one run of a loop's replays should take where the caller
# leaves ``chunk`` to the loop (``MaskedLoop.run``)
CHUNK_SECONDS = 1e-3
# the open ``collect()`` lists, innermost last
_collectors = []


def _exchanges():
    """The sharded multigrid's halo exchange counter (``parallel/halo.py``;
    imported here: that module imports the multigrid solver, which imports
    this one)."""
    from dgtpu_torch.parallel.halo import EXCHANGES
    return EXCHANGES


def _replayed(launches, exchanges, n):
    """Add ``n`` replays' kernel launches and halo exchanges to the counters
    (a replay runs on the card and bumps no host counter itself)."""
    for kern, k in launches.items():
        kern.launches += k * n
    if exchanges:
        _exchanges().update({kind: k * n for kind, k in exchanges.items()})
    CycleGraph.replays += n
    trace.count("graph.replays", n)


def _record(warm, record):
    """Capture ``record()`` into a new CUDA graph after one eager ``warm()``
    on the warm-up side stream; returns ``(graph, launches, exchanges,
    (warm-up, record, instantiate) seconds)``.  ``launches``: {kernel
    wrapper: launches per replay}; ``exchanges``: {device type: halo
    exchanges per replay}; both taken back from the counters (captured, not
    run)."""
    exchanged = _exchanges()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    device = torch.cuda.current_device()
    if device not in CycleGraph._warmup_streams:
        CycleGraph._warmup_streams[device] = torch.cuda.Stream()
    side = CycleGraph._warmup_streams[device]
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        warm()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    before = {k: k.launches for k in COUNTED}
    exchanged_before = dict(exchanged)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        record()
        t2 = time.perf_counter()
    launches = {k: k.launches - before[k] for k in COUNTED if k.launches != before[k]}
    for kern, n in launches.items():
        kern.launches -= n
    exchanges = {kind: n - exchanged_before.get(kind, 0) for kind, n in exchanged.items()
                 if n != exchanged_before.get(kind, 0)}
    exchanged.subtract(exchanges)
    CycleGraph.captures += 1
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    trace.count("graph.captures")
    return graph, launches, exchanges, (t1 - t0, t2 - t1, t3 - t2)


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
        self.launches, self.exchanges = {}, {}
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
        _replayed(self.launches, self.exchanges, 1)
        if isinstance(self.static_out, tuple):
            return tuple(o.clone() for o in self.static_out)
        return self.static_out.clone()

    def _capture(self, inputs):
        self.static_in = [x.clone() for x in inputs]

        def record():
            self.static_out = self.fn(*self.static_in)

        self.graph, self.launches, self.exchanges, seconds = _record(
            lambda: self.fn(*self.static_in), record)
        self.fn = None
        self.warmup_seconds, self.record_seconds, self.instantiate_seconds = seconds
        self.capture_seconds = sum(seconds)


class MaskedLoop:
    """``jax.lax.while_loop(cond, body, state)`` as masked iterations, run
    eagerly (the CPU's loop, and the card's eager reference).

    ``state``: a tuple of fixed-shape tensors, the step counter first (a 0-d
    int64 tensor); scalars are 0-d tensors, a history a preallocated buffer
    written through tensor indices (``index_copy``), never through Python
    ints read from the device.  ``cond(state)``: a 0-d bool tensor;
    ``body(state)``: the next state as a new tuple (it must not write into
    ``state``).  One iteration (``step``) writes ``where(flag, body(state),
    state)`` into the state's tensors, then ``cond`` of the result into
    ``flag``.  ``where`` returns ``body``'s values exactly where the flag
    holds, NaN included, so every active iteration is the unmasked one; once
    the flag is false the state is frozen and ``cond`` stays false, so an
    iteration after the stop changes nothing.  ``name``: the span of a
    capture (``LoopGraph``)."""

    def __init__(self, cond, body, state, name="loop.capture"):
        self.cond, self.body, self.name = cond, body, name
        self.state = tuple(state)
        self.flag = torch.ones((), dtype=torch.bool, device=self.state[0].device)

    def step(self, state, flag):
        """One masked iteration on ``state`` and ``flag``, in place."""
        new = [torch.where(flag, v, s) for s, v in zip(state, self.body(state))]
        for s, v in zip(state, new):
            s.copy_(v)
        flag.copy_(self.cond(state))

    def _prepare(self):
        """What the first run needs before its iterations (nothing here)."""

    def _iterate(self, n):
        for _ in range(n):
            self.step(self.state, self.flag)

    def run(self, max_steps, chunk=None):
        """Iterate while ``cond`` holds, at most ``max_steps`` times;
        returns the state, updated in place.

        The iterations run in runs of ``chunk``, the last cut to
        ``max_steps``, and the host reads the flag (one 0-d tensor) after
        each run but the one that reaches ``max_steps``.  ``chunk=None``
        chooses it from the measured time of the first run, one iteration:
        ``chunk = CHUNK_SECONDS / t1``, so that a run of replays lasts about
        a millisecond.  The read's round trip (a synchronisation, then the
        launch of the next run: tens of microseconds) is then a few percent
        of the run, and the frozen iterations after the stop cost less than
        one run.  ``chunk`` holds the run size afterwards."""
        self.flag.copy_(self.cond(self.state))
        self._prepare()
        self.chunk, done = chunk or 1, 0
        while done < max_steps:
            n = min(self.chunk, max_steps - done)
            t0 = time.perf_counter()
            self._iterate(n)
            done += n
            if done == max_steps or not self.flag.tolist():
                break
            if chunk is None and done == n:
                self.chunk = max(1, int(CHUNK_SECONDS / (time.perf_counter() - t0)))
        return self.state


class LoopGraph(MaskedLoop):
    """``MaskedLoop`` on the card: its iteration is captured once as a CUDA
    graph on the state's own tensors (no input copies, no output clones)
    and replayed ``chunk`` times back to back between two reads of the
    flag.  The capture warms up on clones of the state, so it advances
    nothing, and records the iteration on the state itself at the first
    ``run``; later runs (GMRES's restarts, after resetting the state in
    place) replay the same graph.  Its seconds and counters are
    ``CycleGraph``'s, and ``collect()`` lists it.  CUDA state only, and a
    capture that fails raises: no eager fallback."""

    def __init__(self, cond, body, state, name="loop.capture"):
        for x in state:
            if not (isinstance(x, torch.Tensor) and x.is_cuda):
                raise ValueError("LoopGraph replays CUDA work: its state must be CUDA "
                                 "tensors (run MaskedLoop on the CPU)")
        super().__init__(cond, body, state, name)
        self.graph = None
        self.launches, self.exchanges = {}, {}
        self.capture_seconds = 0.0
        self.warmup_seconds = self.record_seconds = self.instantiate_seconds = 0.0
        for got in _collectors:
            got.append(self)

    def _prepare(self):
        if self.graph is not None:
            return
        with trace.span(self.name):
            warm = (tuple(s.clone() for s in self.state), self.flag.clone())
            self.graph, self.launches, self.exchanges, seconds = _record(
                lambda: self.step(*warm), lambda: self.step(self.state, self.flag))
        self.warmup_seconds, self.record_seconds, self.instantiate_seconds = seconds
        self.capture_seconds = sum(seconds)

    def _iterate(self, n):
        for _ in range(n):
            self.graph.replay()
        _replayed(self.launches, self.exchanges, n)


def while_loop(cond, body, state, name="loop.capture"):
    """A ``LoopGraph`` of CUDA state, a ``MaskedLoop`` of CPU state."""
    return (LoopGraph if state[0].is_cuda else MaskedLoop)(cond, body, state, name)


def run_while(cond, body, state, *, max_steps, chunk=None, name="loop.capture"):
    """``while_loop(cond, body, state, name).run(max_steps, chunk)``."""
    return while_loop(cond, body, state, name).run(max_steps, chunk)


@contextmanager
def collect():
    """``with collect() as loops:`` lists in ``loops`` every ``LoopGraph``
    made inside (the solve counts their captures in ``graph_seconds``)."""
    got = []
    _collectors.append(got)
    try:
        yield got
    finally:
        _collectors.remove(got)
