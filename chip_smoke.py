#!/usr/bin/env python3
"""Smoke test of dgtpu_torch on one NVIDIA GPU: the quickest proof that the
port builds, runs its CUDA kernels and solves on the card.

    python3 chip_smoke.py             # every phase below
    python3 chip_smoke.py --profile   # phases 1-2, then the profile
    python3 chip_smoke.py --parent DIR   # every phase, with DIR's kernels beside
    python3 chip_smoke.py --sharded   # phases 1-2, phase 6's SoA-route solve, phase 24

``--parent DIR`` takes the root of an earlier tree of the repository (for
example ``git archive <commit> dgtpu_torch/csrc | tar -x -C DIR``): its
``dgtpu_torch/csrc`` sources are built beside this tree's, and wherever a
phase times a graphed cycle (7, 12, 16, 21), K1 (7, 12), K4 (12: at every
shape of the main paths), K5 (12, 16), K6 (12, 16), K7 (16: float32 and
bfloat16, eagerly and in a graph), R1, R2 or R3 (21) it also times the earlier tree's kernels on the same inputs, in turns
with this tree's (earlier, this, this, earlier), and prints whether the two
agree bit for bit (K1, K4, K5, K6, K7, R1, R2 and the SoA, Stokes and
hybrid cycles must).

Phases (each prints one line; any failure raises, so the exit code is not 0):
  1. the card (name and power limit from nvidia-smi);
  2. build the CUDA kernels of dgtpu_torch/csrc/soa_kernels.cu and
     rolled_kernels.cu, one nvcc each, started together; the launch floor
     (an empty kernel, eagerly and as 200 launches in one graph);
  3. each Poisson kernel (K1 half-sweep, K5 stencil apply as the residual,
     K3 small GEMM, K4 geometric transfer) against its plain torch version
     on the same inputs, at the 8x8 p=5 hierarchy's shapes and on the 4x4
     O-grid (K1's and K6's checks print the cluster their launcher picks);
  4. one whole cycle on the 8x8 p=5 hierarchy, kernel path against plain path,
     and the cycle captured as a CUDA graph (``ops/graphs.py``) against the
     eager cycle, bit for bit, with the launch counters after 3 replays
     held to 3 x the eager cycle's (again with the dense coarse inverse);
  5. the CLI route ``python -m dgtpu_torch -m --precision mixed`` on the
     default paramfile, with the launch count of every kernel (every route
     solve replays its captured cycle: solve and capture seconds apart);
  6. the same route on Rectangle_64X64_nPoly5 (factors 16,8,4,2, FMG seed):
     the hierarchy outgrows the card's L2 (the budget read from the card),
     so it runs the streamed hybrid (K7 on the finest level), held to a
     solve of the same hierarchy through the SoA cycle;
  7. each kernel against its plain version at every shape of the 64x64 p=5
     SoA hierarchy; marginal cycle times of the SoA cycle (CUDA events,
     slope between k and 8k cycles), 8x8 and 64x64, eager and graphed in
     turns; K1 at the 8x8 and 64x64 finest shapes eagerly and in a graph
     with its cluster; K3 at every shape of the 8x8 p=5 cycle timed four
     ways (eager, 200 launches in one graph, and its library call,
     torch.baddbmm or torch.matmul, both ways);
  8. each kernel of the Stokes cycle (K1, K3, K4, K5 and K6 pressure DG
     half-sweep) against its plain version at every shape of the 8x8
     p_u=2/p_p=1 Stokes hierarchy, and K1/K5/K6 on a synthetic O-grid;
  9. one whole 8x8 Stokes W-cycle, kernel path against plain path; the
     W-cycle and the matvec graphed against eager, bit for bit;
 10. the Stokes CLI route at 8x8 through a temporary paramfile, with the
     launch count of every kernel;
 11. the Stokes route on Rectangle_32X32_nPoly2 (6 levels; GMRES-wrapped
     refinement when the plain one stalls), with the launch count of every
     kernel, then each kernel against its plain version at every shape of
     the 32x32 hierarchy;
 12. marginal Stokes W-cycle times (eager and graphed in turns) and
     launches per cycle, per-call times of K5 and K6 beside their plain
     versions, K5's A.uv + base, G.p and D.uv + base, K1 on A + base and K6
     with and without base at the 8x8 and 32x32 finest shapes eagerly and in
     a graph with the grid its launcher picks, and K3 at the 8x8 Stokes
     shapes four ways; then K4 at every shape the main paths give it (the
     geometric levels of the 8x8 and 64x64 Poisson and of the 8x8 and 32x32
     Stokes cycles: restriction and prolongation + base, per component),
     with its launches in one cycle, eagerly and in a graph, beside its
     bound, launch grid and library call (torch.einsum on pre-gathered
     inputs);
 13. the streamed kernels against their plain versions: K7 (float32 and
     bfloat16 blocks) and K5 with bfloat16 blocks at the 64x64 p=5 finest
     shapes, K6 (the streamed DG pass) and K5 at the 32x32 Stokes finest
     shapes, K7 on a synthetic O-grid; K7 on its default grid (one cluster
     per cell tile, which must fit the card at 64x64), on one cluster
     (striding over the tiles) and on the most clusters the card holds;
 14. the 64x64 route with ``performance.block storage: bfloat16``;
 15. the 32x32 Stokes route through the streamed Stokes hybrid (budget: the
     SoA bytes of all levels but the two finest), FMG seed, plain and
     GMRES(16) refinement;
 16. the hybrids graphed against eager, bit for bit (64x64 Poisson float32
     and bfloat16 storage, the 32x32 Stokes W-cycle and matvec); marginal
     cycle times and launches per cycle, SoA cycle against the hybrids,
     eager and graphed in turns, and per-call times of K7 and K5 with
     bfloat16 blocks beside their plain versions (K7 with float32 and
     bfloat16 blocks, K5's float32 and bfloat16 residuals and K6's streamed
     DG pass also in a graph, with their grids; K7 beside its streaming
     floor);
 17. the rolled cycle's kernels (R1 half-sweep, R2 stencil apply, R3
     transfer, R4 dense apply) against their plain versions at every shape
     of the 8x8 p=5 hierarchy with geometric factors 8,4,2 (B 36, 16, 4;
     8x8 down to 1x1), of the 64x64 p=5 hierarchy with factors 64,...,2
     (R3 on 1 to 4,096 cells: every tile its launcher picks), of the 4x4
     O-grid hierarchy and on a synthetic 3-wide level;
 18. one whole rolled cycle on that 8x8 p=5 hierarchy, kernel path against
     plain path, and graphed against eager, bit for bit;
 19. the mixed route through the rolled cycle: the CLI at 8x8 p=5 with
     factors 8,4,2 (a 1x1 coarsest level, so no SoA cycle), held to dgtpu's
     L2(u); the same with an F-cycle and the dense coarse inverse; and at
     64x64 p=5 with factors 64,...,2 and an FMG seed, held to phase 6's
     SoA-route solution;
 20. the full-precision routes on the card at 8x8 p=5: ``-m`` with
     sequential and red-black smoothing and ``-d``, held to the mixed
     route's L2(u); ``-s`` at 8x8 p=2;
 21. marginal rolled cycle times (eager and graphed in turns) and launches
     per cycle at 8x8 and 64x64 beside the SoA cycle's, per-call times of
     R1-R4 beside their plain versions and bounds, each call first held to
     its plain version (R1 and R2 at the finest level and at the B 16 and
     4 levels, R3's per-cell P e + u, geometric restriction and
     prolongation, also in a graph), and R4 four ways beside torch.mv;
 22. the routes outside the mixed multigrid, float64 plain torch on the
     card (no kernel launches), one line each with its iterations or
     cycles, status, solve seconds and L1/L2: Stokes ``-d`` (8x8 local and
     global order, 32x32 global: a dense 22,528-unknown LU),
     ``-m`` in full precision at 8x8 (classical_exact and lsq splittings),
     ``-s`` with distributive GS, the mixed -> full fallback (8x8, factors
     8,4,2), ``-k`` GMRES with the multigrid preconditioner (8x8, 32x32)
     and the Schur block-diagonal one (8x8), each held to phases 10/11's
     L2(u, v, p);
     Poisson 8x8 p5 ``-k`` (GMRES with block-diagonal, AMG and multigrid
     preconditioners, CG with a symmetric cycle) held to phase 20's ``-d``
     L2(u), ``-amg`` sa and rs held to dgtpu's route; the phase's wall
     time;
 23. the routes ported last (``other_route_phases``): ``-fvm`` at 64x64 p5
     (4,096 cells, held to dgtpu's L2(u)) and its observed order from 16x16
     to 32x32 p2; the multigrid with FVM coarse levels in full precision
     (8x8 p1, 32x32 p_grid 2 / p1: dgtpu's cycles and L2(u)) and the mixed
     -> full fallback; ``-amp`` (DG 8x8 p5, FVM 8x8 p1 through the CLI;
     101x101 modes, min and max of A1-A4 held to dgtpu's, with the
     seconds); the six check switches (Poisson 8x8 p2, Stokes 4x4 local and
     global order) held to dgtpu's; the mixed route in the physical-element
     orthonormal basis (Poisson 8x8 p5, Stokes 8x8: graphed, held to the
     standard basis's routes, their kernels' launches counted, the cycle's
     graph against eager bit for bit); the 8x8 p5 mixed route twice with
     caching on (the second loads every level; the same L2(u) bit for bit;
     both setup times); the host C++ kernels (``dgtpu_torch/native``) against
     the plain torch ones at 8x8 p5; the phase's wall time;
 24. the sharded multigrid and the tools (``sharded_and_tools_phases``):
     the 64x64 p5 mixed route over 4 shards on the card (phase 6's
     hierarchy and FMG seed; held to phase 6's SoA-route nodal solution;
     one eager sharded float32 V-cycle timed),
     the 8x8 p5 full-precision sharded multigrid over 1, 2 and 4 shards
     (equal cycle counts, the 4-shard count dgtpu's, L2(u) within 1e-12),
     the Stokes mixed route over 4 shards (16x16, held to dgtpu's L2; 8x8
     with the Chebyshev velocity solver, phase 10's bars; the GMRES(16)
     refinement at 8x8), every operand and halo row on the card and no
     kernel launched by the sharded solves; ``--profile`` at 8x8 p5 (its
     trace holds K1's and K5's CUDA kernels); the convergence study (rates
     above p + 1 - 0.4) and the figure suite (dgtpu's file names where
     matplotlib imports); the phase's wall time.
Then the launch geometries at which K1, K6 and K7 were held to their plain
versions (a timed case at any other raises).  The last lines are the
kernels' JSON record (per kernel: launches on the main paths, worst error
against the plain version, its time eagerly and in a graph of 200
launches, the plain version's, the bound from bytes and operations, a
PyTorch call's time both ways where one computes the same function, and
which call, K1's, K4's, K5's, K6's and K7's launch grid; K4's case is the
shape with the most launches x time per cycle; beside the kernels, the
launch floor), the nvidia-smi line and
``{"ok": true, "device": {...}}``.  Exits non-zero without CUDA or without
the rest of the repository.

``--profile`` runs ``torch.profiler`` over the cycles of the four
configurations, of the 64x64 streamed hybrids and of the rolled cycle at
8x8 and 64x64 (kernel, plain and graphed paths:
device-busy time, device ops per cycle, the top device ops; for the graphed
cycles each kernel's launches and device us per cycle) and over single
calls of the SoA cycles' kernels at the finest levels' shapes (device us
per call, bytes moved, GB/s).
"""

import contextlib
import copy
import json
import logging
import math
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
# (soa, rolled) kernel libraries of the earlier tree given by --parent
PARENT = None

# dgtpu's L2(u) for the same route (8x8 p=5, mixed precision), computed on a
# CPU with the JAX reference package:
#   JAX_PLATFORMS=cpu python -c "from dgtpu.__main__ import main; \
#     print(repr(main(['-m', '--precision', 'mixed', '--silent', \
#     '--backend', 'cpu']).L2_error_u))"
DGTPU_L2_8X8_P5 = 5.109734421089843e-06
L2_REL_TOL = 1e-6          # port vs dgtpu, 8x8 p=5
KERNEL_REL_TOL = 1e-5      # f32 kernel vs f32 plain, relative to max|plain|
ROLLED_REL_TOL = 5e-6      # the same for the rolled kernels R1-R4
# dgtpu's L2(u) of the mixed route at 8x8 p=5 with geometric factors 8,4,2
# (six levels down to 1x1; its rolled cycle, 3 outer rounds), computed on a
# CPU with the JAX reference package: the command above with
# solver.multigrid.geometric_coarsening.coarsening_factors = "8,4,2"
DGTPU_L2_8X8_P5_ROLLED = 5.10973442100966e-06
SOLUTION_REL_TOL = 1e-8    # two solves of one discrete system, nodal values
RES_TOL = 1e-10            # normalized residual of the refined solve

# dgtpu's L2 errors of u, v and p for the Stokes route (p_u=2/p_p=1 with
# bench._stokes_settings(n)), computed on a CPU with the JAX reference
# package.  The mixed route converges to the same discrete system, so it is
# held to dgtpu's direct solve.  8x8:
#   JAX_PLATFORMS=cpu python -c "import bench; from dgtpu.api import DGFEM; \
#     s = bench._stokes_settings(8); s.solver.method = 'direct'; \
#     dg = DGFEM(settings=s, solve_direct=True); dg.solve(); \
#     print(dg.L2_error_u, dg.L2_error_v, dg.L2_error_p)"
# 32x32: the same command with n = 32 and dgtpu.solvers.direct.solve_direct
# replaced by scipy.sparse.linalg.spsolve of the same pinned saddle matrix
# (the dense LU of 22,528 unknowns does not fit; at 8x8 the sparse and the
# dense solve agree to 3e-14).
DGTPU_STOKES_L2 = {
    8: {"u": 0.011376812893912363, "v": 0.011376520781395932,
        "p": 0.04501405866873862},
    # 16x16 (phase 24's sharded Stokes case): the 8x8 command with n = 16
    16: {"u": 0.0013386720061285124, "v": 0.0013386721057439355,
         "p": 0.009049827174525066},
    32: {"u": 0.0001539444269394462, "v": 0.00015394453731214222,
         "p": 0.0021337602694521955},
}
STOKES_CYCLE_REL_TOL = 5e-3   # whole f32 W-cycle, kernels vs plain (dgtpu's
                              # bound between its f32 fused and XLA cycles)
# the bound of a kernel: the larger of its bytes over the memory rate and its
# float32 operations over the rate outside the tensor cores (NVIDIA H100 SXM
# data sheet, at a 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def settings_for(grid, p, o_grid=False, p_levels="5,3,1", factors="2", fmg=False):
    from dgtpu_torch.settings import Settings, load_params
    params = load_params()
    params["grid"]["filename"] = grid
    params["grid"]["polynomial degree"] = p
    params["grid"]["O grid"] = o_grid
    params["grid"]["circular"] = o_grid
    params["solution"]["u"]["polynomial degree"] = p
    mg = params["solver"]["multigrid"]
    mg["polynomial coarsening"]["levels"]["u"] = p_levels
    mg["geometric coarsening"]["coarsening factors"] = factors
    mg["full multigrid"] = fmg
    params["performance"]["precision"] = "mixed"
    if o_grid:
        params["problem"]["SIP penalty parameter multiplier"] = 2
    params["visualization"]["export"] = False
    params["logging"]["loglevel"] = "ERROR"
    return Settings(params)


def stokes_params(n):
    """The paramfile tree of dgtpu's Stokes flagship settings
    (bench._stokes_settings(n)) for the port's mixed route: n x n
    p_u=2/p_p=1 global order, p 2->1 plus geometric 2x2 levels down to 2x2
    elements, distributive-GS 2/2 W-cycles, direct coarse solve."""
    from dgtpu_torch.settings import load_params
    params = load_params()
    params["problem"]["type"] = "Stokes"
    params["grid"]["filename"] = f"Rectangle_{n}X{n}_nPoly2.xyz"
    params["grid"]["polynomial degree"] = 2
    params["solution"]["u"]["polynomial degree"] = 2
    params["solution"]["p"]["polynomial degree"] = 1
    params["solution"]["ordering"] = "global"
    mg = params["solver"]["multigrid"]
    mg["penalty parameter coarsening"]["enabled"] = False
    mg["polynomial coarsening"]["enabled"] = True
    mg["polynomial coarsening"]["levels"]["u"] = "1,2"
    mg["geometric coarsening"]["enabled"] = True
    mg["geometric coarsening"]["coarsening factors"] = ",".join(
        str(2 ** k) for k in range(1, n.bit_length() - 1))
    for node in ("polynomial coarsening", "geometric coarsening"):
        for side in ("pre smoother", "post smoother"):
            mg[node][side]["smoother"] = "distributive_gauss_seidel"
            mg[node][side]["iterations"] = 2
    mg["cycle type"] = "W"
    mg["coarse grid solver"] = "direct"
    params["performance"]["dgs_splitting"] = "lsq"
    params["performance"]["precision"] = "mixed"
    params["visualization"]["export"] = False
    params["visualization"]["automatically open paraview"] = False
    params["logging"]["loglevel"] = "ERROR"
    return params


def hierarchy(settings):
    """Assembled DGFEM (float64 on the card) for ``settings``."""
    from dgtpu_torch.api import DGFEM
    return DGFEM(device="cuda", settings=settings, solve_multigrid=True)


def cycle_of(dg, **kw):
    import torch
    from dgtpu_torch.ops.soa import SoAVCycle
    dims = [(l.Nj, l.Ni) for l in dg.levels]
    return SoAVCycle([l.op for l in dg.levels], dg.transfers,
                     dg.transfer_types, dg.settings, dims,
                     dtype=torch.float32, device="cuda", **kw)


def cuda_ms(fn, n):
    """Mean milliseconds per call of ``fn`` over ``n`` calls (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n=200):
    """Mean milliseconds per call of ``fn`` with ``n`` calls captured in one
    CUDA graph and replayed (CUDA events over the replays)."""
    import torch
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_ms(graph.replay, 5) / n


def small_gemm_library(W, x, base=None):
    """One PyTorch call computing K3's function: (base +) W x per batch
    entry."""
    import torch
    if base is None:
        return lambda: torch.matmul(W, x)
    return lambda: torch.baddbmm(base, W.expand(x.shape[0], *W.shape), x)


def four_ways(label, kern, args, library, card):
    """A kernel and its library call, each timed eagerly back to back and as
    200 launches captured in one CUDA graph; prints and returns (ms,
    graph ms, library ms, library graph ms)."""
    times = (cuda_ms(lambda: kern(*args), 200), graph_ms(lambda: kern(*args)),
             cuda_ms(library, 200), graph_ms(library))
    print(f"{label}: kernel {times[0]:.4f} ms eager, {times[1]:.4f} ms in a graph; "
          f"library {times[2]:.4f} ms eager, {times[3]:.4f} ms in a graph ({card})",
          flush=True)
    return times


def launch_floor(card):
    """The card's launch floor: one empty kernel timed eagerly and as 200
    launches captured in one CUDA graph; prints and returns {"ms", "graph_ms"}."""
    from dgtpu_torch.ops import _kernels
    floor = {"ms": cuda_ms(_kernels.empty, 200), "graph_ms": graph_ms(_kernels.empty)}
    print(f"[2] launch floor (an empty kernel, 1 CTA of 32 threads): {floor['ms']:.5f} ms "
          f"eager, {floor['graph_ms']:.5f} ms in a graph ({card})", flush=True)
    return floor


def library_of(kern, args):
    """(call, what it is) of one PyTorch call that computes the function of
    ``kern`` at ``args`` (with an add where a base is folded in), on inputs
    gathered before it (the gather not timed); None where there is none."""
    import torch
    from dgtpu_torch.ops import rolled, soa, vcycle
    if kern is soa.small_gemm:           # P e + u: one baddbmm
        return small_gemm_library(*args), "torch.baddbmm or torch.matmul"
    if kern is vcycle.transfer:          # P e + u per cell, as one addmm
        T, x, _, base = args
        return (lambda: torch.addmm(base.flatten(0, 1), x.flatten(0, 1), T.T)), \
            "torch.addmm"
    if kern is vcycle.dense_apply:
        W, x = args
        return (lambda: torch.mv(W, x.reshape(-1))), "torch.mv"
    if kern is soa.geo_transfer:
        T4, x, dims_c, restrict, *base = args
        ch_c, ch_q, par = (torch.as_tensor(a, device=x.device)
                           for a in soa._geo_maps(*dims_c))
        if restrict:
            g = x[ch_c, :, ch_q]                      # (2, 4, Cc, B)
            return (lambda: torch.einsum("kab,ckqb->caq", T4, g)), \
                "torch.einsum, gather not timed"
        g, Tp = x[par[0], :, par[1]], T4[par[2]]      # (2, Cf, B_c), (2, Cf, B, B_c)
        if not base:
            return (lambda: torch.einsum("cpab,cpb->cap", Tp, g)), \
                "torch.einsum, gather not timed"
        return (lambda: torch.einsum("cpab,cpb->cap", Tp, g).add_(base[0])), \
            "torch.einsum + add_, gather not timed"
    if kern is soa.stencil_apply:
        lv, blk, x, *rest = args
        base, sign = (rest + [None, 1.0])[:2]
        # per color: its own field and the other color's four neighbor
        # fields, (2, 5, B_src, C); narrower blocks widened before the call
        g = torch.stack([torch.stack((x[c], *soa._nbr_fields(x[1 - c], c, lv.masks, lv.nh,
                                                             lv.periodic)))
                         for c in (0, 1)])
        w = blk.to(x.dtype)
        if base is None:
            return (lambda: torch.einsum("ksbac,ksbc->kac", w, g).mul_(sign)), \
                "torch.einsum + mul_, gather not timed"
        return (lambda: torch.add(base, torch.einsum("ksbac,ksbc->kac", w, g),
                                  alpha=sign)), "torch.einsum + add, gather not timed"
    if kern is vcycle.stencil_apply:
        lv, x, *rest = args
        base, sign = (rest + [None, 1.0])[:2]
        g = torch.stack((x, *rolled.neighbor_fields(x)), dim=2)    # (Nj, Ni, 5, B)
        if base is None:
            return (lambda: torch.einsum("jisab,jisb->jia", lv.blocks, g).mul_(sign)), \
                "torch.einsum + mul_, gather not timed"
        return (lambda: torch.add(base, torch.einsum("jisab,jisb->jia", lv.blocks, g),
                                  alpha=sign)), "torch.einsum + add, gather not timed"
    return None


@contextlib.contextmanager
def kernels_of(libs):
    """Inside the block the kernel wrappers launch from ``libs`` (soa,
    rolled), the earlier tree's libraries; None leaves this tree's."""
    from dgtpu_torch.ops import _kernels
    saved = _kernels.library, _kernels.rolled_library
    if libs is not None:
        _kernels.library, _kernels.rolled_library = (lambda: libs[0]), (lambda: libs[1])
    try:
        yield
    finally:
        _kernels.library, _kernels.rolled_library = saved


def parent_turns(label, fn, time_fn, card, bitwise):
    """With ``--parent``: ``fn()`` under the earlier tree's kernels against
    this tree's (bit for bit where ``bitwise``, else relative), then
    ``time_fn()`` under both in turns (earlier, this, this, earlier);
    prints them.  Without it, nothing."""
    import torch
    if PARENT is None:
        return
    with kernels_of(PARENT):
        old = fn()
    new = fn()
    torch.cuda.synchronize()
    same = torch.equal(old, new)
    rel = float((new - old).abs().max() / max(float(old.abs().max()), 1e-30))
    times = {"earlier": [], "this": []}
    for name in ("earlier", "this", "this", "earlier"):
        with kernels_of(PARENT if name == "earlier" else None):
            times[name].append(time_fn())
    print(f"{label}, earlier tree against this one: equal bit for bit {same} (rel "
          f"{rel:.2e}); ms earlier {times['earlier'][0]:.5f}, {times['earlier'][1]:.5f}, "
          f"this {times['this'][0]:.5f}, {times['this'][1]:.5f} ({card})", flush=True)
    if bitwise and not same:
        raise AssertionError(f"{label}: the results changed from the earlier tree's")


# host operations of one graphed call: the replay, the two input copies and
# the clone of the output
GRAPH_HOST_OPS = 4


def in_turns(cyc, rhs, k, bitwise=True):
    """Marginal ms of ``cyc`` eager and replayed as a CUDA graph, in turns
    (eager, graph, graph, eager); with the capture's ms and the kernel
    launches per cycle.  With ``--parent`` the same cycle is also captured
    with the earlier tree's kernels, held to this tree's graph (bit for bit
    where ``bitwise``) and timed between the two graphed turns (graph,
    earlier, earlier, graph)."""
    import torch
    from dgtpu_torch.ops.graphs import CycleGraph
    graph = CycleGraph(cyc)
    zero = torch.zeros_like(rhs)
    graph(rhs, zero)
    reset_counts()
    out = graph(rhs, zero)
    torch.cuda.synchronize()
    launches = sum(counts().values())
    t = {"capture_ms": graph.capture_seconds * 1e3, "launches": launches}
    if PARENT is None:
        e1, g1, g2, e2 = (marginal_ms(f, rhs, k) for f in (cyc, graph, graph, cyc))
        return {**t, "eager": (e1, e2), "graph": (g1, g2)}
    earlier = CycleGraph(cyc)
    with kernels_of(PARENT):
        old = earlier(rhs, zero)
    torch.cuda.synchronize()
    if bitwise and not torch.equal(old, out):
        raise AssertionError("the graphed cycle's results changed from the earlier "
                             "tree's")
    e1, g1, p1, p2, g2, e2 = (marginal_ms(f, rhs, k)
                              for f in (cyc, graph, earlier, earlier, graph, cyc))
    return {**t, "eager": (e1, e2), "graph": (g1, g2), "earlier": (p1, p2),
            "earlier_rel": float((out - old).abs().max() / old.abs().max())}


def turns_text(t):
    earlier = ("" if "earlier" not in t else
               f"; the earlier tree's kernels graphed {t['earlier'][0]:.4f}, "
               f"{t['earlier'][1]:.4f} ms (rel {t['earlier_rel']:.2e} from this tree's)")
    return (f"eager {t['eager'][0]:.4f}, {t['eager'][1]:.4f} ms, graphed "
            f"{t['graph'][0]:.4f}, {t['graph'][1]:.4f} ms (capture "
            f"{t['capture_ms']:.1f} ms){earlier}; {t['launches']} kernel launches per "
            f"cycle, {GRAPH_HOST_OPS} host operations per graphed cycle")


def check_graph(label, fn, n, n_in, rng):
    """``fn`` captured as a CUDA graph against the same eager call on two
    random input sets, bit for bit; then every launch counter after 3
    replays against 3 x the eager call's.  Raises on any difference."""
    import torch
    from dgtpu_torch.ops.graphs import CycleGraph
    rand = _rand(rng)
    inputs = [tuple(rand(n) for _ in range(n_in)) for _ in range(2)]
    graph = CycleGraph(fn)
    for x in inputs:
        got, ref = graph(*x), fn(*x)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            raise AssertionError(f"{label}: graph differs from eager by "
                                 f"{float((got - ref).abs().max()):.3e}")
    reset_counts()
    fn(*inputs[0])
    per_call = counts()
    reset_counts()
    for _ in range(3):
        graph(*inputs[1])
    torch.cuda.synchronize()
    if counts() != {k: 3 * v for k, v in per_call.items()} or CycleGraph.replays != 3:
        raise AssertionError(f"{label}: launch counters after 3 replays {counts()} "
                             f"vs 3 x {per_call}")
    print(f"{label}: graph equals eager bit for bit on 2 inputs; 3 replays counted "
          f"3 x {sum(per_call.values())} kernel launches "
          f"{ {k: v for k, v in per_call.items() if v} }; capture "
          f"{graph.capture_seconds * 1e3:.1f} ms", flush=True)


def sweep_grid(kern, args, kw=None):
    """(cell tiles or clusters, CTAs per cluster, output modes per CTA,
    threads per CTA) that the launcher of K1, K6 or K7 picks for ``args``
    (K7: with the keyword ``clusters`` in ``kw``, that many)."""
    from dgtpu_torch.ops import _kernels, soa, stream
    from dgtpu_torch.ops import stokes_stream as sst
    if kern is soa.half_sweep:
        B, C = args[1].shape[1:]
        return _kernels.half_sweep_grid(B, C)
    if kern is stream.multi_half_sweep:
        import torch
        blocks = args[1]
        grid = _kernels.multi_half_sweep_grid(blocks.shape[2], blocks.shape[4],
                                              blocks.dtype == torch.bfloat16)
        clusters = (kw or {}).get("clusters")
        return grid if clusters is None else (clusters, *grid[1:])
    lv = args[0].lv if kern is sst.dg_pass else args[0]
    _, _, Bu, Np, C = lv.D.shape
    return _kernels.dg_half_sweep_grid(Np, C, Bu)


def grid_record(kern, args, kw=None):
    """The launch geometry of K1, K4, K5, K6 or K7 at ``args`` as its
    launcher picks it (a dict for the records), else None."""
    from dgtpu_torch.ops import _kernels, soa
    if kern is soa.stencil_apply:
        blk = args[1]
        *grid, threads = _kernels.stencil_apply_grid(blk.shape[3], blk.shape[4])
        return {"grid": grid, "threads": threads}
    if kern is soa.geo_transfer:
        T4, x, (njc, nic), restrict = args[:4]
        *grid, threads = _kernels.geo_transfer_grid(
            T4.shape[1], njc * (nic // 2) * (1 if restrict else 4))
        return {"grid": grid, "threads": threads}
    if launched(kern) in cluster_kernels():
        return dict(zip(("tiles", "cluster", "rows", "threads"),
                        sweep_grid(kern, args, kw)))
    return None


def grid_text(g):
    """A launch geometry from ``grid_record`` in words."""
    if "grid" in g:
        gx, gy, gz = g["grid"]
        return f"grid {gx}x{gy}x{gz} = {gx * gy * gz} CTAs of {g['threads']} threads"
    return (f"{g['tiles']} cluster(s) of {g['cluster']} CTAs of {g['rows']} output "
            f"modes, {g['threads']} threads each")


def kernel_times(label, kern, args, card, n_graph=200):
    """K1, K5, K6 or K7 at ``args`` eagerly and in a graph of ``n_graph``
    calls beside its bound (K7: and its streaming floor; K5: and its library
    call, ``library_of``, both ways), with the grid its
    launcher picks (and with ``--parent`` the earlier tree's kernel both ways
    in turns, held to this tree's bit for bit); prints them.  Raises if
    check_kernels held a cluster kernel at no such grid."""
    from dgtpu_torch.ops import soa, stream
    from dgtpu_torch.ops import stokes_stream as sst
    floor = ""
    if kern is soa.stencil_apply:
        blk = args[1]
        shape = (f"{blk.shape[2]} -> {blk.shape[3]} modes, C {blk.shape[4]}, "
                 f"{str(blk.dtype)[6:]} blocks")
    elif kern is soa.half_sweep:
        shape = f"B {args[1].shape[1]}, C {args[1].shape[2]}"
    elif kern is stream.multi_half_sweep:
        blk = args[1]
        shape = (f"B {blk.shape[2]}, C {blk.shape[4]}, {args[5]} half-sweeps, "
                 f"{str(blk.dtype)[6:]} blocks")
        size = stream_floor(args)
        floor = (f", streaming floor {size / HBM_BYTES_PER_S * 1e3:.6f} ms "
                 f"({size / 1e6:.3f} MB)")
    else:
        lv = args[0].lv if kern is sst.dg_pass else args[0]
        shape = f"Bu {lv.D.shape[2]} -> Np {lv.D.shape[3]}, C {lv.D.shape[4]}"
    label = f"{label} ({shape})"
    run = lambda: kern(*args)                   # noqa: E731
    ms = cuda_ms(run, 200)
    g_ms = graph_ms(run, n_graph)
    b_ms, b_by = bound(kern, args)
    grid = grid_record(kern, args)
    library = library_of(kern, args) if kern is soa.stencil_apply else None
    if library is not None:
        floor += (f"; library {cuda_ms(library[0], 200):.5f} ms eager, "
                  f"{graph_ms(library[0], n_graph):.5f} ms in a graph ({library[1]})")
    print(f"{label}: kernel {ms:.5f} ms eager, {g_ms:.5f} ms in a graph, bound "
          f"{b_ms:.6f} ms ({b_by}){floor}; {grid_text(grid)} ({card})", flush=True)
    if launched(kern) in cluster_kernels() and tuple(grid.values()) \
            not in CHECKED_GRIDS.get(launched(kern), ()):
        raise AssertionError(f"{label}: timed at a launch geometry that no check held "
                             "to the plain version")
    parent_turns(f"{label} eager", run, lambda: cuda_ms(run, 200), card, True)
    parent_turns(f"{label} in a graph", run, lambda: graph_ms(run, n_graph), card, True)


def k4_tally(cyc, rhs):
    """{(T4 shape, coarse dims, restriction, with a base): launches} of K4 in
    one eager cycle of ``cyc`` from zero."""
    import torch
    from dgtpu_torch.ops import _kernels
    seen = {}
    launch = _kernels.geo_transfer

    def tally(T4, x, dims_c, restrict, base=None):
        key = (tuple(T4.shape), tuple(dims_c), bool(restrict), base is not None)
        seen[key] = seen.get(key, 0) + 1
        return launch(T4, x, dims_c, restrict, base)
    _kernels.geo_transfer = tally
    try:
        cyc(rhs, torch.zeros_like(rhs))
        torch.cuda.synchronize()
    finally:
        _kernels.geo_transfer = launch
    return seen


def geo_transfer_table(configs, card):
    """K4 at every shape the main paths give it: for each (name, cycle, rhs,
    cases) in ``configs``, each K4 case of ``cases`` with its launches in one
    cycle, eagerly and in a graph of 200 launches, its bound, launch grid and
    library call both ways (with ``--parent``: the earlier tree's K4 both
    ways in turns, held to this tree's bit for bit); prints a line each.
    Returns the rows, with (args, ms, graph ms) and the launches per cycle."""
    from dgtpu_torch.ops import soa
    rows = []
    for name, cyc, rhs, cases in configs:
        per_cycle = k4_tally(cyc, rhs)
        for kern, args in cases:
            if kern is not soa.geo_transfer:
                continue
            T4, x, dims_c, restrict, *base = args
            key = (tuple(T4.shape), tuple(dims_c), bool(restrict), bool(base))
            run = lambda: kern(*args)                   # noqa: E731
            ms, g_ms = cuda_ms(run, 200), graph_ms(run)
            b_ms, b_by = bound(kern, args)
            lib, what = library_of(kern, args)
            lib_ms, lib_g_ms = cuda_ms(lib, 200), graph_ms(lib)
            c_out = dims_c[0] * (dims_c[1] // 2) * (1 if restrict else 4)
            label = (f"[12] K4 {name} {'restriction' if restrict else 'prolongation'}"
                     f"{' + base' if base else ''} {T4.shape[2]} -> {T4.shape[1]} modes, "
                     f"coarse {dims_c[0]}x{dims_c[1]}, {c_out} output cells per color")
            print(f"{label}: {per_cycle.get(key, 0)} launches per cycle; kernel "
                  f"{ms:.5f} ms eager, {g_ms:.6f} ms in a graph, bound {b_ms:.7f} ms "
                  f"({b_by}); {grid_text(grid_record(kern, args))}; library ({what}) "
                  f"{lib_ms:.5f} ms eager, {lib_g_ms:.6f} ms in a graph ({card})",
                  flush=True)
            parent_turns(f"{label} eager", run, lambda: cuda_ms(run, 200), card, True)
            parent_turns(f"{label} in a graph", run, lambda: graph_ms(run), card, True)
            rows.append({"args": args, "ms": ms, "graph_ms": g_ms,
                         "per_cycle": per_cycle.get(key, 0)})
    return rows


def solve_text(dg):
    """The solve's seconds and its graph captures', after checking that the
    route replayed a captured cycle."""
    if not dg.graphed:
        raise AssertionError(f"the {dg.cycle_kind} route ran its cycle eagerly")
    return f"solve {dg.solve_seconds:.3f} s + capture {dg.graph_seconds:.3f} s"


def stokes_cycle_of(dg, **kw):
    import torch
    from dgtpu_torch.ops.stokes_soa import SoAStokesVCycle
    return SoAStokesVCycle(dg.levels, dg.transfers, dg.transfer_types, dg.settings,
                           dtype=torch.float32, device="cuda", **kw)


def _rand(rng):
    import torch

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                               device="cuda")
    return rand


def stokes_level_cases(lv, rand):
    """(kernel, args) for K5 on each stencil of a Stokes level (with and
    without a base), K1 on the A part and K6 on both colors, each with and
    without a base as the sweep calls them."""
    from dgtpu_torch.ops import soa
    from dgtpu_torch.ops import stokes_soa as ss
    Bu, Np, C = lv.A.shape[2], lv.G.shape[2], lv.A.shape[4]
    uv, p = rand(2, Bu, C), rand(2, Np, C)
    cases = [(soa.stencil_apply, (lv, lv.A, uv, rand(2, Bu, C), -1.0)),
             (soa.stencil_apply, (lv, lv.G, p, rand(2, Bu, C), -1.0)),
             (soa.stencil_apply, (lv, lv.G, p, rand(2, Bu, C))),
             (soa.stencil_apply, (lv, lv.G, p)),
             (soa.stencil_apply, (lv, lv.D, uv, rand(2, Np, C), -1.0)),
             (soa.stencil_apply, (lv, lv.A, uv))]
    g = rand(2, Bu, C)
    for color in (0, 1):
        cases.append((soa.half_sweep, (lv.lvA, rand(2, Bu, C), uv, color)))
        cases.append((soa.half_sweep, (lv.lvA, rand(2, Bu, C), uv, color,
                                       rand(2, Bu, C))))
        cases.append((ss.dg_half_sweep, (lv, rand(2, Np, C), p, g, color,
                                         rand(2, Np, C))))
        cases.append((ss.dg_half_sweep, (lv, rand(2, Np, C), p, g, color)))
    return cases


def stokes_kernel_cases(cyc, rng):
    """(kernel, args) at every shape the Stokes cycle gives each kernel."""
    from dgtpu_torch.ops import soa
    rand = _rand(rng)
    cases = []
    for lv in cyc.levels:
        cases += stokes_level_cases(lv, rand)
    for k, t in enumerate(cyc.transfers):
        fine, coarse = cyc.levels[k + 1], cyc.levels[k]
        for comp, name in ((0, "A"), (1, "G")):
            # velocity (2Nu modes) and pressure (Np modes) lattices
            Bf, Cf = getattr(fine, name).shape[2], fine.A.shape[4]
            Bc, Cc = getattr(coarse, name).shape[2], coarse.A.shape[4]
            R, P = cyc.R[k][comp], cyc.P[k][comp]
            if t.kind == "polynomial":
                cases.append((soa.small_gemm, (R, rand(2, Bf, Cf))))
                cases.append((soa.small_gemm, (P, rand(2, Bc, Cc), rand(2, Bf, Cf))))
            else:
                cases.append((soa.geo_transfer, (R, rand(2, Bf, Cf), cyc.dims[k], True)))
                cases.append((soa.geo_transfer, (P, rand(2, Bc, Cc), cyc.dims[k],
                                                 False, rand(2, Bf, Cf))))
    if cyc.coarse_W is not None:
        cases.append((soa.small_gemm, (cyc.coarse_W, rand(1, cyc.coarse_W.shape[0], 1))))
    return cases


def synthetic_ogrid_level(rng, Bu=18, Np=4, nj=4, ni=4):
    """A Stokes level with random operands on an O-grid lattice (periodic in
    i), so the kernels' wrap branch runs: no Stokes O-grid hierarchy is held
    against dgtpu."""
    import numpy as np
    import torch
    from dgtpu_torch.ops.stokes_soa import StokesSoALevel
    rand = _rand(rng)
    nh = ni // 2
    C = nj * nh
    lanes_j, lanes_ip = np.repeat(np.arange(nj), nh), np.tile(np.arange(nh), nj)
    masks = np.stack([lanes_j % 2 == 0, lanes_ip == 0, lanes_ip == nh - 1])
    return StokesSoALevel(rand(2, 5, Bu, Bu, C), rand(2, 5, Np, Bu, C),
                          rand(2, 5, Bu, Np, C), rand(2, Bu, Bu, C),
                          rand(2, Np, Np, C), rand(2, Np, Np, C),
                          torch.as_tensor(masks[:, None, :], dtype=torch.float32,
                                          device="cuda"), nj, ni, True)


def plain_version(kern):
    """The plain torch version of a kernel wrapper."""
    from dgtpu_torch.ops import soa, stream, vcycle
    from dgtpu_torch.ops import stokes_soa as ss
    from dgtpu_torch.ops import stokes_stream as sst
    return {**soa.PLAIN, **ss.PLAIN, **stream.PLAIN, **vcycle.PLAIN,
            sst.dg_pass: sst.dg_pass_plain}[kern]


def kernel_name(kern):
    """A kernel wrapper's name in the records: the rolled cycle's carry a
    ``rolled_`` prefix (two of them share a name with an SoA kernel)."""
    from dgtpu_torch.ops import vcycle
    return ("rolled_" if kern in vcycle.KERNELS else "") + kern.__name__


def launched(kern):
    """The kernel wrapper whose kernel ``kern`` launches (the streamed DG
    pass is K6)."""
    from dgtpu_torch.ops import stokes_soa as ss
    from dgtpu_torch.ops import stokes_stream as sst
    return ss.dg_half_sweep if kern is sst.dg_pass else kern


# {K1, K6 or K7: the launch geometries (tiles, cluster, rows, threads) that
# check_kernels held to the plain version}
CHECKED_GRIDS = {}


def cluster_kernels():
    """The kernels that launch as thread-block clusters: K1, K6 and K7."""
    from dgtpu_torch.ops import soa, stream
    from dgtpu_torch.ops import stokes_soa as ss
    return (soa.half_sweep, ss.dg_half_sweep, stream.multi_half_sweep)


def check_kernels(cases, label, worst):
    """Each kernel's output against its plain version; records the worst
    (absolute, relative) error per kernel in ``worst``.  A case is (kernel,
    args) or (kernel, args, keyword args of the kernel only)."""
    import torch
    for kern, args, *kw in cases:
        got = kern(*args, **(kw[0] if kw else {}))
        ref = plain_version(kern)(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = err / max(float(ref.abs().max()), 1e-30)
        key = launched(kern)
        worst[key] = tuple(max(a, b) for a, b in zip(worst.get(key, (0.0, 0.0)),
                                                      (err, rel)))
        grid = grid_record(kern, args, kw[0] if kw else None) \
            if key in cluster_kernels() else None
        if grid is not None:
            CHECKED_GRIDS.setdefault(key, set()).add(tuple(grid.values()))
        print(f"[{label}] {kernel_name(kern):20s} shape {tuple(got.shape)}"
              f"{' ' + str(kw[0]) if kw else ''}: max abs err {err:.3e}, rel {rel:.3e}"
              f"{'; ' + grid_text(grid) if grid else ''}", flush=True)
        if not rel < KERNEL_REL_TOL:
            raise AssertionError(f"{kern.__name__} disagrees with its plain "
                                 f"version: rel {rel:.3e}")


def kernel_cases(cyc, rng):
    """(kernel, args) at every shape the cycle gives each kernel, with
    random inputs from ``rng``."""
    from dgtpu_torch.ops import soa
    rand = _rand(rng)
    cases = []
    for k, lv in enumerate(cyc.levels):
        B, C = lv.blocks.shape[2], lv.blocks.shape[4]
        rhs, u = rand(2, B, C), rand(2, B, C)
        for color in (0, 1):
            cases.append((soa.half_sweep, (lv, rhs, u, color)))
        if k > 0:
            cases.append((soa.stencil_apply, (lv, lv.blocks, u, rhs, -1.0)))
    for k, t in enumerate(cyc.transfers):
        Bc = cyc.levels[k].blocks.shape[2]
        B, C = cyc.levels[k + 1].blocks.shape[2], cyc.levels[k + 1].blocks.shape[4]
        Cc = cyc.levels[k].blocks.shape[4]
        if t.kind == "polynomial":
            cases.append((soa.small_gemm, (cyc.R[k], rand(2, B, C))))
            cases.append((soa.small_gemm, (cyc.P[k], rand(2, Bc, C), rand(2, B, C))))
        elif t.kind == "geometric":
            cases.append((soa.geo_transfer, (cyc.R[k], rand(2, B, C), cyc.dims[k], True)))
            cases.append((soa.geo_transfer, (cyc.P[k], rand(2, Bc, Cc), cyc.dims[k],
                                             False, rand(2, B, C))))
    if cyc.coarse_W is not None:
        cases.append((soa.small_gemm, (cyc.coarse_W, rand(1, cyc.coarse_W.shape[0], 1))))
    return cases


def marginal_ms(cyc, rhs, k=5):
    """Marginal time of one cycle: slope between k and 8k cycles."""
    import torch
    u = torch.zeros_like(rhs)

    def run(n):
        def go():
            v = u
            for _ in range(n):
                v = cyc(rhs, v)
        return cuda_ms(go, 1)
    return (run(8 * k) - run(k)) / (7 * k)


def stokes_phases(card, rng, worst):
    """Phases 8-12: the Stokes route.  Returns the launch counts of the 8x8
    CLI route and of the 32x32 route, {kernel: (args, ms, plain ms)} of K5
    and K6 at the 8x8 finest shapes, and the 8x8 and 32x32 DGFEMs."""
    import numpy as np
    import torch
    import yaml
    from dgtpu_torch.__main__ import main as cli
    from dgtpu_torch.api import DGFEM
    from dgtpu_torch.ops import soa
    from dgtpu_torch.ops import stokes_soa as ss
    from dgtpu_torch.settings import Settings

    # -- 8: each kernel of the Stokes cycle against its plain version ---------
    flagship = DGFEM(device="cuda", settings=Settings(stokes_params(8)),
                     solve_multigrid=True)
    cyc8 = stokes_cycle_of(flagship)
    check_kernels(stokes_kernel_cases(cyc8, rng), "8 Stokes 8x8", worst)
    check_kernels(stokes_level_cases(synthetic_ogrid_level(rng), _rand(rng)),
                  "8 synthetic O-grid", worst)

    # -- 9: one whole W-cycle, kernel path vs plain path ---------------------
    rhs = flagship.levels[-1].rhs
    u_k = cyc8(rhs, torch.zeros_like(rhs))
    u_p = stokes_cycle_of(flagship, reference=True)(rhs, torch.zeros_like(rhs))
    rel = float((u_k - u_p).abs().max() / u_p.abs().max())
    print(f"[9] one 8x8 Stokes W-cycle from zero: kernel vs plain max rel err "
          f"{rel:.3e} (bar {STOKES_CYCLE_REL_TOL:g})", flush=True)
    if not rel < STOKES_CYCLE_REL_TOL:
        raise AssertionError(f"the kernel Stokes cycle disagrees with the plain "
                             f"one: {rel:.3e}")
    check_graph("[9] 8x8 Stokes W-cycle", cyc8, rhs.numel(), 2, rng)
    check_graph("[9] 8x8 Stokes matvec", cyc8.build_matvec(), rhs.numel(), 1, rng)

    # -- 10: the Stokes CLI route at 8x8 -------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stokes_8x8.yml")
        with open(path, "w") as f:
            yaml.safe_dump(stokes_params(8), f)
        reset_counts()
        dg8 = cli(["-m", "--precision", "mixed", "--silent", "--paramfile", path])
        torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in ss.CYCLE_KERNELS}
    rel_l2 = check_stokes_errors(dg8, 8)
    print(f"[10] 8x8 Stokes CLI route: residual {dg8.solve_residual:.3e} "
          f"(normalized), {dg8.residual:.3e} (L2), inner {dg8.inner}, outer rounds "
          f"{dg8.rounds}, L2(u) {dg8.L2_error_u:.9e}, L2(v) {dg8.L2_error_v:.9e}, "
          f"L2(p) {dg8.L2_error_p:.9e} (rel to dgtpu {rel_l2}), "
          f"{solve_text(dg8)}; launches {launches}", flush=True)
    if not dg8.solve_residual < RES_TOL:
        raise AssertionError("the 8x8 Stokes solve did not reach 1e-10")
    not_launched(launches, list(launches), "the 8x8 Stokes route")

    # -- 11: the Stokes route at 32x32 ---------------------------------------
    t0 = time.perf_counter()
    dg32 = DGFEM(device="cuda", settings=Settings(stokes_params(32)),
                 solve_multigrid=True)
    setup_s = time.perf_counter() - t0
    reset_counts()
    dg32.solve()
    torch.cuda.synchronize()
    launches32 = {k.__name__: k.launches for k in ss.CYCLE_KERNELS}
    rel_l2 = check_stokes_errors(dg32, 32)
    ratios = {v: getattr(dg8, f"L2_error_{v}") / getattr(dg32, f"L2_error_{v}")
              for v in "uvp"}
    print(f"[11] 32x32 Stokes route ({len(dg32.levels)} levels): residual "
          f"{dg32.solve_residual:.3e} (normalized), inner {dg32.inner}, outer rounds "
          f"{dg32.rounds}, L2(u) {dg32.L2_error_u:.9e}, L2(v) {dg32.L2_error_v:.9e}, "
          f"L2(p) {dg32.L2_error_p:.9e} (rel to dgtpu {rel_l2}; below 8x8 by "
          f"{ {v: round(r, 2) for v, r in ratios.items()} }), setup {setup_s:.2f} s, "
          f"{solve_text(dg32)}; launches {launches32}", flush=True)
    if not dg32.solve_residual < RES_TOL:
        raise AssertionError("the 32x32 Stokes solve did not reach 1e-10")
    if not (ratios["u"] >= 8 and ratios["v"] >= 8 and ratios["p"] >= 4):
        raise AssertionError(f"32x32 errors not far enough below 8x8: {ratios}")
    not_launched(launches32, list(launches32), "the 32x32 Stokes route")
    # C = 128 and 512 on the finest levels: launches of several CTAs
    check_kernels(stokes_kernel_cases(stokes_cycle_of(dg32), rng), "11 Stokes 32x32",
                  worst)

    # -- 12: timings ---------------------------------------------------------
    for name, dg, k in (("8x8", flagship, 5), ("32x32", dg32, 2)):
        rhs = dg.levels[-1].rhs.to(torch.float32)
        cyc = stokes_cycle_of(dg)
        reset_counts()
        cyc(rhs, torch.zeros_like(rhs))
        torch.cuda.synchronize()
        per_cycle = {kk.__name__: kk.launches for kk in ss.CYCLE_KERNELS}
        t = in_turns(cyc, rhs, k)
        plain_ms = marginal_ms(stokes_cycle_of(dg, reference=True), rhs, k)
        size, b_ms = cycle_bound(dg)
        print(f"[12] {name} Stokes marginal W-cycle time: kernels {turns_text(t)}; "
              f"plain torch {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({size / 1e6:.3f} MB "
              f"of operands); kernel launches per cycle {per_cycle} ({card})",
              flush=True)
    for kern, args in stokes_kernel_cases(cyc8, np.random.default_rng(0)):
        if kern is soa.small_gemm:
            W, x = args[:2]
            four_ways(f"[12] small_gemm W {tuple(W.shape)} x {tuple(x.shape)}"
                      f"{' + base' if len(args) > 2 else ''} (8x8 Stokes)", kern, args,
                      small_gemm_library(*args), card)
    stokes_ms = {}
    for name, dg in (("8x8", flagship), ("32x32", dg32)):
        lv = stokes_cycle_of(dg).levels[-1]
        # the last case of each kernel: K5 on A, K6 on color 1
        timed = {kern: args for kern, args in stokes_level_cases(lv, _rand(rng))
                 if kern in (soa.stencil_apply, ss.dg_half_sweep)}
        for kern, args in timed.items():
            ms = cuda_ms(lambda: kern(*args), 200)
            plain_ms = cuda_ms(lambda: plain_version(kern)(*args), 200)
            print(f"[12] {kern.__name__} at {name} Stokes finest shapes: kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms ({card})", flush=True)
            stokes_ms.setdefault(kern, (args, ms, plain_ms))   # the 8x8 times
        Bu, Np, C = lv.A.shape[2], lv.G.shape[2], lv.A.shape[4]
        rand = _rand(rng)
        uv, p = rand(2, Bu, C), rand(2, Np, C)
        for what, args in (("A.uv + base", (lv, lv.A, uv, rand(2, Bu, C), -1.0)),
                           ("G.p", (lv, lv.G, p)),
                           ("D.uv + base", (lv, lv.D, uv, rand(2, Np, C), -1.0))):
            kernel_times(f"[12] K5 {what} at {name} Stokes finest shapes",
                         soa.stencil_apply, args, card)
        g = rand(2, Bu, C)
        for what, kern, args in (
                ("K1 on A, color 1 + base", soa.half_sweep,
                 (lv.lvA, rand(2, Bu, C), uv, 1, rand(2, Bu, C))),
                ("K6 color 1", ss.dg_half_sweep, (lv, rand(2, Np, C), p, g, 1)),
                ("K6 color 1 + base", ss.dg_half_sweep,
                 (lv, rand(2, Np, C), p, g, 1, rand(2, Np, C)))):
            kernel_times(f"[12] {what} at {name} Stokes finest shapes", kern, args, card)
    return launches, launches32, stokes_ms, flagship, dg32, dg8


def all_kernels():
    """Every kernel wrapper of the port: K1, K5, K3, K4, K6, K7, R1-R4."""
    from dgtpu_torch.ops import stokes_soa as ss
    from dgtpu_torch.ops import stream, vcycle
    return ss.CYCLE_KERNELS + stream.KERNELS + vcycle.KERNELS


def reset_counts():
    """Set the launch count of every kernel, and the CUDA graphs' counts of
    captures and replays, to 0."""
    from dgtpu_torch.ops import soa, stream, vcycle
    from dgtpu_torch.ops import stokes_soa as ss
    from dgtpu_torch.ops.graphs import CycleGraph
    soa.reset_launch_counts()
    ss.reset_launch_counts()
    stream.reset_launch_counts()
    vcycle.reset_launch_counts()
    CycleGraph.reset_counts()


def counts():
    return {kernel_name(k): k.launches for k in all_kernels()}


# the kernels the Poisson hybrid route launches: the SoA subtree's four and K7
POISSON_HYBRID_KERNELS = ("half_sweep", "stencil_apply", "small_gemm", "geo_transfer",
                          "multi_half_sweep")


def not_launched(launches, names, path):
    """Raise if a kernel of ``names`` has no launch in ``launches``."""
    missing = [n for n in names if launches[n] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by {path}: {missing}")


@contextlib.contextmanager
def stream_budget(budget):
    """The API's streaming budget set to ``budget`` bytes (None: the SoA
    cycle at any size) inside the block."""
    from dgtpu_torch import api
    saved = api.stream_budget
    api.stream_budget = lambda device: budget
    try:
        yield
    finally:
        api.stream_budget = saved


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def work(kern, args):
    """(bytes, float32 operations) that the function of one call must move
    and do: each input it reads once, each output written once."""
    from dgtpu_torch.ops import soa, stream, vcycle
    from dgtpu_torch.ops import stokes_soa as ss
    from dgtpu_torch.ops import stokes_stream as sst
    f32 = 4
    if kern is vcycle.half_sweep:           # blocks, Dinv, rhs of the color's cells only
        lv, rhs, u, color, *base = args
        nj, ni, B = u.shape
        active = (nj * ni + 1 - color) // 2
        return (active * (5 * B * B + B) * f32 + nbytes(u, *base) + nbytes(u),
                2 * 5 * B * B * active)
    if kern is vcycle.stencil_apply:
        lv, x, *base = args[:3]
        return nbytes(lv.blocks, x, *base[:1]) + nbytes(x), 2 * lv.blocks.numel()
    if kern is vcycle.transfer:
        T, x, *rest = args
        restrict = bool(rest) and rest[0]
        base = rest[1] if len(rest) > 1 else None
        b_out = T.shape[-2]
        cells = x.shape[0] * x.shape[1]
        if T.dim() == 3:
            cells = cells // 4 if restrict else cells * 4
        return (nbytes(T, x, base) + cells * b_out * f32,
                2 * cells * b_out * T.shape[-1] * (4 if T.dim() == 3 and restrict else 1))
    if kern is vcycle.dense_apply:
        W, x = args
        return nbytes(W, x) + nbytes(x), 2 * W.numel()
    if kern is sst.dg_pass:                 # K6 on the streamed level's view
        kern, args = ss.dg_half_sweep, (args[0].lv, *args[1:])
    if kern is soa.half_sweep:
        lv, rhs, u, color, *base = args
        B, C = rhs.shape[1:]
        return (nbytes(lv.blocks[color, 1:], lv.Dinv[color], rhs[color], u, *base)
                + nbytes(u), 2 * 5 * B * B * C)
    if kern is stream.multi_half_sweep:
        lv, blocks, Dinv, rhs, u, n_half, *base = args
        B, C = rhs.shape[1:]
        macs = n_half * 5 * B * B * C - (4 * B * B * C if u is None else 0)
        return nbytes(blocks[:, 1:], Dinv, rhs, u, *base) + nbytes(rhs), 2 * macs
    if kern is soa.stencil_apply:
        lv, blk, x, *base = args[:4]
        return nbytes(blk, x, *base[:1]) + 2 * blk.shape[3] * blk.shape[4] * f32, \
            2 * blk.numel()
    if kern is soa.small_gemm:
        W, x, *base = args
        (M, K), (batch, _, N) = W.shape, x.shape
        return nbytes(W, x, *base) + batch * M * N * f32, 2 * M * K * N * batch
    if kern is soa.geo_transfer:
        T4, x, (njc, nic), restrict, *base = args
        _, b_out, b_in = T4.shape
        c_out = njc * nic // 2 * (1 if restrict else 4)
        return nbytes(T4, x, *base) + 2 * b_out * c_out * f32, \
            2 * 2 * c_out * b_out * b_in * (4 if restrict else 1)
    if kern is ss.dg_half_sweep:
        lv, rhs, p, g, c, *base = args
        _, _, Bu, Np, C = lv.D.shape
        return (nbytes(lv.D[c], lv.DG_diag[c], lv.DG_Dinv[c], rhs[c], g, p, *base)
                + nbytes(p), 2 * (5 * Bu * Np + 2 * Np * Np) * C)
    raise KeyError(kern)


def stream_floor(args):
    """The bytes K7's call at ``args`` must stream when neither color's
    operand stays in L2 (64x64 p5: both colors' 106 MB pass the 50 MB L2):
    each half-sweep one color's blocks (slots 1..4) and Dinv, in their
    storage type; a first half-sweep from zero (``u`` None) reads no block."""
    lv, blocks, Dinv, rhs, u, n_half, *base = args
    per_color = nbytes(blocks[0, 1:], Dinv[0])
    return n_half * per_color - (nbytes(blocks[0, 1:]) if u is None else 0)


def bound(kern, args):
    """(least ms the card could take for one call, "bytes" or
    "operations")."""
    size, ops = work(kern, args)
    t_bytes, t_ops = size / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def profile(card):
    """``--profile``: torch.profiler device time over the kernel and plain
    cycles of the four configurations, and per call of each kernel at the
    finest levels' shapes (device us per recorded launch, unique bytes
    moved, GB/s)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity
    from dgtpu_torch.api import DGFEM
    from dgtpu_torch.ops import soa
    from dgtpu_torch.ops import stokes_soa as ss
    from dgtpu_torch.ops.graphs import CycleGraph
    from dgtpu_torch.settings import Settings

    def device_ops(fn, n):
        """Host us per call of ``fn`` over n profiled calls, and
        {device op: [count, us]} summed over them."""
        fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA],
                                    acc_events=True) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e6 / n
        ops = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                d = ops.setdefault(e.name, [0, 0.0])
                d[0] += 1
                d[1] += e.time_range.elapsed_us()
        return wall, ops

    configs = [
        ("Poisson 8x8 p5", lambda: hierarchy(settings_for("Rectangle_8X8_nPoly5.xyz", 5)),
         cycle_of, 20),
        ("Poisson 64x64 p5", lambda: hierarchy(settings_for(
            "Rectangle_64X64_nPoly5.xyz", 5, factors="16,8,4,2", fmg=True)), cycle_of, 20),
        ("Stokes 8x8", lambda: DGFEM(device="cuda", settings=Settings(stokes_params(8)),
                                     solve_multigrid=True), stokes_cycle_of, 10),
        ("Stokes 32x32", lambda: DGFEM(device="cuda", settings=Settings(stokes_params(32)),
                                       solve_multigrid=True), stokes_cycle_of, 3),
    ]
    l2_bytes = torch.cuda.get_device_properties(0).L2_cache_size
    for storage in ("float32", "bfloat16"):
        configs.append((f"Poisson 64x64 p5 hybrid {storage}", configs[1][1],
                        lambda dg, s=storage, **kw: hybrid_of(dg, l2_bytes, s, **kw), 20))
    configs += [
        ("Poisson 8x8 p5 rolled (factors 8,4,2)", lambda: hierarchy(settings_for(
            "Rectangle_8X8_nPoly5.xyz", 5, factors="8,4,2")), rolled_cycle_of, 20),
        ("Poisson 64x64 p5 rolled (factors 64,...,2)", lambda: hierarchy(settings_for(
            "Rectangle_64X64_nPoly5.xyz", 5, factors="64,32,16,8,4,2", fmg=True)),
         rolled_cycle_of, 20)]
    rand = _rand(np.random.default_rng(1))
    mb = lambda *ts: sum(t.numel() for t in ts) * 4 / 1e6   # noqa: E731
    for name, make, cycle, n in configs:
        dg = make()
        rhs = dg.levels[-1].rhs.to(torch.float32)
        for mode in ("kernels", "plain", "graphed"):
            cyc = cycle(dg, reference=mode == "plain")
            u0 = torch.zeros_like(rhs)
            if mode == "graphed":
                cyc = CycleGraph(cyc)
                cyc(rhs, u0)
            calls = max(1, n // 5) if mode == "plain" else n
            wall, ops = device_ops(lambda: cyc(rhs, u0), calls)
            busy = sum(v[1] for v in ops.values()) / calls
            top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:5]
            print(f"[prof] {name} {mode}: host "
                  f"{wall:.1f} us/cycle (profiled), device busy {busy:.1f} us/cycle, "
                  f"share {busy / wall:.4f}, device ops/cycle "
                  f"{sum(v[0] for v in ops.values()) / calls:.1f}; top (op, "
                  f"calls/cycle, us/cycle) "
                  f"{[(k[:40], v[0] / calls, round(v[1] / calls, 2)) for k, v in top]} "
                  f"({card})", flush=True)
            if mode == "graphed":
                by_kernel = {}
                for op, (n_op, us) in ops.items():
                    found = re.search(r"(\w+_kernel)\b", op)
                    d = by_kernel.setdefault(found.group(1) if found else op[:30], [0, 0.0])
                    d[0] += n_op
                    d[1] += us
                per_cycle = {k: (v[0] / calls, round(v[1] / calls, 2)) for k, v in
                             sorted(by_kernel.items(), key=lambda kv: -kv[1][1])}
                print(f"[prof] {name} graphed, by kernel (launches, device us per "
                      f"cycle): {per_cycle} ({card})", flush=True)
        cyc = cycle(dg)
        if not hasattr(cyc, "levels") or cycle is rolled_cycle_of:
            continue                         # the hybrids and the rolled cycle: cycles only
        lv = cyc.levels[-1]
        if cycle is cycle_of:
            B, C = lv.blocks.shape[2], lv.blocks.shape[4]
            u, r = rand(2, B, C), rand(2, B, C)
            cases = {
                "K1 half-sweep": (soa.half_sweep, (lv, r, u, 1),
                                  mb(lv.blocks[1, 1:], lv.Dinv[1], r[1], u, u)),
                "K5 residual": (soa.stencil_apply, (lv, lv.blocks, u, r, -1.0),
                                mb(lv.blocks, u, r, u)),
            }
        else:
            Bu, Np, C = lv.A.shape[2], lv.G.shape[2], lv.A.shape[4]
            uv, p, f, g = rand(2, Bu, C), rand(2, Np, C), rand(2, Np, C), rand(2, Bu, C)
            cases = {
                "K5 A.uv + base": (soa.stencil_apply, (lv, lv.A, uv, uv, -1.0),
                                   mb(lv.A, uv, uv, uv)),
                "K5 G.p": (soa.stencil_apply, (lv, lv.G, p), mb(lv.G, p, uv)),
                "K5 D.uv + base": (soa.stencil_apply, (lv, lv.D, uv, p, -1.0),
                                   mb(lv.D, uv, p, p)),
                "K6 color 1 + base": (ss.dg_half_sweep, (lv, f, p, g, 1, p),
                                      mb(lv.D[1], lv.DG_diag[1], lv.DG_Dinv[1], f[1],
                                         g, p, p, p)),
                "K1 on A + base": (soa.half_sweep, (lv.lvA, uv, uv, 1, uv),
                                   mb(lv.A[1, 1:], lv.A_Dinv[1], uv[1], uv, uv, uv)),
            }
        for case, (kern, args, size) in cases.items():
            _, ops = device_ops(lambda: kern(*args), 200)
            n_ev, us = max(ops.values(), key=lambda v: v[1])
            ev_us = cuda_ms(lambda: kern(*args), 200) * 1e3
            plain_us = cuda_ms(lambda: plain_version(kern)(*args), 200) * 1e3
            print(f"[prof] {name} {case}: device {us / n_ev:.2f} us/launch "
                  f"({n_ev} of 200 launches recorded), events {ev_us:.2f} us, "
                  f"plain {plain_us:.2f} us, {size:.3f} MB, "
                  f"{size * 1e-3 / (us / n_ev * 1e-6):.1f} GB/s ({card})", flush=True)


def hybrid_of(dg, budget, storage, reference=False):
    import torch
    from dgtpu_torch.ops.stream import StreamedVCycle
    dims = [(l.Nj, l.Ni) for l in dg.levels]
    return StreamedVCycle([l.op for l in dg.levels], dg.transfers, dg.transfer_types,
                          dg.settings, dims, budget, dtype=torch.float32,
                          device="cuda", block_storage=storage, reference=reference)


def stokes_hybrid_of(dg, budget):
    import torch
    from dgtpu_torch.ops.stokes_stream import StreamedStokesVCycle
    return StreamedStokesVCycle(dg.levels, dg.transfers, dg.transfer_types, dg.settings,
                                budget, dtype=torch.float32, device="cuda")


def cycle_bound(dg):
    """(operand bytes of the SoA cycle over ``dg``'s hierarchy, the least ms
    one cycle could take reading each of them once at the card's memory
    rate)."""
    from dgtpu_torch.ops.soa import SoAVCycle
    from dgtpu_torch.ops.stokes_soa import SoAStokesVCycle
    coarse = dg.settings.solver.multigrid.coarse_grid_solver in ("direct", "amg")
    if "p" in dg.vars:
        size = SoAStokesVCycle.device_bytes(dg.levels, dg.transfers, with_coarse=coarse)
    else:
        size = SoAVCycle.device_bytes([l.op for l in dg.levels],
                                      [(l.Nj, l.Ni) for l in dg.levels], dg.transfers,
                                      with_coarse=coarse)
    return size, size / HBM_BYTES_PER_S * 1e3


def cycles_in_turns(cycles, rhs, k, label, card):
    """Print each cycle's kernel launches per cycle and its marginal ms, eager
    and replayed as a CUDA graph, measured twice in turns (a, b, a graphed,
    b graphed, b graphed, a graphed, b, a): the host's noise drifts within a
    run.  With ``--parent`` each cycle is also captured with the earlier
    tree's kernels, held to this tree's graph bit for bit and timed in turns
    with it (this, earlier, earlier, this)."""
    import torch
    from dgtpu_torch.ops.graphs import CycleGraph
    zero = torch.zeros_like(rhs)
    graphs = {f"{name} graphed": CycleGraph(cyc) for name, cyc in cycles.items()}
    for g in graphs.values():
        g(rhs, zero)                                  # captured before timing
    if PARENT is not None:
        for name, cyc in cycles.items():
            graph, earlier = graphs[f"{name} graphed"], CycleGraph(cyc)
            with kernels_of(PARENT):
                old = earlier(rhs, zero)
            same = torch.equal(old, graph(rhs, zero))
            t = [marginal_ms(f, rhs, k) for f in (graph, earlier, earlier, graph)]
            print(f"[16] {label} {name} graphed, earlier tree against this one: equal "
                  f"bit for bit {same}; ms this {t[0]:.4f}, {t[3]:.4f}, earlier "
                  f"{t[1]:.4f}, {t[2]:.4f} ({card})", flush=True)
            if not same:
                raise AssertionError(f"{label} {name}: the graphed cycle's results "
                                     "changed from the earlier tree's")
    cycles = {**cycles, **graphs}
    times = {name: [] for name in cycles}
    launches = {}
    for name in list(cycles) + list(cycles)[::-1]:
        reset_counts()
        cycles[name](rhs, zero)
        torch.cuda.synchronize()
        launches[name] = {n: c for n, c in counts().items() if c}
        times[name].append(marginal_ms(cycles[name], rhs, k))
    for name, ms in times.items():
        extra = (f", capture {graphs[name].capture_seconds * 1e3:.1f} ms, "
                 f"{GRAPH_HOST_OPS} host operations per cycle" if name in graphs else "")
        print(f"[16] {label} {name}: {ms[0]:.4f}, {ms[1]:.4f} ms marginal, kernel "
              f"launches per cycle {sum(launches[name].values())} {launches[name]}"
              f"{extra} ({card})", flush=True)


def sweep_cases(lv, blocks, Dinv, rand):
    """K7 cases on one level: n_half 2 and 8, from u and from zero with a
    base, on the default grid, on one cluster (it strides over every cell
    tile) and on as many clusters as the card holds at once."""
    import torch
    from dgtpu_torch.ops import _kernels, stream
    B, C = Dinv.shape[1], Dinv.shape[3]
    r, u, base = rand(2, B, C), rand(2, B, C), rand(2, B, C)
    most = _kernels.resident_clusters(B, C, blocks.dtype == torch.bfloat16)
    k7 = stream.multi_half_sweep
    return [(k7, (lv, blocks, Dinv, r, u, 8)),
            (k7, (lv, blocks, Dinv, r, None, 8, base)),
            (k7, (lv, blocks, Dinv, r, u, 2)),
            (k7, (lv, blocks, Dinv, r, u, 8), {"clusters": 1}),
            (k7, (lv, blocks, Dinv, r, None, 8, base), {"clusters": most})]


def streamed_stokes_cases(sl, rand):
    """K6 as the streamed DG pass and K5 on the streamed operands of one
    Stokes level."""
    from dgtpu_torch.ops import soa
    from dgtpu_torch.ops import stokes_stream as sst
    lv = sl.lv
    Bu, Np, C = lv.A.shape[2], lv.G.shape[2], lv.A.shape[4]
    rhs, p, base, g, uv = (rand(2, Np, C), rand(2, Np, C), rand(2, Np, C),
                           rand(2, Bu, C), rand(2, Bu, C))
    return ([(sst.dg_pass, (sl, rhs, p, g, c, b)) for c in (0, 1) for b in (None, base)]
            + [(soa.stencil_apply, (lv, lv.A, uv, rand(2, Bu, C), -1.0)),
               (soa.stencil_apply, (lv, lv.G, p)),
               (soa.stencil_apply, (lv, lv.D, uv, rand(2, Np, C), -1.0))])


def synthetic_soa_level(rng, B, nj, ni):
    """A Poisson SoA level with random operands on an O-grid lattice
    (periodic in i), scaled so that repeated half-sweeps stay bounded."""
    import torch
    from dgtpu_torch.ops.soa import SoALevel, lane_masks
    rand = _rand(rng)
    C = nj * ni // 2
    return SoALevel(rand(2, 5, B, B, C) * (0.25 / B), rand(2, B, B, C) / B ** 0.5,
                    lane_masks(nj, ni, torch.float32, "cuda"), nj, ni, True)


def rolled_cycle_of(dg, settings=None, **kw):
    """The rolled cycle over ``dg``'s hierarchy, with ``settings`` in place
    of ``dg``'s when given."""
    import torch
    from dgtpu_torch.ops.vcycle import RolledVCycle
    dims = [(l.Nj, l.Ni) for l in dg.levels]
    return RolledVCycle([l.op for l in dg.levels], dg.transfers, dg.transfer_types,
                        settings or dg.settings, dims, dtype=torch.float32,
                        device="cuda", **kw)


def rolled_level_cases(lv, rand):
    """(kernel, args) for R1 on both colors and R2 as matvec and residual,
    each with and without a base, on one rolled level."""
    from dgtpu_torch.ops import vcycle
    shape = lv.Dinv.shape[:3]
    rhs, u, base = rand(*shape), rand(*shape), rand(*shape)
    cases = [(vcycle.stencil_apply, (lv, u)), (vcycle.stencil_apply, (lv, u, rhs, -1.0))]
    for color in (0, 1):
        cases += [(vcycle.half_sweep, (lv, rhs, u, color)),
                  (vcycle.half_sweep, (lv, rhs, u, color, base))]
    return cases


def rolled_kernel_cases(cyc, rng):
    """(kernel, args) at every shape the rolled cycle gives each kernel."""
    from dgtpu_torch.ops import vcycle
    rand = _rand(rng)
    cases = []
    for lv in cyc.levels:
        cases += rolled_level_cases(lv, rand)
    for k, (R, P) in enumerate(zip(cyc.R, cyc.P)):
        if R is None:
            continue
        fine, coarse = cyc.levels[k + 1].Dinv.shape[:3], cyc.levels[k].Dinv.shape[:3]
        cases += [(vcycle.transfer, (R, rand(*fine), True)),
                  (vcycle.transfer, (P, rand(*coarse))),
                  (vcycle.transfer, (P, rand(*coarse), False, rand(*fine)))]
    if cyc.coarse_inv is not None:
        cases.append((vcycle.dense_apply, (cyc.coarse_inv,
                                           rand(*cyc.levels[0].Dinv.shape[:3]))))
    return cases


def synthetic_rolled_level(rng, B, nj, ni):
    """A rolled level with random operands in every slot, so the wrapped
    i-neighbors count as on an O-grid; with an odd Ni the seam joins two
    cells of one color."""
    import torch
    from dgtpu_torch.ops import rolled
    from dgtpu_torch.ops.vcycle import RolledLevel
    rand = _rand(rng)
    return RolledLevel(rand(nj, ni, 5, B, B), rand(nj, ni, B, B),
                       rolled.color_masks(nj, ni, torch.float32, "cuda"))


def write_paramfile(tmp, name, **overrides):
    """A paramfile in ``tmp``: the shipped one with dotted-path overrides."""
    import yaml
    from dgtpu_torch.settings import load_params
    params = load_params()
    params["visualization"]["export"] = False
    for path, value in overrides.items():
        node = params
        *keys, leaf = path.split(".")
        for k in keys:
            node = node[k]
        node[leaf] = value
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        yaml.safe_dump(params, f)
    return path


# dgtpu's L2(u) of ``-m`` in full precision at 8x8 p=5 (the shipped
# paramfile; it stops at the configured tolerance 1e-6, so its L2(u) sits
# ~1e-4 relative off the converged 5.1097e-06), sequential (8 cycles) and
# red-black (7 cycles) smoothing, computed on a CPU with the JAX reference
# package: python -m dgtpu -m, and the same with
# performance.smoother_parallelization: redblack
DGTPU_L2_8X8_P5_FULL = {"sequential": (5.109094091008355e-06, 8),
                        "redblack": (5.109887574830018e-06, 7)}
FACTORS = "solver.multigrid.geometric coarsening.coarsening factors"


def rolled_phases(card, rng, worst, ogrid, u_soa64, soa_ms):
    """Phases 17-21: the rolled cycle and the full-precision routes.
    ``ogrid``: the assembled 4x4 O-grid DGFEM; ``u_soa64``: phase 6's nodal
    solution of the 64x64 SoA route; ``soa_ms``: phase 7's marginal SoA cycle
    times by configuration.  Returns the launch counts by path,
    {kernel: (args, ms, plain ms)} at the 64x64 p5 shapes and phase 20's
    ``-d`` L2(u)."""
    import torch
    from dgtpu_torch.__main__ import main as cli
    from dgtpu_torch.ops import soa, vcycle

    # -- 17: R1-R4 against their plain versions ------------------------------
    flagship = hierarchy(settings_for("Rectangle_8X8_nPoly5.xyz", 5, factors="8,4,2"))
    dims = [(l.Nj, l.Ni) for l in flagship.levels]
    if dims != [(1, 1), (2, 2), (4, 4), (8, 8), (8, 8), (8, 8)]:
        raise AssertionError(f"unexpected 8,4,2 hierarchy: {dims}")
    cyc8 = rolled_cycle_of(flagship)
    direct_settings = copy.deepcopy(flagship.settings)
    direct_settings.solver.multigrid.coarse_grid_solver = "direct"
    direct_settings.solver.multigrid.cycle_type = "F"
    cyc8_direct = rolled_cycle_of(flagship, direct_settings)
    t0 = time.perf_counter()
    dg64 = hierarchy(settings_for("Rectangle_64X64_nPoly5.xyz", 5,
                                  factors="64,32,16,8,4,2", fmg=True))
    setup_s = time.perf_counter() - t0
    for name, cases in (
            ("8x8 p5 factors 8,4,2", rolled_kernel_cases(cyc8, rng)),
            ("direct coarse", rolled_kernel_cases(cyc8_direct, rng)[-1:]),
            ("64x64 p5 factors 64,...,2", rolled_kernel_cases(rolled_cycle_of(dg64), rng)),
            ("4x4 O-grid p2", rolled_kernel_cases(rolled_cycle_of(ogrid), rng)),
            ("synthetic 2x3", rolled_level_cases(synthetic_rolled_level(rng, 16, 2, 3),
                                                 _rand(rng))),
            ("synthetic 3x1", rolled_level_cases(synthetic_rolled_level(rng, 36, 3, 1),
                                                 _rand(rng)))):
        check_kernels(cases, f"17 {name}", worst)
    check_rolled(worst)

    # -- 18: one whole rolled cycle, kernel path vs plain path ---------------
    rhs = flagship.levels[-1].rhs
    for name, st in (("V, smoother coarse", None), ("F, direct coarse", direct_settings)):
        u_k = rolled_cycle_of(flagship, st)(rhs, torch.zeros_like(rhs))
        u_p = rolled_cycle_of(flagship, st, reference=True)(rhs, torch.zeros_like(rhs))
        rel = float((u_k - u_p).abs().max() / u_p.abs().max())
        print(f"[18] one 8x8 p5 rolled cycle ({name}) from zero: kernel vs plain max rel "
              f"err {rel:.3e}", flush=True)
        if not rel < KERNEL_REL_TOL:
            raise AssertionError(f"the rolled kernel cycle disagrees with the plain "
                                 f"one: {rel:.3e}")
        check_graph(f"[18] 8x8 p5 rolled cycle ({name})", rolled_cycle_of(flagship, st),
                    rhs.numel(), 2, rng)

    # -- 19: the mixed route through the rolled cycle ------------------------
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        routes = {
            "rolled_8x8": write_paramfile(tmp, "rolled.yml", **{FACTORS: "8,4,2"}),
            "rolled_8x8_F_direct": write_paramfile(tmp, "rolled_f.yml", **{
                FACTORS: "8,4,2", "solver.multigrid.cycle type": "F",
                "solver.multigrid.coarse grid solver": "direct"}),
        }
        for name, path in routes.items():
            reset_counts()
            dg = cli(["-m", "--precision", "mixed", "--silent", "--paramfile", path])
            torch.cuda.synchronize()
            paths[name] = counts()
            l2_rel = abs(dg.L2_error_u - DGTPU_L2_8X8_P5_ROLLED) / DGTPU_L2_8X8_P5_ROLLED
            print(f"[19] {name} CLI route ({len(dg.levels)} levels): {dg.cycle_kind}, "
                  f"residual {dg.solve_residual:.3e} (normalized), {dg.outer_rounds} outer "
                  f"rounds, L2(u) {dg.L2_error_u:.14e} (dgtpu {DGTPU_L2_8X8_P5_ROLLED:.14e}, "
                  f"rel {l2_rel:.2e}), {solve_text(dg)}; launches "
                  f"{ {k: v for k, v in paths[name].items() if v} }", flush=True)
            if dg.cycle_kind != "rolled":
                raise AssertionError(f"{name} ran the {dg.cycle_kind} cycle")
            if not dg.solve_residual < RES_TOL or not l2_rel < L2_REL_TOL:
                raise AssertionError(f"{name} missed its bars")
    l2_mixed = dg.L2_error_u
    rolled_names = [kernel_name(k) for k in vcycle.KERNELS]
    soa_names = [k.__name__ for k in soa.KERNELS]
    not_launched(paths["rolled_8x8"], rolled_names[:3], "the rolled 8x8 route")
    not_launched(paths["rolled_8x8_F_direct"], rolled_names, "the rolled F-cycle route")

    reset_counts()
    dg64.solve()
    torch.cuda.synchronize()
    paths["rolled_64x64"] = counts()
    sol = float(abs(dg64.u_nodal - u_soa64).max() / abs(u_soa64).max())
    print(f"[19] 64x64 p5 route (factors 64,32,16,8,4,2, FMG; {len(dg64.levels)} levels "
          f"down to 1x1): {dg64.cycle_kind}, residual {dg64.solve_residual:.3e} "
          f"(normalized), {dg64.outer_rounds} outer rounds, L2(u) {dg64.L2_error_u:.9e}, "
          f"nodal u against phase 6's SoA route {sol:.2e} relative, setup {setup_s:.2f} s, "
          f"{solve_text(dg64)}; launches "
          f"{ {k: v for k, v in paths['rolled_64x64'].items() if v} }", flush=True)
    if dg64.cycle_kind != "rolled" or not dg64.solve_residual < RES_TOL:
        raise AssertionError("the 64x64 rolled route missed its bars")
    if not sol < SOLUTION_REL_TOL:
        raise AssertionError(f"the 64x64 rolled solution differs from the SoA route's: "
                             f"{sol:.3e}")
    not_launched(paths["rolled_64x64"], rolled_names[:3], "the rolled 64x64 route")
    for name, launches in paths.items():
        if any(launches[n] for n in soa_names):
            raise AssertionError(f"{name} launched SoA kernels: {launches}")

    # -- 20: the full-precision routes on the card ---------------------------
    with tempfile.TemporaryDirectory() as tmp:
        for strategy, (l2_ref, n_ref) in DGTPU_L2_8X8_P5_FULL.items():
            path = write_paramfile(
                tmp, f"{strategy}.yml",
                **{"performance.smoother_parallelization": strategy})
            dg = cli(["-m", "--silent", "--paramfile", path])
            torch.cuda.synchronize()
            tol = float(dg.settings.solver.multigrid.tolerance)
            rel = abs(dg.L2_error_u - l2_ref) / l2_ref
            print(f"[20] -m, precision full, {strategy} smoothing, 8x8 p5: {dg.cycles} "
                  f"cycles (dgtpu {n_ref}), residual {dg.solve_residual:.3e} (tolerance "
                  f"{tol:g}), L2(u) {dg.L2_error_u:.12e} (dgtpu {l2_ref:.12e}, rel "
                  f"{rel:.2e}; the mixed route's {l2_mixed:.12e}), solve "
                  f"{dg.solve_seconds:.3f} s with the solver's setup, "
                  f"{dg.solve_seconds / dg.cycles * 1e3:.2f} ms per cycle ({card})",
                  flush=True)
            if dg.levels[-1].rhs.device.type != "cuda":
                raise AssertionError("the full-precision route left the card")
            if dg.cycles != n_ref or not dg.solve_residual < tol or not rel < L2_REL_TOL:
                raise AssertionError(f"the full-precision {strategy} route missed its bars")
        dg = cli(["-d", "--silent"])
        torch.cuda.synchronize()
        l2_direct = dg.L2_error_u
        rel = abs(dg.L2_error_u - l2_mixed) / l2_mixed
        print(f"[20] -d, 8x8 p5: residual {dg.residual:.3e} (L2), L2(u) "
              f"{dg.L2_error_u:.12e} (rel to the mixed route {rel:.2e}), solve "
              f"{dg.solve_seconds:.3f} s ({card})", flush=True)
        if not rel < L2_REL_TOL:
            raise AssertionError("the direct solve's L2(u) differs from the mixed route's")
        dg = cli(["-s", "--smoother", "block_gauss_seidel", "--silent", "-f",
                  "Rectangle_8X8_nPoly2.xyz", "--p-grid", "2", "--p-solution", "2"])
        torch.cuda.synchronize()
        print(f"[20] -s block_gauss_seidel (sequential sweeps by wavefronts), 8x8 p2: "
              f"status {dg.smoother_status} after {dg.sweeps} sweeps, residual "
              f"{dg.residuals[-1]:.3e} (normalized), solve {dg.solve_seconds:.3f} s with "
              f"the setup, {dg.solve_seconds / dg.sweeps * 1e3:.2f} ms per symmetric sweep "
              f"({card})",
              flush=True)
        if dg.smoother_status != 0:
            raise AssertionError("the smoother solve did not converge")

    # -- 21: timings ---------------------------------------------------------
    timed = {}
    for name, dg, k in (("8x8 p5", flagship, 5), ("64x64 p5", dg64, 5)):
        rhs = dg.levels[-1].rhs.to(torch.float32)
        cyc = rolled_cycle_of(dg)
        reset_counts()
        cyc(rhs, torch.zeros_like(rhs))
        torch.cuda.synchronize()
        per_cycle = {n: c for n, c in counts().items() if c}
        t = in_turns(cyc, rhs, k, bitwise=False)
        plain_ms = marginal_ms(rolled_cycle_of(dg, reference=True), rhs, k)
        size = cyc.device_bytes()
        print(f"[21] {name} marginal rolled cycle time ({len(dg.levels)} levels): kernels "
              f"{turns_text(t)}; plain torch {plain_ms:.4f} ms, bound "
              f"{size / HBM_BYTES_PER_S * 1e3:.4f} ms ({size / 1e6:.3f} MB of operands, "
              f"device_bytes); the SoA cycle of phase 7 ({name}, its own hierarchy) "
              f"eager {soa_ms[name]['eager'][0]:.4f}, graphed "
              f"{soa_ms[name]['graph'][0]:.4f} ms; kernel launches per cycle "
              f"{per_cycle} ({card})", flush=True)
        lv = cyc.levels[-1]
        rand = _rand(rng)
        shape = lv.Dinv.shape[:3]
        r, u = rand(*shape), rand(*shape)
        top = len(cyc.levels) - 2
        geo = max(i for i, t in enumerate(cyc.transfers) if t.kind == "geometric")
        shape0 = cyc.levels[0].Dinv.shape[:3]
        mid = cyc.levels[-2]                  # the p3 level on the finest grid, B 16
        r16, u16 = rand(*mid.Dinv.shape[:3]), rand(*mid.Dinv.shape[:3])
        low = cyc.levels[-3]                  # the p1 level on the finest grid, B 4
        r4, u4 = rand(*low.Dinv.shape[:3]), rand(*low.Dinv.shape[:3])
        calls = {
            "R1 half-sweep, color 1": (vcycle.half_sweep, (lv, r, u, 1)),
            "R1 half-sweep on the B 16 level, color 0": (vcycle.half_sweep,
                                                         (mid, r16, u16, 0)),
            "R1 half-sweep on the B 4 level, color 1 + base": (vcycle.half_sweep,
                                                               (low, r4, u4, 1, r4)),
            "R2 residual": (vcycle.stencil_apply, (lv, u, r, -1.0)),
            "R2 residual on the B 16 level": (vcycle.stencil_apply, (mid, u16, r16, -1.0)),
            "R2 residual on the B 4 level": (vcycle.stencil_apply, (low, u4, r4, -1.0)),
            "R3 polynomial P e + u": (vcycle.transfer, (
                cyc.P[top], rand(*cyc.levels[top].Dinv.shape[:3]), False, u)),
            "R3 finest geometric restriction": (vcycle.transfer, (
                cyc.R[geo], rand(*cyc.levels[geo + 1].Dinv.shape[:3]), True)),
            "R3 finest geometric prolongation + u": (vcycle.transfer, (
                cyc.P[geo], rand(*cyc.levels[geo].Dinv.shape[:3]), False,
                rand(*cyc.levels[geo + 1].Dinv.shape[:3]))),
            "R4 dense inverse of the 1x1 coarsest level": (vcycle.dense_apply, (
                rand(math.prod(shape0), math.prod(shape0)), rand(*shape0))),
        }
        check_kernels(list(calls.values()), f"21 {name}", worst)
        check_rolled(worst)
        for label, (kern, args) in calls.items():
            ms = cuda_ms(lambda: kern(*args), 200)
            p_ms = cuda_ms(lambda: plain_version(kern)(*args), 50)
            b_ms, b_by = bound(kern, args)
            graphed = (vcycle.half_sweep, vcycle.stencil_apply, vcycle.transfer)
            in_graph = (f", {graph_ms(lambda: kern(*args)):.5f} ms in a graph"
                        if kern in graphed else "")
            print(f"[21] {label} at {name} finest shapes: kernel {ms:.4f} ms{in_graph}, "
                  f"plain {p_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}, "
                  f"{work(kern, args)[0] / 1e6:.3f} MB) ({card})", flush=True)
            if kern in graphed:
                run = lambda: kern(*args)              # noqa: E731
                for how, time_fn in (("eager", lambda: cuda_ms(run, 200)),
                                     ("in a graph", lambda: graph_ms(run))):
                    parent_turns(f"[21] {label} at {name} finest shapes, {how}", run,
                                 time_fn, card, kern is not vcycle.transfer)
            if name == "64x64 p5":
                timed.setdefault(kern, (args, ms, p_ms))
            if kern is vcycle.dense_apply:
                W, x = args
                four_ways(f"[21] R4 dense apply W {tuple(W.shape)} ({name})", kern, args,
                          lambda: torch.mv(W, x.reshape(-1)), card)
    return paths, timed, l2_direct


# dgtpu's -amg at 8x8 p=5 (the shipped paramfile with solver.amg.variant sa
# or rs): L2(u) and cycles, computed on a CPU with the JAX reference package:
#   JAX_PLATFORMS=cpu python -c "from dgtpu.api import DGFEM; \
#     from dgtpu.settings import Settings, load_params; p = load_params(); \
#     p['solver']['amg']['variant'] = 'sa'; p['visualization']['export'] = False; \
#     dg = DGFEM(settings=Settings(p), solve_pyamg=True); dg.solve(); \
#     print(repr(dg.L2_error_u))"
# and the cycles as len(info['residuals']) of dgtpu.solvers.amg.solve_amg on
# the finest level.  Neither reaches -d's L2(u) (solve_amg's tolerance is a
# fixed 1e-6): SA stops at its 1000-cycle cap 20x off, RS after 907 cycles
# 7% off, so phase 22 holds -amg to dgtpu's route, not to -d.
DGTPU_AMG_8X8_P5 = {"sa": (1.0857214233737187e-04, 1000),
                    "rs": (5.484347202041433e-06, 907)}
# phase 22's Krylov tolerance for Poisson, relative, on the preconditioned
# residual: the block-diagonal and SA-AMG preconditioned GMRES reach the
# discrete solution (L2(u) within 1e-10 of -d at 8x8 p5) only below ~1e-12.
# Stokes takes RES_TOL: at 1e-13 the multigrid-preconditioned GMRES at 32x32
# ends in NaN in its third restart, whose normal equations, solved by
# Cholesky as JAX's batched GMRES solves them, are no longer positive
# definite at the rounding floor (PERF.md section 7)
KRYLOV_TOL = 1e-13


class _Messages(logging.Handler):
    """Collects the messages of the loggers it is added to."""

    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def solver_route_phases(card, stokes_l2, l2_direct):
    """Phase 22: the routes outside the mixed multigrid, float64 plain torch
    on the card, each through the CLI with a temporary paramfile: Stokes
    (p_u=2/p_p=1, ``stokes_params``) ``-d`` at 8x8 in local and global order
    and at 32x32 in global order, ``-m`` in full precision at
    8x8 with the classical_exact and lsq splittings, ``-s`` with
    distributive GS (lsq), the mixed -> full fallback (8x8 with factors
    8,4,2: a 1x1 level, so no Stokes SoA cycle; both multigrid routes to
    the mixed route's 1e-10), ``-k`` GMRES (to 1e-10) with the
    multigrid (DGS lsq W-cycle) preconditioner at 8x8 and 32x32 and
    with the Schur block-diagonal one at 8x8; Poisson 8x8 p=5 (the shipped
    paramfile) ``-k`` GMRES with the block-diagonal, AMG and multigrid
    preconditioners, CG with a symmetric multigrid cycle (2/2 sweeps), all
    to KRYLOV_TOL, and ``-amg`` with sa and rs.  ``stokes_l2``: {n: {var:
    L2}} of the mixed Stokes routes at 8x8 and 32x32 (phases 10 and 11);
    ``l2_direct``: phase 20's ``-d`` L2(u).  Every solution is held to them
    within L2_REL_TOL, ``-amg`` to dgtpu's own route (DGTPU_AMG_8X8_P5: L2(u)
    and cycles), ``-s`` to status 0.  One line per route; the phase's wall time last."""
    import torch
    import yaml
    from dgtpu_torch.__main__ import main as cli
    t_phase = time.perf_counter()

    def run(tmp, name, argv, params, silent=True):
        path = os.path.join(tmp, f"{name}.yml")
        with open(path, "w") as f:
            yaml.safe_dump(params, f)
        dg = cli(argv + ["--device", "cuda", "--paramfile", path]
                 + (["--silent"] if silent else []))
        torch.cuda.synchronize()
        if dg.levels[-1].rhs.device.type != "cuda":
            raise AssertionError(f"{name} left the device")
        return dg

    def krylov_status(dg):
        """The true residual ||b - Au||_2 beside max(tol ||b||_2, atol), the
        bound of the route's post-solve audit.  Informational, not a check:
        the route stops on the preconditioned residual (JAX's rule), which
        can leave the true one above the bound, and then the audit warns, as
        dgtpu's does on the same case; the route is held to its L2 errors."""
        ks = dg.settings.solver.krylov
        rhs = dg.levels[-1].rhs
        res = dg.residual * math.sqrt(rhs.numel())      # residual is size-normalized
        bound = max(float(ks.tolerance) * float(torch.linalg.norm(rhs)),
                    float(ks.absolute_tolerance))
        side = "below" if res <= bound else "above"
        return (f"||b - Au|| {res:.3e}, {side} the audit's bound {bound:.3e} "
                "(informational: the route stops on the preconditioned residual)")

    def report(label, dg, count, status, ref, vars_):
        rel = {v: abs(getattr(dg, f"L2_error_{v}") - ref[v]) / ref[v] for v in vars_}
        errors = ", ".join(f"L1({v}) {getattr(dg, f'L1_error_{v}'):.9e} L2({v}) "
                           f"{getattr(dg, f'L2_error_{v}'):.9e}" for v in vars_)
        print(f"[22] {label}: {count}, status {status}, solve {dg.solve_seconds:.3f} s; "
              f"{errors} (L2 rel to the held value "
              f"{ {v: float(f'{r:.2e}') for v, r in rel.items()} }) ({card})", flush=True)
        if not all(r < L2_REL_TOL for r in rel.values()):
            raise AssertionError(f"{label}: L2 errors off the held values: {rel}")

    def stokes(n, **overrides):
        params = stokes_params(n)
        params["performance"]["precision"] = "full"
        for path, value in overrides.items():
            node = params
            *keys, leaf = path.split(".")
            for k in keys:
                node = node[k]
            node[leaf] = value
        return params

    with tempfile.TemporaryDirectory() as tmp:
        # -- Stokes -d -------------------------------------------------------
        for n, ordering in ((8, "local"), (8, "global"), (32, "global")):
            dg = run(tmp, f"stokes_d_{n}_{ordering}", ["-d"],
                     stokes(n, **{"solution.ordering": ordering}))
            if not dg.residual < 1e-12:
                raise AssertionError(f"Stokes -d {n}x{n}: residual {dg.residual:.3e}")
            report(f"Stokes -d, {n}x{n}, {ordering} order "
                   f"({dg.levels[-1].rhs.numel()} DOF)", dg, "dense LU",
                   f"residual {dg.residual:.3e} (L2)", stokes_l2[n], "uvp")
        # -- Stokes -m in full precision, to the mixed route's 1e-10 (at the
        # shipped 1e-6 the solution sits up to ~4e-6 off in L2(p)) -----------
        tight = {"solver.multigrid.tolerance": RES_TOL}
        for splitting in ("classical_exact", "lsq"):
            dg = run(tmp, f"stokes_m_{splitting}", ["-m"],
                     stokes(8, **{"performance.dgs_splitting": splitting}, **tight))
            tol = float(dg.settings.solver.multigrid.tolerance)
            if dg.cycle_kind != "full precision" or not dg.solve_residual < tol:
                raise AssertionError(f"Stokes -m full ({splitting}) missed its tolerance")
            report(f"Stokes -m, precision full, DGS {splitting}, 8x8 W-cycles",
                   dg, f"{dg.cycles} cycles", f"residual {dg.solve_residual:.3e} < {tol:g}",
                   stokes_l2[8], "uvp")
        # -- Stokes -s with distributive GS ----------------------------------
        dg = run(tmp, "stokes_s", ["-s", "--smoother", "distributive_gauss_seidel"],
                 stokes(8))
        print(f"[22] Stokes -s distributive_gauss_seidel (lsq), 8x8: {dg.sweeps} sweeps, "
              f"status {dg.smoother_status}, residual {dg.residuals[-1]:.3e} "
              f"(normalized), solve {dg.solve_seconds:.3f} s; L1(u) {dg.L1_error_u:.9e} "
              f"L2(u) {dg.L2_error_u:.9e} ({card})", flush=True)
        if dg.smoother_status != 0:
            raise AssertionError("the Stokes DGS smoother solve did not converge")
        # -- the mixed -> full fallback --------------------------------------
        seen = _Messages()
        logger = logging.getLogger("dgtpu_torch.api")
        logger.addHandler(seen)
        try:
            dg = run(tmp, "stokes_fallback", ["-m"], stokes(8, **{
                "performance.precision": "mixed", "logging.loglevel": "WARNING",
                "solver.multigrid.geometric coarsening.coarsening factors": "8,4,2"},
                **tight), silent=False)
        finally:
            logger.removeHandler(seen)
        logged = [m for m in seen.messages if m.endswith("running full precision")]
        if not logged or dg.cycle_kind != "full precision":
            raise AssertionError("the mixed Stokes route did not fall back to full "
                                 f"precision: {seen.messages}")
        report(f"Stokes -m, precision mixed, 8x8 with factors 8,4,2 "
               f"({len(dg.levels)} levels down to 1x1), logged {logged[0]!r}",
               dg, f"{dg.cycles} full-precision cycles",
               f"residual {dg.solve_residual:.3e}", stokes_l2[8], "uvp")
        # -- Stokes -k.  The Krylov routes stop on the preconditioned residual
        # (JAX's rule, which dgtpu keeps): at the shipped tolerances (1e-8
        # relative, 1e-5 absolute) they stop early, up to ~1e-5 off in L2
        # (Schur GMRES 8x8) and further for Poisson (block-diagonal 1e-2,
        # SA-AMG 12x in dgtpu itself), so phase 22 asks for 1e-10 (Stokes)
        # and KRYLOV_TOL (Poisson) -------------------------------------------
        for n, precond in ((8, "multigrid"), (32, "multigrid"),
                           (8, "block_diagonal")):
            dg = run(tmp, f"stokes_k_{n}_{precond}", ["-k"], stokes(n, **{
                "solver.krylov.preconditioner": precond,
                "solver.krylov.tolerance": RES_TOL,
                "solver.krylov.absolute tolerance": 0.0}))
            what = ("the multigrid preconditioner (DGS lsq W-cycle)"
                    if precond == "multigrid" else "the Schur block-diagonal preconditioner")
            report(f"Stokes -k GMRES({dg.settings.solver.krylov.restart}) with {what}, "
                   f"{n}x{n}", dg, f"{dg.krylov_iterations} restarts", krylov_status(dg),
                   stokes_l2[n], "uvp")
        # -- Poisson 8x8 p5 -k and -amg --------------------------------------
        sym = {f"solver.multigrid.{c}.post smoother.iterations": 2
               for c in ("polynomial coarsening", "geometric coarsening")}
        for method, precond, extra in (
                ("gmres", "block_diagonal", {}), ("gmres", "amg", {}),
                ("gmres", "multigrid", {}), ("cg", "multigrid", sym)):
            path = write_paramfile(tmp, f"poisson_k_{method}_{precond}.yml", **{
                "solver.krylov.method": method, "solver.krylov.preconditioner": precond,
                "solver.krylov.tolerance": KRYLOV_TOL,
                "solver.krylov.absolute tolerance": 0.0, **extra})
            dg = cli(["-k", "--silent", "--device", "cuda", "--paramfile", path])
            unit = "restarts" if method == "gmres" else "steps"
            report(f"Poisson 8x8 p5 -k {method} with {precond}", dg,
                   f"{dg.krylov_iterations} {unit}", krylov_status(dg),
                   {"u": l2_direct}, "u")
        for variant, (l2_ref, n_ref) in DGTPU_AMG_8X8_P5.items():
            path = write_paramfile(tmp, f"poisson_amg_{variant}.yml",
                                   **{"solver.amg.variant": variant})
            dg = cli(["-amg", "--silent", "--device", "cuda", "--paramfile", path])
            info = dg.amg_info
            if info["cycles"] != n_ref:
                raise AssertionError(f"-amg {variant}: {info['cycles']} cycles, dgtpu "
                                     f"{n_ref}")
            report(f"Poisson 8x8 p5 -amg {variant} (held to dgtpu's route: "
                   f"{n_ref} cycles; L2(u) rel to -d {abs(dg.L2_error_u - l2_direct) / l2_direct:.2e})",
                   dg, f"{info['cycles']} cycles",
                   f"info {info['info']}, residual {info['residuals'][-1]:.3e} before "
                   "the last cycle", {"u": l2_ref}, "u")
    print(f"[22] the solver routes took {time.perf_counter() - t_phase:.1f} s of wall "
          f"time ({card})", flush=True)


# -- phase 23 ---------------------------------------------------------------
# dgtpu's values for phase 23, computed on a CPU with the JAX reference
# package (JAX_PLATFORMS=cpu; ``main`` is dgtpu.__main__.main, ``P(**over)``
# the shipped paramfile with export off and the dotted-path overrides):
#   -fvm at 64x64 p5: main(['-fvm', '-f', 'Rectangle_64X64_nPoly5.xyz',
#     '--p-grid', '5', '--silent', '--backend', 'cpu']).L2_error_u
DGTPU_FVM_L2_64 = 0.0013646157669046444
# the use-FVM multigrid (tests/test_curvilinear_fvm.py:112-136: polynomial
# coarsening off, geometric factor 2, use FVM): (cycles, L2(u)) with
# cycles = len(dg.residuals) - 1 of DGFEM(settings, solve_multigrid=True)
# after solve(), on (grid, p_grid, p_solution) = (8x8, 1, 1) and
# (32x32, 2, 1)
DGTPU_USE_FVM = {8: (23, 0.0821487812598928), 32: (144, 0.004984038508874388)}
# -amp: (min, max) of A1..A4 over the 101x101 theta grid; DG: dgtpu.solvers.
# amplification.calculate_amplification(dg.levels[-1], dir, n_theta=101,
# export=False) with dg = DGFEM(settings=Settings(P()), solve_direct=True)
# (8x8 p5); FVM: the amplification.npz of main(['-amp',
# '--fvm-discretization', '-f', 'Rectangle_8X8_nPoly1.xyz', '--p-grid', '1',
# '--p-solution', '0', '--silent', '--backend', 'cpu'])
DGTPU_AMP = {"dg": {1: (0.07634511047684112, 1.0000002464944788),
                    2: (0.1186026775291931, 0.9999981578221624),
                    3: (0.21109833024290747, 0.9999982450730317),
                    4: (0.06680144494374676, 1.0000001124633144)},
             "fvm": {1: (0.0001341806777777679, 0.934359310267668),
                     2: (0.00010025352887522827, 0.9363019538686694),
                     3: (0.0001002535288752274, 0.9363019538686693),
                     4: (0.00010983977684680415, 0.940460854770357)}}
# the check switches: DGFEM(..., solve_direct=True).diagnostics; Poisson
# 8x8 p2 with all six (P() on Rectangle_8X8_nPoly2, p_grid 2, p_sol 2),
# Stokes 4x4 (stokes_params(4), precision full) in local order with all but
# the consistency check and in global order with the eigenvalues, the
# condition number, the characteristics and the consistency check, whose
# ranks come from dgtpu.diagnostics.run_diagnostics(dg, dg.levels[-1])
# after setting dg.levels[-1].Epsilon = 1e-3 (the manufactured solution is
# divergence-free, so Epsilon is a roundoff number and the rank test would
# not run)
DGTPU_DIAG = {"poisson": {"min_eig": 4.934824092579778, "max_eig": 4633.134555577272,
                          "cond": 938.8651892470231, "spd": True,
                          "diag_dominant": False, "orthonormal": False,
                          "rho_gs": 0.9831790866667758},
              "stokes_local": {"min_eig": -0.04102666103514897, "max_eig": 88.55216556611492,
                               "cond": 84201.79139283224, "spd": False,
                               "diag_dominant": False, "rho_gs": 2.8035267782096294},
              "stokes_global": {"min_eig": -0.04102666103514482, "max_eig": 88.55216556611468,
                                "cond": 84201.79139284494, "spd": False,
                                "diag_dominant": False, "Epsilon": 1.5119890743373657e-31,
                                "rank": 63, "rank_aug": 63}}
CHECKS = ("check eigenvalues", "check condition number", "check characteristics",
          "check orthonormality", "check iteration matrix", "check consistency")
FVM_REL_TOL = 1e-10        # the port's FVM routes vs dgtpu's: float64 both
AMP_TOL = 1e-10            # amplitudes in [0, 1], absolute
DIAG_REL_TOL = 1e-8        # dense host checks of the same float64 operator
NATIVE_REL_TOL = 1e-12     # host C++ sweeps vs the plain torch ones


def diagnostics_differ(got, ref):
    """The keys where ``got`` misses dgtpu's ``ref``: booleans and ranks
    equal, Epsilon within 1e-13 absolute, every other number within
    DIAG_REL_TOL relative (complex eigenvalues too)."""
    if got.keys() != ref.keys():
        return sorted(set(got) ^ set(ref))
    bad = []
    for key, want in ref.items():
        have = got[key]
        if isinstance(want, (bool, int)):
            ok = have == want
        elif key == "Epsilon":
            ok = abs(have - want) < 1e-13
        else:
            ok = abs(have - want) <= DIAG_REL_TOL * abs(want)
        if not ok:
            bad.append(key)
    return bad


def other_route_phases(card, rng, l2_poisson8, stokes8, flagship):
    """Phase 23: the routes ported last, on the card.  ``-fvm`` (64x64 p5
    held to dgtpu's L2(u); the observed order from 16x16 to 32x32 p2); the
    multigrid with FVM coarse levels in full precision (8x8 p1 and 32x32
    p_grid 2 / p1, held to dgtpu's cycles and L2(u)) and its mixed -> full
    fallback at 8x8; ``-amp`` (DG at 8x8 p5 and FVM at 8x8 p1, 101x101
    modes, min and max of A1-A4 held to dgtpu's); the six check switches
    (Poisson 8x8 p2, Stokes 4x4 in local and global order) held to dgtpu's;
    the mixed route with the physical-element orthonormal basis (Poisson
    8x8 p5, Stokes 8x8: graphed, held to the standard basis's routes
    ``l2_poisson8`` and ``stokes8`` within L2_REL_TOL, with the launches of
    their kernels and the cycle's graph against eager bit for bit); the
    8x8 p5 mixed route twice with caching on (the second run loads every
    level and gives the same L2(u) bit for bit); and the host C++ kernels
    against the plain torch ones on ``flagship``'s 8x8 p5 operator.
    Returns {path: launch counts} of the orthonormal and cached routes."""
    import numpy as np
    import torch
    import yaml
    from dgtpu_torch import api, native
    from dgtpu_torch.__main__ import main as cli
    from dgtpu_torch.diagnostics import run_diagnostics
    from dgtpu_torch.ops import soa
    from dgtpu_torch.ops import stokes_soa as ss
    from dgtpu_torch.ops.smoothers import block_gauss_seidel, block_jacobi
    from dgtpu_torch.solvers.amplification import calculate_amplification
    from dgtpu_torch.utils import caching
    t_phase = time.perf_counter()
    paths = {}
    dev = ["--device", "cuda", "--silent"]

    def dump(tmp, name, params):
        path = os.path.join(tmp, name)
        with open(path, "w") as f:
            yaml.safe_dump(params, f)
        return path

    with tempfile.TemporaryDirectory() as tmp:
        # -- -fvm -----------------------------------------------------------
        t0 = time.perf_counter()
        dg = cli(["-fvm", "-f", "Rectangle_64X64_nPoly5.xyz", "--p-grid", "5"] + dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rel = abs(dg.L2_error_u - DGTPU_FVM_L2_64) / DGTPU_FVM_L2_64
        print(f"[23] -fvm 64x64 p5 ({dg.levels[-1].N} cells, dense LU): residual "
              f"{dg.residual:.3e}, L1(u) {dg.L1_error_u:.9e}, L2(u) {dg.L2_error_u:.9e} "
              f"(dgtpu {DGTPU_FVM_L2_64:.9e}, rel {rel:.2e}), solve "
              f"{dg.solve_seconds:.3f} s, setup + solve {wall:.2f} s ({card})", flush=True)
        if not rel < FVM_REL_TOL:
            raise AssertionError(f"-fvm 64x64 L2(u) off dgtpu's: {rel:.3e}")
        errs = {}
        for n in (16, 32):
            dg = cli(["-fvm", "-f", f"Rectangle_{n}X{n}_nPoly2.xyz", "--p-grid", "2"] + dev)
            errs[n] = dg.L2_error_u
        order = math.log2(errs[16] / errs[32])
        print(f"[23] -fvm observed order 16x16 -> 32x32 p2: {order:.4f} (L2(u) "
              f"{errs[16]:.9e}, {errs[32]:.9e})", flush=True)
        if not order > 1.5:
            raise AssertionError(f"-fvm is not second order: {order:.3f}")

        # -- the multigrid with FVM coarse levels ---------------------------
        use_fvm = {"solver.multigrid.polynomial coarsening.enabled": False,
                   "solver.multigrid.geometric coarsening.enabled": True,
                   "solver.multigrid.geometric coarsening.use FVM": True,
                   "solver.multigrid.geometric coarsening.coarsening factors": 2}
        seen = _Messages()
        logger = logging.getLogger("dgtpu_torch.api")
        for n, pg, ps, precision in ((8, 1, 1, "full"), (32, 2, 1, "full"),
                                     (8, 1, 1, "mixed")):
            path = write_paramfile(tmp, f"use_fvm_{n}_{precision}.yml", **use_fvm, **{
                "grid.filename": f"Rectangle_{n}X{n}_nPoly{pg}.xyz",
                "grid.polynomial degree": pg, "solution.u.polynomial degree": ps,
                "performance.precision": precision, "logging.loglevel": "WARNING"})
            seen.messages.clear()
            logger.addHandler(seen)
            try:
                dg = cli(["-m", "--device", "cuda", "--paramfile", path])
            finally:
                logger.removeHandler(seen)
            torch.cuda.synchronize()
            cycles, l2 = DGTPU_USE_FVM[n]
            rel = abs(dg.L2_error_u - l2) / l2
            kinds = [lv.discretization for lv in dg.levels]
            fell_back = [m for m in seen.messages if m.endswith("running full precision")]
            print(f"[23] -m precision {precision}, use FVM, {n}x{n} p_grid {pg} p{ps} "
                  f"(levels {kinds}): {dg.cycle_kind}, {dg.cycles} cycles (dgtpu "
                  f"{cycles}), residual {dg.solve_residual:.3e}, L2(u) "
                  f"{dg.L2_error_u:.9e} (rel to dgtpu {rel:.2e}), solve "
                  f"{dg.solve_seconds:.3f} s"
                  + (f"; logged {fell_back[0]!r}" if fell_back else "") + f" ({card})",
                  flush=True)
            if kinds != ["fvm", "fvm", "dg"] or dg.cycle_kind != "full precision":
                raise AssertionError(f"the use-FVM route ran {kinds}, {dg.cycle_kind}")
            if dg.cycles != cycles or not rel < FVM_REL_TOL:
                raise AssertionError(f"use-FVM {n}x{n}: {dg.cycles} cycles, L2 rel {rel:.3e}")
            if precision == "mixed" and not fell_back:
                raise AssertionError("the mixed use-FVM route did not fall back to full")

        # -- -amp -----------------------------------------------------------
        lvl = api.DGFEM(device="cuda", solve_direct=True, paramfile=write_paramfile(
            tmp, "amp_dg.yml", **{"logging.loglevel": "ERROR"})).levels[-1]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        amp = {"dg": calculate_amplification(lvl, tmp, n_theta=101, export=False)}
        torch.cuda.synchronize()
        seconds = {"dg": time.perf_counter() - t1}
        t1 = time.perf_counter()
        dg = cli(["-amp", "--fvm-discretization", "-f", "Rectangle_8X8_nPoly1.xyz",
                  "--p-grid", "1", "--p-solution", "0"] + dev)
        torch.cuda.synchronize()
        seconds["fvm"] = time.perf_counter() - t1
        with np.load(os.path.join(dg.results_dir, "amplification.npz")) as npz:
            amp["fvm"] = {k: npz[k] for k in npz.files}
        for kind, out in amp.items():
            got = {q: (float(out[f"A{q}"].min()), float(out[f"A{q}"].max()))
                   for q in range(1, 5)}
            off = max(abs(a - b) for q in got for a, b in zip(got[q], DGTPU_AMP[kind][q]))
            where = ("DG 8x8 p5 (2304 unknowns)" if kind == "dg"
                     else "FVM 8x8 p_grid 1, p_solution 0, through the CLI")
            print(f"[23] -amp {where}: 101x101 modes in one complex128 batch, "
                  f"{seconds[kind]:.3f} s; (min, max) of A1-A4 "
                  f"{ {q: (round(a, 12), round(b, 12)) for q, (a, b) in got.items()} }, "
                  f"largest difference from dgtpu's {off:.2e} ({card})", flush=True)
            if not off < AMP_TOL:
                raise AssertionError(f"-amp {kind}: A1-A4 off dgtpu's by {off:.3e}")

        # -- the check switches ----------------------------------------------
        poisson = write_paramfile(tmp, "checks_poisson.yml", **{
            "grid.filename": "Rectangle_8X8_nPoly2.xyz", "grid.polynomial degree": 2,
            "solution.u.polynomial degree": 2, "logging.loglevel": "ERROR",
            **{f"problem.{c}": True for c in CHECKS}})
        cases = {"poisson": (poisson, CHECKS)}
        for ordering, flags in (("local", CHECKS[:5]), ("global", CHECKS[:3] + CHECKS[5:])):
            params = stokes_params(4)
            params["performance"]["precision"] = "full"
            params["solution"]["ordering"] = ordering
            params["problem"].update({c: True for c in flags})
            cases[f"stokes_{ordering}"] = (dump(tmp, f"checks_{ordering}.yml", params), flags)
        for name, (path, flags) in cases.items():
            t0 = time.perf_counter()
            dg = cli(["-d", "--paramfile", path] + dev)
            got = dict(dg.diagnostics)
            if name == "stokes_global":
                dg.levels[-1].Epsilon = 1e-3
                got.update({k: v for k, v in run_diagnostics(dg, dg.levels[-1]).items()
                            if k.startswith("rank")})
            bad = diagnostics_differ(got, DGTPU_DIAG[name])
            shown = {k: v if isinstance(v, (bool, int)) or np.iscomplexobj(v)
                     else float(f"{v:.10g}") for k, v in got.items()}
            print(f"[23] check switches, {name} ({dg.levels[-1].rhs.numel()} unknowns, "
                  f"{len(flags)} switches): {shown}, "
                  f"{time.perf_counter() - t0:.2f} s; off dgtpu's: {bad or 'none'}",
                  flush=True)
            if bad:
                raise AssertionError(f"check switches {name}: {bad} differ from dgtpu's")

        # -- the mixed route in the physical-element orthonormal basis -------
        ortho = {"problem.orthonormal on physical element": True,
                 "performance.precision": "mixed", "logging.loglevel": "ERROR"}
        reset_counts()
        dg = cli(["-m", "--device", "cuda", "--paramfile",
                  write_paramfile(tmp, "ortho_poisson.yml", **ortho)])
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in soa.KERNELS}
        rel = abs(dg.L2_error_u - l2_poisson8) / l2_poisson8
        print(f"[23] -m mixed, orthonormal basis, 8x8 p5: {dg.cycle_kind}, "
              f"{dg.outer_rounds} outer rounds, residual {dg.solve_residual:.3e}, "
              f"L2(u) {dg.L2_error_u:.9e} (rel to the standard basis's {rel:.2e}), "
              f"{solve_text(dg)}; launches {launches} ({card})", flush=True)
        if dg.cycle_kind != "SoA" or not dg.solve_residual < RES_TOL or not rel < L2_REL_TOL:
            raise AssertionError("the orthonormal Poisson route missed its bars")
        not_launched(launches, list(launches), "the orthonormal 8x8 p5 route")
        paths["poisson_8x8_orthonormal"] = launches
        check_graph("[23] 8x8 p5 SoA cycle, orthonormal basis", cycle_of(dg),
                    dg.levels[-1].rhs.numel(), 2, rng)
        params = stokes_params(8)
        params["problem"]["orthonormal on physical element"] = True
        reset_counts()
        dg = cli(["-m", "--device", "cuda", "--silent", "--paramfile",
                  dump(tmp, "ortho_stokes.yml", params)])
        torch.cuda.synchronize()
        launches = {k.__name__: k.launches for k in ss.CYCLE_KERNELS}
        rel = {v: abs(getattr(dg, f"L2_error_{v}") - getattr(stokes8, f"L2_error_{v}"))
               / getattr(stokes8, f"L2_error_{v}") for v in "uvp"}
        print(f"[23] Stokes -m mixed, orthonormal u and p bases, 8x8: {dg.cycle_kind}, "
              f"inner {dg.inner}, outer rounds {dg.rounds}, residual "
              f"{dg.solve_residual:.3e}, L2 rel to the standard basis's "
              f"{ {v: float(f'{r:.2e}') for v, r in rel.items()} }, {solve_text(dg)}; "
              f"launches {launches} ({card})", flush=True)
        if not dg.solve_residual < RES_TOL or not all(r < L2_REL_TOL for r in rel.values()):
            raise AssertionError("the orthonormal Stokes route missed its bars")
        not_launched(launches, list(launches), "the orthonormal 8x8 Stokes route")
        paths["stokes_8x8_orthonormal"] = launches
        check_graph("[23] 8x8 Stokes W-cycle, orthonormal bases", stokes_cycle_of(dg),
                    dg.levels[-1].rhs.numel(), 2, rng)

        # -- caching ----------------------------------------------------------
        saved_root, saved_assemble = caching.CACHE_ROOT, api.assemble_poisson
        caching.CACHE_ROOT = os.path.join(tmp, "cache")
        assembled = []

        def counted(*args, **kw):
            assembled.append(1)
            return saved_assemble(*args, **kw)

        api.assemble_poisson = counted
        runs = []
        try:
            path = write_paramfile(tmp, "cached.yml", **{
                "caching.enabled": True, "performance.precision": "mixed",
                "logging.loglevel": "ERROR"})
            for _ in range(2):
                assembled.clear()
                t0 = time.perf_counter()
                dg = api.DGFEM(device="cuda", paramfile=path, solve_multigrid=True)
                torch.cuda.synchronize()
                setup = time.perf_counter() - t0
                reset_counts()
                dg.solve()
                torch.cuda.synchronize()
                runs.append((dg, setup, len(assembled), counts()))
        finally:
            caching.CACHE_ROOT, api.assemble_poisson = saved_root, saved_assemble
        (cold, cold_s, cold_n, _), (warm, warm_s, warm_n, launches) = runs
        print(f"[23] -m mixed 8x8 p5 with caching on: setup {cold_s:.3f} s cold "
              f"({cold_n} of {len(cold.levels)} levels assembled), {warm_s:.3f} s warm "
              f"({warm_n} assembled); L2(u) {cold.L2_error_u!r} and "
              f"{warm.L2_error_u!r}, {solve_text(warm)} ({card})", flush=True)
        if cold_n != len(cold.levels) or warm_n != 0:
            raise AssertionError("the second cached run did not load every level")
        if warm.L2_error_u != cold.L2_error_u:
            raise AssertionError("the cached run's L2(u) differs from the assembled run's")
        paths["poisson_8x8_cached"] = {k: v for k, v in launches.items()}

    # -- the host C++ kernels ------------------------------------------------
    op = flagship.levels[-1].op
    rhs = flagship.levels[-1].rhs
    x = torch.as_tensor(rng.standard_normal(rhs.numel()), device=rhs.device)
    t0 = time.perf_counter()
    ns = native.NativeStencil(op)
    build_s = time.perf_counter() - t0
    pairs = {"matvec": (ns.matvec(x), op.matvec(x)),
             "symmetric GS": (ns.gauss_seidel(rhs, x, "symmetric"),
                              block_gauss_seidel(op, rhs, x, direction="symmetric")),
             "Jacobi (0.8)": (ns.jacobi(rhs, x, omega=0.8),
                              block_jacobi(op, rhs, x, omega=0.8))}
    errs = {}
    for name, (host, plain) in pairs.items():
        plain = plain.cpu().numpy()
        errs[name] = float(np.abs(host - plain).max() / np.abs(plain).max())
    print(f"[23] native host C++ kernels (g++ build and load {build_s:.2f} s) against the "
          f"plain torch ones on the 8x8 p5 operator: max rel err "
          f"{ {k: float(f'{v:.2e}') for k, v in errs.items()} } (bar {NATIVE_REL_TOL:g})",
          flush=True)
    if not all(e < NATIVE_REL_TOL for e in errs.values()):
        raise AssertionError(f"the native kernels differ from the plain ones: {errs}")
    print(f"[23] the routes ported last took {time.perf_counter() - t_phase:.1f} s of wall "
          f"time ({card})", flush=True)
    return paths


# the sharded full-precision multigrid at 8x8 p=5 (the shipped paramfile,
# red-black sweeps to its 1e-6) over 4 shards: dgtpu's cycle count on a CPU
# mesh, the number tests/test_torch_parallel.py holds the port to
#   python -c "from dgtpu.__main__ import main; \
#     print(len(main(['-m', '--shards', '4', '--silent', '--backend', 'cpu']).residuals) - 1)"
# with XLA_FLAGS=--xla_force_host_platform_device_count=4
DGTPU_SHARDED_CYCLES_8X8_P5 = 7
SHARD_L2_REL_TOL = 1e-12   # 1, 2 and 4 shards: sharding only reorders the psum
PHASE24_BUDGET_S = 150.0
# the figure suite's files (dgtpu's names for p = 2)
FIGURE_SUITE_FILES = ["standard_element_p2.png", "legendre_basis_p2.png",
                      "nodal_basis_p2.png", "modal_basis_2d_p2.png", "lebesgue_p2.png",
                      "lebesgue_constant_p6.png", "runge_p6.png"]


def have_matplotlib():
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def on_card(mg):
    """Raise unless every operand of the sharded cycle and every halo row
    exchanged so far lay on the card."""
    from dgtpu_torch.parallel import halo
    off = [tuple(t.shape) for t in mg.tensors() if not t.is_cuda]
    if off or halo.EXCHANGES["cpu"] or not halo.EXCHANGES["cuda"]:
        raise AssertionError(f"the sharded route left the card: operands {off}, halo "
                             f"exchanges {dict(halo.EXCHANGES)}")


def sharded_stokes(n, factors, velocity_solver="gs"):
    """The Stokes mixed route at n x n over 4 shards, with the geometric
    ``factors`` and ``performance.dgs_velocity_solver``; returns the solved
    DGFEM and its wall seconds."""
    from dgtpu_torch.api import DGFEM
    from dgtpu_torch.settings import Settings
    params = stokes_params(n)
    params["solver"]["multigrid"]["geometric coarsening"]["coarsening factors"] = factors
    params["performance"]["n_shards"] = 4
    params["performance"]["dgs_velocity_solver"] = velocity_solver
    t0 = time.perf_counter()
    dg = DGFEM(device="cuda", settings=Settings(params), solve_multigrid=True)
    dg.solve()
    return dg, time.perf_counter() - t0


def sharded_and_tools_phases(card, dg64, u_soa64):
    """Phase 24: the sharded multigrid (``parallel/``) and the tools on the
    card.  The 64x64 p5 mixed route (``dg64``, phase 6's hierarchy: factors
    16,8,4,2, FMG seed) over 4 shards held to phase 6's SoA-route nodal
    solution ``u_soa64``, and one eager float32 sharded V-cycle timed; the
    8x8 p5 full-precision sharded multigrid over
    1, 2 and 4 shards (equal cycle counts, the 4-shard one dgtpu's, L2(u)
    within SHARD_L2_REL_TOL); the Stokes mixed route over 4 shards at 16x16
    (dgtpu's L2 bars; 32x32 takes minutes eagerly) and at 8x8 with the
    Chebyshev velocity solver (phase 10's bars), the hierarchies cut to the
    nearest that 4 shards divide, and the GMRES(16)-wrapped refinement at
    8x8; every operand and halo row on the card and no kernel launched by
    the sharded solves; ``--profile`` at 8x8 p5 (its trace holds K1's and
    K5's CUDA kernels); the convergence study (rates above p + 1 - 0.4) and
    the figure suite (dgtpu's file names where matplotlib imports, none
    where it does not).  Returns {path: launch counts} of the profiled
    route."""
    import numpy as np
    import torch
    from dgtpu_torch import studies
    from dgtpu_torch.__main__ import main as cli
    from dgtpu_torch.parallel import halo
    t_phase = time.perf_counter()

    # -- 64x64 p5, mixed, 4 shards, FMG seed ---------------------------------
    mg = dg64.settings.solver.multigrid
    admitted = halo.shardable_device_counts(dg64.levels)
    if 4 not in admitted:
        raise AssertionError(f"phase 6's hierarchy does not divide over 4 shards: {admitted}")
    reset_counts()
    halo.EXCHANGES.clear()
    dg64.settings.performance.n_shards = 4
    try:
        dg64.solve()
        torch.cuda.synchronize()
    finally:
        dg64.settings.performance.n_shards = 1
    on_card(dg64.mg)
    sol = float(abs(dg64.u_nodal - u_soa64).max() / abs(u_soa64).max())
    print(f"[24] 64x64 p5 mixed over {dg64.mesh.size} shards on {len(dg64.mesh.cards)} "
          f"card(s) (factors {mg.geometric_coarsening.coarsening_factors}, Nj per level "
          f"{[l.Nj for l in dg64.levels]}, shard counts admitted {admitted}), FMG seed: "
          f"{dg64.outer_rounds} outer rounds, residual {dg64.solve_residual:.3e} "
          f"(normalized), L2(u) {dg64.L2_error_u:.9e}, nodal u against phase 6's SoA "
          f"route {sol:.2e} relative, solve {dg64.solve_seconds:.3f} s; halo exchanges "
          f"{dict(halo.EXCHANGES)} ({card})", flush=True)
    if dg64.cycle_kind != "sharded mixed" or not dg64.solve_residual < RES_TOL:
        raise AssertionError("the sharded 64x64 route missed 1e-10")
    if not sol < RES_TOL:
        raise AssertionError(f"the sharded 64x64 solution differs from phase 6's: {sol:.3e}")
    # one eager float32 sharded V-cycle (plain torch), to set beside phase
    # 7's graphed SoA cycle
    mg64 = dg64.mg
    r32 = mg64._bands(dg64.levels[-1].rhs, torch.float32)
    top = len(dg64.levels) - 1
    cycle_ms = cuda_ms(lambda: mg64._v_cycle(top, mg64.data32(), r32,
                                             [torch.zeros_like(b) for b in r32]), 5)
    print(f"[24] 64x64 p5 sharded float32 V-cycle over 4 shards, eager: {cycle_ms:.2f} ms "
          f"per cycle (CUDA events over 5 cycles) ({card})", flush=True)

    # -- 8x8 p5 full precision over 1, 2 and 4 shards ------------------------
    s8 = settings_for("Rectangle_8X8_nPoly5.xyz", 5)
    s8.performance.precision = "full"
    dg8 = hierarchy(s8)
    runs = {}
    for k in (1, 2, 4):
        t0 = time.perf_counter()
        u, res, n = dg8._solve_multigrid_sharded(k, "full")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        on_card(dg8.mg)
        dg8._postprocess(u)
        runs[k] = (n, dg8.L2_error_u, res, secs)
    l2_1 = runs[1][1]
    spread = max(abs(r[1] - l2_1) / l2_1 for r in runs.values())
    print(f"[24] 8x8 p5 full precision, sharded red-black multigrid: "
          + ", ".join(f"{k} shard(s) {n} cycles, L2(u) {l2!r}, residual {res:.3e}, "
                      f"{secs:.3f} s" for k, (n, l2, res, secs) in runs.items())
          + f"; L2(u) spread {spread:.2e} (dgtpu's 4-shard count "
          f"{DGTPU_SHARDED_CYCLES_8X8_P5}) ({card})", flush=True)
    if len({r[0] for r in runs.values()}) != 1 or not spread <= SHARD_L2_REL_TOL:
        raise AssertionError(f"the 1/2/4-shard solves disagree: {runs}")
    if runs[4][0] != DGTPU_SHARDED_CYCLES_8X8_P5:
        raise AssertionError(f"4 shards took {runs[4][0]} cycles, dgtpu "
                             f"{DGTPU_SHARDED_CYCLES_8X8_P5}")

    # -- Stokes, mixed, 4 shards ---------------------------------------------
    # 16x16, not 32x32: the eager sharded 32x32 route took 422.8 s on an
    # H100 (20 stalled plain rounds, then 5 GMRES(16) rounds; PERF.md)
    for n, factors, solver in ((16, "2,4", "gs"), (8, "2", "chebyshev")):
        halo.EXCHANGES.clear()
        dg, secs = sharded_stokes(n, factors, solver)
        torch.cuda.synchronize()
        on_card(dg.mg)
        rel_l2 = check_stokes_errors(dg, n)
        print(f"[24] Stokes {n}x{n} mixed over {dg.mesh.size} shards (factors {factors}: "
              f"Nj per level {[l.Nj for l in dg.levels]}, velocity solve {solver}): "
              f"outer rounds {dg.rounds}, inner {dg.inner}, residual "
              f"{dg.solve_residual:.3e}, L2(u) {dg.L2_error_u:.9e}, L2(v) "
              f"{dg.L2_error_v:.9e}, L2(p) {dg.L2_error_p:.9e} (rel to dgtpu {rel_l2}), "
              f"solve {dg.solve_seconds:.3f} s, {secs:.1f} s with setup ({card})", flush=True)
        if not dg.solve_residual < RES_TOL:
            raise AssertionError(f"the sharded {n}x{n} Stokes route missed 1e-10")
    # the route's GMRES(16) retry (16x16 converges without it) on the last
    # route's 8x8 levels, held to phase 10's bars
    t0 = time.perf_counter()
    u_g, res_g, n_g = dg.mg.solve_refined(dg.levels[-1].rhs, tol=RES_TOL, n_inner=16,
                                          inner="gmres")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    on_card(dg.mg)
    dg._postprocess(u_g)
    rel_l2 = check_stokes_errors(dg, 8)
    print(f"[24] Stokes 8x8 sharded refinement with GMRES(16)-wrapped cycles: {n_g} outer "
          f"rounds, residual {res_g:.3e}, L2 rel to dgtpu {rel_l2}, {secs:.1f} s ({card})",
          flush=True)
    if not res_g < RES_TOL:
        raise AssertionError("the sharded GMRES refinement missed 1e-10")
    launched = {k: v for k, v in counts().items() if v}
    if launched:
        raise AssertionError(f"the sharded routes launched kernels: {launched}")

    # -- --profile -------------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        reset_counts()
        dg = cli(["-m", "--precision", "mixed", "--silent", "--profile", tmp])
        torch.cuda.synchronize()
        launches = counts()
        trace = os.path.join(tmp, "trace.json")
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        size = os.path.getsize(trace)
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    k1 = sum("half_sweep_kernel" in k and "dg_half_sweep" not in k for k in kernels)
    k5 = sum("stencil_apply_kernel" in k for k in kernels)
    print(f"[24] --profile at 8x8 p5 mixed: trace.json {size} bytes, {len(events)} events, "
          f"{len(kernels)} CUDA kernel events (K1 half_sweep_kernel {k1}, K5 "
          f"stencil_apply_kernel {k5}), L2(u) {dg.L2_error_u:.9e}; launches {launches} "
          f"({card})", flush=True)
    if not (k1 and k5):
        raise AssertionError("the profile holds no K1 or no K5 kernel events")
    not_launched(launches, ["half_sweep", "stencil_apply"], "the profiled 8x8 route")

    # -- the studies -----------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        results, rates = studies.run_convergence_study(
            grid_sizes=(2, 4, 8), degrees=(1, 2), p_grid=1,
            exact={"u": "sin(pi*x)*sin(pi*y)", "tag": "MMS"},
            outdir=os.path.join(tmp, "convergence"), device="cuda")
        study_s = time.perf_counter() - t0
        written = sorted(os.listdir(os.path.join(tmp, "convergence")))
        figures = [os.path.basename(f) for f in
                   studies.run_figure_suite(p=2, outdir=os.path.join(tmp, "plots"))]
    print(f"[24] convergence study on the card (grids 2/4/8, p 1/2, -d): L2(u) "
          f"{ {p: [float(f'{e:.6e}') for _, e in pts] for p, pts in results.items()} }, "
          f"rates { {p: [round(r, 3) for r in rs] for p, rs in rates.items()} }, "
          f"{study_s:.2f} s, files {written}; figure suite {figures} (matplotlib "
          f"{'present' if have_matplotlib() else 'missing: no plot is drawn'}) ({card})",
          flush=True)
    if not all(rates[p][-1] > p + 1 - 0.4 for p in rates):
        raise AssertionError(f"convergence rates below p + 1 - 0.4: {rates}")
    # where matplotlib is missing (the GPU machine has none) the plots return
    # None and the suite writes nothing, dgtpu's HAVE_MPL behaviour
    expected = FIGURE_SUITE_FILES if have_matplotlib() else []
    if figures != expected:
        raise AssertionError(f"the figure suite wrote {figures}, not {expected}")
    wall = time.perf_counter() - t_phase
    print(f"[24] the sharded multigrid and the tools took {wall:.1f} s of wall time "
          f"(budget {PHASE24_BUDGET_S:g} s) ({card})", flush=True)
    return {"poisson_8x8_profile": launches}


def check_rolled(worst):
    """Each rolled kernel's worst error so far within ROLLED_REL_TOL."""
    from dgtpu_torch.ops import vcycle
    for kern in vcycle.KERNELS:
        if not worst[kern][1] <= ROLLED_REL_TOL:
            raise AssertionError(f"{kernel_name(kern)} is {worst[kern][1]:.3e} from its "
                                 f"plain version (bar {ROLLED_REL_TOL:g})")


def check_stokes_errors(dg, n):
    """L2(u, v, p) against dgtpu's pinned values at 1e-6 relative; returns
    the relative differences."""
    rel = {v: abs(getattr(dg, f"L2_error_{v}") - ref) / ref
           for v, ref in DGTPU_STOKES_L2[n].items()}
    if not all(r < L2_REL_TOL for r in rel.values()):
        raise AssertionError(f"{n}x{n} Stokes L2 errors differ from dgtpu's: {rel}")
    return {v: float(f"{r:.2e}") for v, r in rel.items()}


def main():
    global PARENT
    import argparse
    import torch
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="phases 1-2, then the torch.profiler breakdown")
    parser.add_argument("--parent", metavar="DIR",
                        help="root of an earlier tree whose kernels are timed beside")
    parser.add_argument("--sharded", action="store_true",
                        help="phases 1-2, the 64x64 p5 SoA-route solve of phase 6, "
                             "then phase 24")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from dgtpu_torch.ops import _kernels, soa, vcycle
    from dgtpu_torch.ops import stokes_soa as ss
    from dgtpu_torch.__main__ import main as cli

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    sources = [_kernels.SOURCE, _kernels.ROLLED_SOURCE]
    if opts.parent:
        csrc = os.path.join(os.path.abspath(opts.parent), "dgtpu_torch", "csrc")
        sources += [os.path.join(csrc, os.path.basename(f)) for f in sources]
    _kernels.build_all(sources)
    _kernels.library(), _kernels.rolled_library()
    if opts.parent:
        PARENT = _kernels.libraries_from(csrc)
    print(f"[2] built {', '.join(os.path.relpath(f, REPO) for f in sources)} with nvcc "
          f"for sm_90a, one process each, in {time.perf_counter() - t0:.2f} s",
          flush=True)
    floor = launch_floor(card)
    if opts.profile:
        profile(card)
        print(card)
        return 0
    if opts.sharded:
        dg64 = hierarchy(settings_for("Rectangle_64X64_nPoly5.xyz", 5,
                                      factors="16,8,4,2", fmg=True))
        with stream_budget(None):
            dg64.solve()
        sharded_and_tools_phases(card, dg64, dg64.u_nodal)
        print(card)
        return 0

    # -- 3: each kernel against its plain version ----------------------------
    import numpy as np
    rng = np.random.default_rng(0)
    flagship = hierarchy(settings_for("Rectangle_8X8_nPoly5.xyz", 5))
    ogrid = hierarchy(settings_for("CircleInCircle_4X4_nPoly2.xyz", 2, o_grid=True,
                                   p_levels="1,2"))
    cyc8 = cycle_of(flagship)
    direct_settings = copy.deepcopy(flagship.settings)
    direct_settings.solver.multigrid.coarse_grid_solver = "direct"
    dims8 = [(l.Nj, l.Ni) for l in flagship.levels]
    cyc_direct = soa.SoAVCycle([l.op for l in flagship.levels], flagship.transfers,
                               flagship.transfer_types, direct_settings, dims8,
                               dtype=torch.float32, device="cuda")
    cyc_o = cycle_of(ogrid)
    if not all(cyc_o.periodic):
        raise AssertionError("the O-grid hierarchy is not periodic")
    worst = {}
    for name, cyc in (("8x8 p5", cyc8), ("8x8 p5 direct coarse", cyc_direct),
                      ("4x4 O-grid p2", cyc_o)):
        check_kernels(kernel_cases(cyc, rng), f"3 {name}", worst)

    # -- 4: one whole cycle, kernel path vs plain path -----------------------
    rhs = flagship.levels[-1].rhs
    u_k = cyc8(rhs, torch.zeros_like(rhs))
    u_p = cycle_of(flagship, reference=True)(rhs, torch.zeros_like(rhs))
    rel = float((u_k - u_p).abs().max() / u_p.abs().max())
    print(f"[4] one 8x8 p5 cycle from zero: kernel vs plain max rel err {rel:.3e}",
          flush=True)
    if not rel < KERNEL_REL_TOL:
        raise AssertionError(f"kernel cycle disagrees with the plain cycle: {rel:.3e}")
    check_graph("[4] 8x8 p5 SoA cycle", cyc8, rhs.numel(), 2, rng)
    check_graph("[4] 8x8 p5 SoA cycle, dense coarse inverse", cyc_direct, rhs.numel(), 2,
                rng)

    # -- 5: the CLI route on the default paramfile ---------------------------
    reset_counts()
    dg8 = cli(["-m", "--precision", "mixed", "--silent"])
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in soa.KERNELS}
    l2_rel = abs(dg8.L2_error_u - DGTPU_L2_8X8_P5) / DGTPU_L2_8X8_P5
    print(f"[5] 8x8 p5 CLI route: residual {dg8.solve_residual:.3e} (normalized), "
          f"{dg8.residual:.3e} (L2), {dg8.outer_rounds} outer rounds, "
          f"L1(u) {dg8.L1_error_u:.6e}, L2(u) {dg8.L2_error_u:.9e} "
          f"(dgtpu {DGTPU_L2_8X8_P5:.9e}, rel {l2_rel:.2e}), "
          f"{solve_text(dg8)}; launches {launches}", flush=True)
    if not dg8.solve_residual < RES_TOL:
        raise AssertionError("the 8x8 solve did not reach 1e-10")
    if not l2_rel < L2_REL_TOL:
        raise AssertionError("8x8 L2(u) differs from dgtpu's")
    not_launched(launches, list(launches), "the 8x8 p5 route")
    l2_poisson8 = dg8.L2_error_u

    # -- 6: the same route at 64x64: the streamed hybrid --------------------
    from dgtpu_torch import api
    l2_bytes = api.stream_budget(torch.device("cuda"))
    t0 = time.perf_counter()
    dg64 = hierarchy(settings_for("Rectangle_64X64_nPoly5.xyz", 5,
                                  factors="16,8,4,2", fmg=True))
    setup_s = time.perf_counter() - t0
    reset_counts()
    dg64.solve()
    torch.cuda.synchronize()
    launches64 = counts()
    hyb = {k: getattr(dg64, k) for k in ("cycle_kind", "cut", "solve_residual",
                                         "residual", "outer_rounds", "L1_error_u",
                                         "L2_error_u", "solve_seconds", "u_nodal")}
    hyb["solve"] = solve_text(dg64)
    with stream_budget(None):
        dg64.solve()
    torch.cuda.synchronize()
    l2_soa = dg64.L2_error_u
    rel_soa = abs(hyb["L2_error_u"] - l2_soa) / l2_soa
    u_soa = dg64.u_nodal
    sol_soa = float(abs(hyb["u_nodal"] - u_soa).max() / abs(u_soa).max())
    print(f"[6] 64x64 p5 route (factors 16,8,4,2, FMG): L2 budget from the card "
          f"{l2_bytes} bytes (torch.cuda.get_device_properties().L2_cache_size), "
          f"{hyb['cycle_kind']} cut at {hyb['cut']} of {len(dg64.levels)} levels; "
          f"residual {hyb['solve_residual']:.3e} (normalized), {hyb['residual']:.3e} (L2), "
          f"{hyb['outer_rounds']} outer rounds, L1(u) {hyb['L1_error_u']:.6e}, "
          f"L2(u) {hyb['L2_error_u']:.9e} ({dg8.L2_error_u / hyb['L2_error_u']:.3g}x "
          f"below 8x8; SoA cycle's {l2_soa:.9e}, rel {rel_soa:.2e}; nodal u against "
          f"the SoA route's {sol_soa:.2e} relative), setup "
          f"{setup_s:.2f} s, {hyb['solve']} (SoA {solve_text(dg64)}); launches "
          f"{launches64}", flush=True)
    if hyb["cycle_kind"] != "streamed hybrid":
        raise AssertionError("the 64x64 route did not run the streamed hybrid")
    not_launched(launches64, POISSON_HYBRID_KERNELS, "the 64x64 hybrid route")
    if not hyb["solve_residual"] < RES_TOL:
        raise AssertionError("the 64x64 solve did not reach 1e-10")
    if not hyb["L2_error_u"] * 100 <= dg8.L2_error_u:
        raise AssertionError("64x64 L2(u) is not 100x below 8x8")
    # at 64x64 p=5 the MMS error (~5e-12) is at the solve's own roundoff, so
    # two 1e-10 solves differ in L2(u) by ~1e-4 relative; the solutions are
    # held to each other instead
    if not sol_soa < RES_TOL:
        raise AssertionError(f"the hybrid's 64x64 solution differs from the SoA "
                             f"route's: {sol_soa:.3e}")

    # -- 7: timings of the SoA cycle -----------------------------------------
    # the 64x64 SoA hierarchy's kernels first (phase 6's SoA-route solve and
    # the hybrid's levels below the cut launch them): K1's clusters at C =
    # 8 to 2048
    check_kernels(kernel_cases(cycle_of(dg64), rng), "7 64x64 p5", worst)
    soa_ms = {}
    for name, dg in (("8x8 p5", flagship), ("64x64 p5", dg64)):
        rhs = dg.levels[-1].rhs.to(torch.float32)
        soa_ms[name] = t = in_turns(cycle_of(dg), rhs, 5)
        plain_ms = marginal_ms(cycle_of(dg, reference=True), rhs)
        size, b_ms = cycle_bound(dg)
        print(f"[7] {name} marginal SoA cycle time: kernels {turns_text(t)}; plain "
              f"torch {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({size / 1e6:.3f} MB of "
              f"operands) ({card})", flush=True)

    timed = {}          # kernel -> (args, ms, plain ms) of the recorded case
    timing_case = {}
    for kern, args in kernel_cases(cyc8, np.random.default_rng(0)):
        timing_case[kern] = args   # the last case: the finest level's
    for kern in soa.KERNELS:
        args = timing_case[kern]
        ms = cuda_ms(lambda: kern(*args), 200)
        plain_ms = cuda_ms(lambda: plain_version(kern)(*args), 200)
        timed[kern] = (args, ms, plain_ms)
        print(f"[7] {kern.__name__} at 8x8 p5 shapes: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms ({card})", flush=True)
    for name, dg in (("8x8 p5", flagship), ("64x64 p5", dg64)):
        lv = cycle_of(dg).levels[-1]
        B, C = lv.blocks.shape[2], lv.blocks.shape[4]
        rand = _rand(rng)
        kernel_times(f"[7] K1 half-sweep color 1 at {name} finest shapes", soa.half_sweep,
                     (lv, rand(2, B, C), rand(2, B, C), 1), card)
    gemm_cases = [args for kern, args in kernel_cases(cyc8, np.random.default_rng(0))
                  + kernel_cases(cyc_direct, np.random.default_rng(0))[-1:]
                  if kern is soa.small_gemm]
    for args in gemm_cases:
        W, x = args[:2]
        four_ways(f"[7] small_gemm W {tuple(W.shape)} x {tuple(x.shape)}"
                  f"{' + base' if len(args) > 2 else ''} (8x8 p5)", soa.small_gemm, args,
                  small_gemm_library(*args), card)

    stokes_launches, stokes_launches32, stokes_ms, stokes8, dg32, dg8 = stokes_phases(
        card, rng, worst)
    timed.update(stokes_ms)

    # -- 12: K4 at every shape of the main paths -----------------------------
    configs = []
    for name, dg, cycle, cases in (
            ("Poisson 8x8 p5", flagship, cycle_of, kernel_cases),
            ("Poisson 64x64 p5", dg64, cycle_of, kernel_cases),
            ("Stokes 8x8", stokes8, stokes_cycle_of, stokes_kernel_cases),
            ("Stokes 32x32", dg32, stokes_cycle_of, stokes_kernel_cases)):
        cyc = cycle(dg)
        configs.append((name, cyc, dg.levels[-1].rhs.to(torch.float32), cases(cyc, rng)))
    k4_rows = geo_transfer_table(configs, card)
    # K4's record: its case with the most launches x time in a graph per cycle
    top = max(k4_rows, key=lambda r: r["per_cycle"] * r["graph_ms"])
    timed[soa.geo_transfer] = (top["args"], top["ms"], cuda_ms(
        lambda: soa.geo_transfer_plain(*top["args"]), 200))

    # -- 13: the streamed kernels against their plain versions ---------------
    from dgtpu_torch.ops import stokes_stream as sst
    from dgtpu_torch.ops import stream
    hyb32, hyb16 = (hybrid_of(dg64, l2_bytes, s) for s in ("float32", "bfloat16"))
    top = len(dg64.levels) - 1
    rand = _rand(rng)
    cases = []
    for h in (hyb32, hyb16):
        s = h.streams[top]
        cases += sweep_cases(s.lv, *s.sweep, rand)
        r, u = rand(2, s.lv.blocks.shape[2], s.C), rand(2, s.lv.blocks.shape[2], s.C)
        cases += [(soa.stencil_apply, (s.lv, s.res.to(torch.bfloat16), u, r, -1.0)),
                  (soa.stencil_apply, (s.lv, s.res.to(torch.bfloat16), u))]
    check_kernels(cases, "13 64x64 p5 finest", worst)
    C64 = hyb32.streams[top].C
    for name, bf16 in (("float32", False), ("bfloat16", True)):
        grid = dict(zip(("tiles", "cluster", "rows", "threads"),
                        _kernels.multi_half_sweep_grid(36, C64, bf16)))
        print(f"[13] K7 grid at 64x64 p5, {name} blocks: {grid_text(grid)} by default "
              f"(the card holds {_kernels.resident_clusters(36, C64, bf16)} at once), "
              f"1 and the resident count when asked", flush=True)
        if grid["tiles"] < -(-C64 // 32):
            raise AssertionError(f"K7's {name} clusters stride over the 64x64 p5 tiles: "
                                 f"{grid}")
    sl = sst.StreamedStokesLevel(dg32.levels[-1])
    check_kernels(streamed_stokes_cases(sl, rand), "13 Stokes 32x32 streamed", worst)
    per = synthetic_soa_level(rng, 16, 8, 8)
    bf = torch.cat([per.Dinv[:, None], per.blocks[:, 1:]], dim=1).to(torch.bfloat16)
    check_kernels(sweep_cases(per, per.blocks, per.Dinv, rand)
                  + sweep_cases(per, bf, bf[:, 0], rand), "13 synthetic O-grid", worst)

    # -- 14: the 64x64 route with bfloat16 sweep blocks ----------------------
    dg64.settings.performance.block_storage = "bfloat16"
    reset_counts()
    dg64.solve()
    torch.cuda.synchronize()
    launches64_bf16 = counts()
    dg64.settings.performance.block_storage = "float32"
    rel16 = abs(dg64.L2_error_u - hyb["L2_error_u"]) / hyb["L2_error_u"]
    sol16 = float(abs(dg64.u_nodal - hyb["u_nodal"]).max() / abs(hyb["u_nodal"]).max())
    print(f"[14] 64x64 p5 route, block storage bfloat16: {dg64.cycle_kind}, residual "
          f"{dg64.solve_residual:.3e} (normalized), {dg64.outer_rounds} outer rounds "
          f"(float32 storage {hyb['outer_rounds']}), L2(u) {dg64.L2_error_u:.9e} (rel "
          f"to [6] {rel16:.2e}; nodal u against [6] {sol16:.2e} relative), "
          f"{solve_text(dg64)}; launches {launches64_bf16}", flush=True)
    if dg64.cycle_kind != "streamed hybrid":
        raise AssertionError("the bfloat16 64x64 route did not run the hybrid")
    not_launched(launches64_bf16, POISSON_HYBRID_KERNELS, "the bfloat16 64x64 route")
    if not dg64.solve_residual < RES_TOL or not sol16 < RES_TOL:
        raise AssertionError("the bfloat16-storage 64x64 solve missed its bars")

    # -- 15: the 32x32 Stokes route through the streamed Stokes hybrid -------
    n32 = len(dg32.levels)
    budget32 = ss.SoAStokesVCycle.device_bytes(dg32.levels[:n32 - 2],
                                               dg32.transfers[:n32 - 3])
    dg32.settings.solver.multigrid.full_multigrid = True
    reset_counts()
    with stream_budget(budget32):
        dg32.solve()
    torch.cuda.synchronize()
    launches32h = counts()
    dg32.settings.solver.multigrid.full_multigrid = False
    rel_l2 = check_stokes_errors(dg32, 32)
    print(f"[15] 32x32 Stokes route, budget {budget32} bytes: {dg32.cycle_kind} cut at "
          f"{dg32.cut} of {n32} levels, FMG seed; residual {dg32.solve_residual:.3e} "
          f"(normalized), inner {dg32.inner}, outer rounds {dg32.rounds}, L2(u) "
          f"{dg32.L2_error_u:.9e}, L2(v) {dg32.L2_error_v:.9e}, L2(p) "
          f"{dg32.L2_error_p:.9e} (rel to dgtpu {rel_l2}), "
          f"{solve_text(dg32)}; launches {launches32h}", flush=True)
    if dg32.cycle_kind != "streamed Stokes hybrid" or dg32.cut != n32 - 2:
        raise AssertionError("the 32x32 Stokes route did not stream two levels")
    if not dg32.solve_residual < RES_TOL:
        raise AssertionError("the 32x32 Stokes hybrid solve did not reach 1e-10")
    not_launched(launches32h, [k.__name__ for k in ss.CYCLE_KERNELS + stream.KERNELS],
                 "the 32x32 Stokes hybrid route")

    # -- 16: SoA cycle against the hybrids; K7 and bfloat16 K5 per call ------
    n64 = dg64.levels[-1].rhs.numel()
    for name, h in (("float32", hyb32), ("bfloat16", hyb16)):
        check_graph(f"[16] 64x64 p5 hybrid {name} V-cycle", h, n64, 2, rng)
    hyb_s = stokes_hybrid_of(dg32, budget32)
    n32s = dg32.levels[-1].rhs.numel()
    check_graph("[16] 32x32 Stokes hybrid W-cycle", hyb_s, n32s, 2, rng)
    check_graph("[16] 32x32 Stokes hybrid matvec", hyb_s.build_matvec(), n32s, 1, rng)
    for name, h in (("float32", hyb32), ("bfloat16", hyb16)):
        size = h.bytes_per_cycle()
        print(f"[16] 64x64 p5 hybrid {name}: {size / 1e6:.3f} MB of operators per "
              f"V-cycle (bytes_per_cycle), {size / HBM_BYTES_PER_S * 1e3:.4f} ms at the "
              f"card's memory rate", flush=True)
    cycles_in_turns({"SoA": cycle_of(dg64), "hybrid float32": hyb32,
                     "hybrid bfloat16": hyb16},
                    dg64.levels[-1].rhs.to(torch.float32), 5, "64x64 p5 V-cycle", card)
    cycles_in_turns({"SoA": stokes_cycle_of(dg32), "hybrid": hyb_s},
                    dg32.levels[-1].rhs.to(torch.float32), 2, "32x32 Stokes W-cycle", card)
    s32, s16 = hyb32.streams[top], hyb16.streams[top]
    B, C = s32.lv.blocks.shape[2], s32.C
    r, u = rand(2, B, C), rand(2, B, C)
    pre = 4 * hyb32._cfg[hyb32.types[top - 1]][0]
    per_call = {
        "K7 float32, pre-smoother from u": (stream.multi_half_sweep,
                                           (s32.lv, *s32.sweep, r, u, pre)),
        "K7 bfloat16, pre-smoother from u": (stream.multi_half_sweep,
                                            (s16.lv, *s16.sweep, r, u, pre)),
        "K7 bfloat16, defect form": (stream.multi_half_sweep,
                                     (s16.lv, *s16.sweep, r, None, pre, u)),
        "K5 bfloat16 residual": (soa.stencil_apply,
                                 (s32.lv, s32.res.to(torch.bfloat16), u, r, -1.0)),
        "K5 float32 residual": (soa.stencil_apply, (s32.lv, s32.res, u, r, -1.0)),
    }
    Bu, Np, Cs = sl.lv.A.shape[2], sl.lv.G.shape[2], sl.lv.A.shape[4]
    uv, p, f, g = rand(2, Bu, Cs), rand(2, Np, Cs), rand(2, Np, Cs), rand(2, Bu, Cs)
    stokes_calls = {
        "K5 matvec A uv": (soa.stencil_apply, (sl.lv, sl.lv.A, uv)),
        "K6 DG pass color 1 + base": (sst.dg_pass, (sl, f, p, g, 1, p)),
    }
    for shapes, calls in (("64x64 p5", per_call), ("32x32 Stokes", stokes_calls)):
        for name, (kern, args) in calls.items():
            ms = cuda_ms(lambda: kern(*args), 50)
            plain_ms = cuda_ms(lambda: plain_version(kern)(*args), 10)
            b_ms, b_by = bound(kern, args)
            print(f"[16] {name} at {shapes} streamed finest shapes: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                  f"{work(kern, args)[0] / 1e6:.3f} MB) ({card})", flush=True)
            if kern is stream.multi_half_sweep:
                timed.setdefault(kern, (args, ms, plain_ms))
            kernel_times(f"[16] {name} at {shapes} streamed finest shapes", kern, args,
                         card, 20 if kern is stream.multi_half_sweep else 200)

    rolled_paths, rolled_ms, l2_direct = rolled_phases(card, rng, worst, ogrid, u_soa,
                                                       soa_ms)
    timed.update(rolled_ms)

    # -- 22: the routes outside the mixed multigrid (no kernel runs there) ----
    reset_counts()
    solver_route_phases(card, {n: {v: getattr(dg, f"L2_error_{v}") for v in "uvp"}
                               for n, dg in ((8, dg8), (32, dg32))}, l2_direct)
    launched = {k: v for k, v in counts().items() if v}
    if launched:
        raise AssertionError(f"phase 22 launched kernels: {launched}")

    # -- 23: -fvm, the FVM levels, -amp, the check switches, the orthonormal
    # basis, caching and the host C++ kernels ---------------------------------
    other_paths = other_route_phases(card, rng, l2_poisson8, dg8, flagship)

    # -- 24: the sharded multigrid, --profile and the studies ----------------
    sharded_paths = sharded_and_tools_phases(card, dg64, u_soa)

    paths = {"poisson_8x8": launches, "poisson_64x64_hybrid": launches64,
             "poisson_64x64_hybrid_bf16": launches64_bf16,
             "stokes_8x8": stokes_launches, "stokes_32x32": stokes_launches32,
             "stokes_32x32_hybrid": launches32h, **rolled_paths, **other_paths,
             **sharded_paths}
    rolled_site = "dgtpu/ops/pallas_vcycle.py:326"
    replaces = {
        soa.half_sweep: "dgtpu/ops/pallas_soa.py:574, dgtpu/ops/pallas_stokes.py:739",
        soa.stencil_apply: "dgtpu/ops/pallas_soa.py:574, dgtpu/ops/pallas_stokes.py:739, "
                           "dgtpu/ops/pallas_stream.py:376, dgtpu/ops/pallas_stream.py:435",
        soa.small_gemm: "dgtpu/ops/pallas_soa.py:574, dgtpu/ops/pallas_stokes.py:739",
        soa.geo_transfer: "dgtpu/ops/pallas_soa.py:574, dgtpu/ops/pallas_stokes.py:739",
        ss.dg_half_sweep: "dgtpu/ops/pallas_stokes.py:739, dgtpu/ops/pallas_stream.py:496",
        stream.multi_half_sweep: "dgtpu/ops/pallas_stream.py:315",
        **{k: rolled_site for k in vcycle.KERNELS},
    }
    record = []
    for kern in all_kernels():
        by_path = {p: c.get(kernel_name(kern), 0) for p, c in paths.items()}
        args, ms, plain_ms = timed[kern]
        b_ms, b_by = bound(kern, args)
        library = library_of(kern, args)
        library_ms = None if library is None else cuda_ms(library[0], 200)
        library_graph_ms = None if library is None else graph_ms(library[0])
        kernel_graph_ms = graph_ms(lambda: kern(*args),
                                   20 if kern is stream.multi_half_sweep else 200)
        source = _kernels.ROLLED_SOURCE if kern in vcycle.KERNELS else _kernels.SOURCE
        record.append({"name": kernel_name(kern), "route": "cuda",
                       "source": os.path.relpath(source, REPO),
                       "replaces": replaces[kern], "launches": sum(by_path.values()),
                       "launches_by_path": by_path, "max_abs_err": worst[kern][0],
                       "max_rel_err": worst[kern][1],
                       "ms": ms, "graph_ms": kernel_graph_ms, "plain_ms": plain_ms,
                       "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
                       "library_graph_ms": library_graph_ms,
                       "library": None if library is None else library[1]})
        grid = grid_record(kern, args)
        if grid is not None:
            record[-1]["launch_grid"] = grid
        if record[-1]["launches"] == 0:
            raise AssertionError(f"{kernel_name(kern)} was launched by no main path")

    print(f"K1, K6 and K7 held to their plain versions at the launch geometries (cell "
          f"tiles or clusters, CTAs per cluster, output modes per CTA, threads per CTA) "
          f"{ {kernel_name(k): sorted(g) for k, g in CHECKED_GRIDS.items()} }", flush=True)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(json.dumps({"kernels": record, "launch_floor": floor}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
