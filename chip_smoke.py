#!/usr/bin/env python3
"""Smoke test of dgtpu_torch on one NVIDIA GPU: the quickest proof that the
port builds, runs its CUDA kernels and solves on the card.

    python3 chip_smoke.py             # every phase below
    python3 chip_smoke.py --profile   # phases 1-2, then the profile

Phases (each prints one line; any failure raises, so the exit code is not 0):
  1. the card (name and power limit from nvidia-smi);
  2. build the CUDA kernels of dgtpu_torch/csrc/soa_kernels.cu with nvcc;
  3. each Poisson kernel (K1 half-sweep, K5 stencil apply as the residual,
     K3 small GEMM, K4 geometric transfer) against its plain torch version
     on the same inputs, at the 8x8 p=5 hierarchy's shapes and on the 4x4
     O-grid;
  4. one whole cycle on the 8x8 p=5 hierarchy, kernel path against plain path;
  5. the CLI route ``python -m dgtpu_torch -m --precision mixed`` on the
     default paramfile, with the launch count of every kernel;
  6. the same route on Rectangle_64X64_nPoly5 (factors 16,8,4,2, FMG seed);
  7. marginal cycle times (CUDA events, slope between k and 8k cycles);
  8. each kernel of the Stokes cycle (K1, K3, K4, K5 and K6 pressure DG
     half-sweep) against its plain version at every shape of the 8x8
     p_u=2/p_p=1 Stokes hierarchy, and K1/K5/K6 on a synthetic O-grid;
  9. one whole 8x8 Stokes W-cycle, kernel path against plain path;
 10. the Stokes CLI route at 8x8 through a temporary paramfile, with the
     launch count of every kernel;
 11. the Stokes route on Rectangle_32X32_nPoly2 (6 levels; GMRES-wrapped
     refinement when the plain one stalls), with the launch count of every
     kernel, then each kernel against its plain version at every shape of
     the 32x32 hierarchy;
 12. marginal Stokes W-cycle times and launches per cycle, and per-call
     times of K5 and K6 beside their plain versions.
The last lines are the kernels' JSON record, the nvidia-smi line and
``{"ok": true, "device": {...}}``.  Exits non-zero without CUDA or without
the rest of the repository.

``--profile`` runs ``torch.profiler`` over the cycles of the four
configurations (kernel and plain paths: device-busy time, device ops per
cycle, the top device ops) and over single calls of the kernels at the
finest levels' shapes (device us per call, bytes moved, GB/s).
"""

import copy
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# dgtpu's L2(u) for the same route (8x8 p=5, mixed precision), computed on a
# CPU with the JAX reference package:
#   JAX_PLATFORMS=cpu python -c "from dgtpu.__main__ import main; \
#     print(repr(main(['-m', '--precision', 'mixed', '--silent', \
#     '--backend', 'cpu']).L2_error_u))"
DGTPU_L2_8X8_P5 = 5.109734421089843e-06
L2_REL_TOL = 1e-6          # port vs dgtpu, 8x8 p=5
KERNEL_REL_TOL = 1e-5      # f32 kernel vs f32 plain, relative to max|plain|
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
    32: {"u": 0.0001539444269394462, "v": 0.00015394453731214222,
         "p": 0.0021337602694521955},
}
STOKES_CYCLE_REL_TOL = 5e-3   # whole f32 W-cycle, kernels vs plain (dgtpu's
                              # bound between its f32 fused and XLA cycles)


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
    from dgtpu_torch.ops import soa
    from dgtpu_torch.ops import stokes_soa as ss
    return {**soa.PLAIN, **ss.PLAIN}[kern]


def check_kernels(cases, label, worst):
    """Each kernel's output against its plain version; records the worst
    absolute error per kernel in ``worst``."""
    import torch
    for kern, args in cases:
        got = kern(*args)
        ref = plain_version(kern)(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = err / max(float(ref.abs().max()), 1e-30)
        worst[kern] = max(worst.get(kern, 0.0), err)
        print(f"[{label}] {kern.__name__:13s} shape {tuple(got.shape)}: "
              f"max abs err {err:.3e}, rel {rel:.3e}", flush=True)
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
    CLI route and of the 32x32 route, and {kernel: (ms, plain ms)} of K5 and
    K6 at the 8x8 finest shapes."""
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
          f"L2(p) {dg8.L2_error_p:.9e} (rel to dgtpu {rel_l2}), solve "
          f"{dg8.solve_seconds:.3f} s; launches {launches}", flush=True)
    if not dg8.solve_residual < RES_TOL:
        raise AssertionError("the 8x8 Stokes solve did not reach 1e-10")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the Stokes route: {missing}")

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
          f"solve {dg32.solve_seconds:.3f} s; launches {launches32}", flush=True)
    if not dg32.solve_residual < RES_TOL:
        raise AssertionError("the 32x32 Stokes solve did not reach 1e-10")
    if not (ratios["u"] >= 8 and ratios["v"] >= 8 and ratios["p"] >= 4):
        raise AssertionError(f"32x32 errors not far enough below 8x8: {ratios}")
    missing = [n for n, c in launches32.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the 32x32 route: {missing}")
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
        kern_ms = marginal_ms(cyc, rhs, k)
        plain_ms = marginal_ms(stokes_cycle_of(dg, reference=True), rhs, k)
        print(f"[12] {name} Stokes marginal W-cycle time: kernels {kern_ms:.4f} ms, "
              f"plain torch {plain_ms:.4f} ms; kernel launches per cycle "
              f"{sum(per_cycle.values())} {per_cycle} ({card})", flush=True)
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
            stokes_ms.setdefault(kern, (ms, plain_ms))   # the 8x8 times
    return launches, launches32, stokes_ms


def reset_counts():
    """Set the launch count of every kernel to 0."""
    from dgtpu_torch.ops import soa
    from dgtpu_torch.ops import stokes_soa as ss
    soa.reset_launch_counts()
    ss.reset_launch_counts()


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
    rand = _rand(np.random.default_rng(1))
    mb = lambda *ts: sum(t.numel() for t in ts) * 4 / 1e6   # noqa: E731
    for name, make, cycle, n in configs:
        dg = make()
        rhs = dg.levels[-1].rhs.to(torch.float32)
        for ref in (False, True):
            cyc = cycle(dg, reference=ref)
            u0 = torch.zeros_like(rhs)
            calls = n if not ref else max(1, n // 5)
            wall, ops = device_ops(lambda: cyc(rhs, u0), calls)
            busy = sum(v[1] for v in ops.values()) / calls
            top = sorted(ops.items(), key=lambda kv: -kv[1][1])[:5]
            print(f"[prof] {name} {'plain' if ref else 'kernels'}: host "
                  f"{wall:.1f} us/cycle (profiled), device busy {busy:.1f} us/cycle, "
                  f"share {busy / wall:.4f}, device ops/cycle "
                  f"{sum(v[0] for v in ops.values()) / calls:.1f}; top (op, "
                  f"calls/cycle, us/cycle) "
                  f"{[(k[:40], v[0] / calls, round(v[1] / calls, 2)) for k, v in top]} "
                  f"({card})", flush=True)
        cyc = cycle(dg)
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


def check_stokes_errors(dg, n):
    """L2(u, v, p) against dgtpu's pinned values at 1e-6 relative; returns
    the relative differences."""
    rel = {v: abs(getattr(dg, f"L2_error_{v}") - ref) / ref
           for v, ref in DGTPU_STOKES_L2[n].items()}
    if not all(r < L2_REL_TOL for r in rel.values()):
        raise AssertionError(f"{n}x{n} Stokes L2 errors differ from dgtpu's: {rel}")
    return {v: float(f"{r:.2e}") for v, r in rel.items()}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from dgtpu_torch.ops import _kernels, soa
    from dgtpu_torch.ops import stokes_soa as ss
    from dgtpu_torch.__main__ import main as cli

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    _kernels.library()
    print(f"[2] built {os.path.relpath(_kernels.SOURCE, REPO)} with nvcc for "
          f"sm_90a in {time.perf_counter() - t0:.2f} s", flush=True)
    if "--profile" in sys.argv[1:]:
        profile(card)
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

    # -- 5: the CLI route on the default paramfile ---------------------------
    soa.reset_launch_counts()
    dg8 = cli(["-m", "--precision", "mixed", "--silent"])
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in soa.KERNELS}
    l2_rel = abs(dg8.L2_error_u - DGTPU_L2_8X8_P5) / DGTPU_L2_8X8_P5
    print(f"[5] 8x8 p5 CLI route: residual {dg8.solve_residual:.3e} (normalized), "
          f"{dg8.residual:.3e} (L2), {dg8.outer_rounds} outer rounds, "
          f"L1(u) {dg8.L1_error_u:.6e}, L2(u) {dg8.L2_error_u:.9e} "
          f"(dgtpu {DGTPU_L2_8X8_P5:.9e}, rel {l2_rel:.2e}), "
          f"solve {dg8.solve_seconds:.3f} s; launches {launches}", flush=True)
    if not dg8.solve_residual < RES_TOL:
        raise AssertionError("the 8x8 solve did not reach 1e-10")
    if not l2_rel < L2_REL_TOL:
        raise AssertionError("8x8 L2(u) differs from dgtpu's")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the main path: {missing}")

    # -- 6: the same route at 64x64 ------------------------------------------
    t0 = time.perf_counter()
    dg64 = hierarchy(settings_for("Rectangle_64X64_nPoly5.xyz", 5,
                                  factors="16,8,4,2", fmg=True))
    setup_s = time.perf_counter() - t0
    soa.reset_launch_counts()
    dg64.solve()
    torch.cuda.synchronize()
    launches64 = {k.__name__: k.launches for k in soa.KERNELS}
    print(f"[6] 64x64 p5 route (factors 16,8,4,2, FMG): residual "
          f"{dg64.solve_residual:.3e} (normalized), {dg64.residual:.3e} (L2), "
          f"{dg64.outer_rounds} outer rounds, L1(u) {dg64.L1_error_u:.6e}, "
          f"L2(u) {dg64.L2_error_u:.6e} ({dg8.L2_error_u / dg64.L2_error_u:.3g}x "
          f"below 8x8), setup {setup_s:.2f} s, solve {dg64.solve_seconds:.3f} s; "
          f"launches {launches64}", flush=True)
    if not dg64.solve_residual < RES_TOL:
        raise AssertionError("the 64x64 solve did not reach 1e-10")
    if not dg64.L2_error_u * 100 <= dg8.L2_error_u:
        raise AssertionError("64x64 L2(u) is not 100x below 8x8")

    # -- 7: timings ----------------------------------------------------------
    for name, dg in (("8x8 p5", flagship), ("64x64 p5", dg64)):
        rhs = dg.levels[-1].rhs.to(torch.float32)
        kern_ms = marginal_ms(cycle_of(dg), rhs)
        plain_ms = marginal_ms(cycle_of(dg, reference=True), rhs)
        print(f"[7] {name} marginal cycle time: kernels {kern_ms:.4f} ms, plain "
              f"torch {plain_ms:.4f} ms ({card})", flush=True)

    poisson_ms = {}
    timing_case = {}
    for kern, args in kernel_cases(cyc8, np.random.default_rng(0)):
        timing_case[kern] = args   # the last case: the finest level's
    for kern in soa.KERNELS:
        args = timing_case[kern]
        ms = cuda_ms(lambda: kern(*args), 200)
        plain_ms = cuda_ms(lambda: plain_version(kern)(*args), 200)
        poisson_ms[kern] = (ms, plain_ms)
        print(f"[7] {kern.__name__} at 8x8 p5 shapes: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms ({card})", flush=True)

    stokes_launches, stokes_launches32, stokes_ms = stokes_phases(card, rng, worst)

    record = []
    for kern in ss.CYCLE_KERNELS:
        replaces = ("dgtpu/ops/pallas_stokes.py:739" if kern in ss.KERNELS
                    else "dgtpu/ops/pallas_soa.py:574, dgtpu/ops/pallas_stokes.py:739")
        by_path = {"poisson_8x8": launches.get(kern.__name__, 0),
                   "stokes_8x8": stokes_launches.get(kern.__name__, 0),
                   "stokes_32x32": stokes_launches32.get(kern.__name__, 0)}
        ms, plain_ms = stokes_ms.get(kern, poisson_ms.get(kern))
        record.append({"name": kern.__name__, "route": "cuda",
                       "source": os.path.relpath(_kernels.SOURCE, REPO),
                       "replaces": replaces, "launches": sum(by_path.values()),
                       "launches_by_path": by_path, "max_abs_err": worst[kern],
                       "ms": ms, "plain_ms": plain_ms})

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(json.dumps({"kernels": record}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
