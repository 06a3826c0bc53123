#!/usr/bin/env python3
"""Smoke test of dgtpu_torch on one NVIDIA GPU: the quickest proof that the
port builds, runs its CUDA kernels and solves on the card.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises, so the exit code is not 0):
  1. the card (name and power limit from nvidia-smi);
  2. build the CUDA kernels from dgtpu_torch/csrc with nvcc;
  3. each kernel (K1 half-sweep, K2 residual, K3 small GEMM, K4 geometric
     transfer) against its plain torch version on the same inputs, at the
     8x8 p=5 hierarchy's shapes and on the 4x4 O-grid;
  4. one whole cycle on the 8x8 p=5 hierarchy, kernel path against plain path;
  5. the CLI route ``python -m dgtpu_torch -m --precision mixed`` on the
     default paramfile, with the launch count of every kernel;
  6. the same route on Rectangle_64X64_nPoly5 (factors 16,8,4,2, FMG seed);
  7. marginal cycle times (CUDA events, slope between k and 8k cycles).
The last lines are the kernels' JSON record, the nvidia-smi line and
``{"ok": true, "device": {...}}``.  Exits non-zero without CUDA or without
the rest of the repository.
"""

import copy
import json
import os
import subprocess
import sys
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


def kernel_cases(cyc, rng):
    """(kernel, args) at every shape the cycle gives each kernel, with
    random inputs from ``rng``."""
    import torch
    from dgtpu_torch.ops import soa

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                               device="cuda")

    cases = []
    for k, lv in enumerate(cyc.levels):
        B, C = lv.blocks.shape[2], lv.blocks.shape[4]
        rhs, u = rand(2, B, C), rand(2, B, C)
        for color in (0, 1):
            cases.append((soa.half_sweep, (lv, rhs, u, color)))
        if k > 0:
            cases.append((soa.residual, (lv, rhs, u)))
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from dgtpu_torch.ops import _kernels, soa
    from dgtpu_torch.__main__ import main as cli

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    _kernels.library()
    print(f"[2] built {os.path.relpath(_kernels.SOURCE, REPO)} with nvcc for sm_90a "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)

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
    worst = {k: 0.0 for k in soa.KERNELS}
    for name, cyc in (("8x8 p5", cyc8), ("8x8 p5 direct coarse", cyc_direct),
                      ("4x4 O-grid p2", cyc_o)):
        for kern, args in kernel_cases(cyc, rng):
            got = kern(*args)
            ref = soa.PLAIN[kern](*args)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            rel = err / max(float(ref.abs().max()), 1e-30)
            worst[kern] = max(worst[kern], err)
            print(f"[3] {kern.__name__:12s} {name:22s} shape {tuple(got.shape)}: "
                  f"max abs err {err:.3e}, rel {rel:.3e}", flush=True)
            if not rel < KERNEL_REL_TOL:
                raise AssertionError(f"{kern.__name__} disagrees with its plain "
                                     f"version: rel {rel:.3e}")

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
    def marginal_ms(cyc, rhs, k=5):
        u = torch.zeros_like(rhs)

        def run(n):
            def go():
                v = u
                for _ in range(n):
                    v = cyc(rhs, v)
            return cuda_ms(go, 1)
        return (run(8 * k) - run(k)) / (7 * k)

    for name, dg in (("8x8 p5", flagship), ("64x64 p5", dg64)):
        rhs = dg.levels[-1].rhs.to(torch.float32)
        kern_ms = marginal_ms(cycle_of(dg), rhs)
        plain_ms = marginal_ms(cycle_of(dg, reference=True), rhs)
        print(f"[7] {name} marginal cycle time: kernels {kern_ms:.4f} ms, plain "
              f"torch {plain_ms:.4f} ms ({card})", flush=True)

    record = []
    timing_case = {}
    for kern, args in kernel_cases(cyc8, np.random.default_rng(0)):
        timing_case[kern] = args   # the last case: the finest level's
    for kern in soa.KERNELS:
        args = timing_case[kern]
        ms = cuda_ms(lambda: kern(*args), 200)
        plain_ms = cuda_ms(lambda: soa.PLAIN[kern](*args), 200)
        print(f"[7] {kern.__name__} at 8x8 p5 shapes: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms ({card})", flush=True)
        record.append({"name": kern.__name__, "route": "cuda",
                       "source": "dgtpu_torch/csrc/soa_kernels.cu",
                       "replaces": "dgtpu/ops/pallas_soa.py:574",
                       "launches": launches[kern.__name__],
                       "max_abs_err": worst[kern], "ms": ms, "plain_ms": plain_ms})

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
