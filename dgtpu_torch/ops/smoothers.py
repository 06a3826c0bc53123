"""Element-block relaxation smoothers (port of ``dgtpu/ops/smoothers.py``).

The reference's smoother menu (``dgfem/relaxation.py:103-218``) — jacobi,
jacobi_pyamg, block_jacobi, gauss_seidel, gauss_seidel_pyamg,
block_gauss_seidel, block_gauss_seidel_pyamg — reduces to two updates over
the element-block partition:

* **block Jacobi**:       x <- w * Dinv (b - (A - D) x) + (1 - w) x
* **block Gauss-Seidel**: for block rows i in sweep order,
                          x_i <- Dinv_i (b_i - sum_{j!=i} A_ij x_j)

Two execution strategies:

* ``sequential`` — the lexicographic sweep of the reference / pyamg
  (forward / backward / symmetric): the parity mode that reproduces residual
  histories.  dgtpu scans the N cells one by one.  Here the sweep runs by
  wavefronts of the dependency graph (:func:`sweep_fronts`; anti-diagonals
  ``i + j = const`` on a structured grid): the cells of one front depend only
  on earlier fronts, across an O-grid's seam too, so each cell sees exactly
  the values the cell-by-cell loop gives it, in ~Ni + Nj batched steps
  instead of N.
* ``redblack`` — checkerboard-colored sweeps, one batched update per color
  (a permitted numerical deviation: the iteration matrix differs from
  lexicographic GS), optionally over color-packed blocks (``ColorPack``).

Plain torch on the operator's device: dgtpu runs these outside any Pallas
kernel.
"""

import logging

import numpy as np
import torch

from dgtpu_torch.ops.linalg import host_inv
from dgtpu_torch.ops.rolled import bmv


def block_diag_inv(op):
    # setup-time inversion on host LAPACK, as dgtpu does
    return host_inv(op.diag_blocks())


def block_jacobi(op, rhs, u, omega=1.0, iterations=1, Dinv=None):
    """Damped block Jacobi (relaxation.py:103-150 semantics)."""
    n, _, br, bc = op.blocks.shape
    if Dinv is None:
        Dinv = block_diag_inv(op)
    rhs2 = rhs.reshape(n, br)
    u = u.reshape(-1)
    for _ in range(iterations):
        off = op.offdiag_matvec(u).reshape(n, br)
        unew = bmv(Dinv, rhs2 - off)
        u = (omega * unew + (1 - omega) * u.reshape(n, bc)).reshape(-1)
    return u


def sweep_fronts(op, backward=False):
    """Wavefronts of the lexicographic block-GS sweep over ``op``'s stencil:
    a list of int64 index tensors.  Cell e waits for its neighbors earlier
    in the sweep order (n < e forward, n > e backward), so its front is one
    past the latest of theirs; cells of one front are independent, and every
    later-ordered neighbor of a cell lies in a later front (the stencil's
    adjacency is symmetric), so it still holds its old value when the cell
    updates."""
    nbr = op.nbr.cpu().numpy()[:, 1:]
    mask = op.mask.cpu().numpy()[:, 1:]
    n = nbr.shape[0]
    front = np.zeros(n, np.int64)
    for e in (range(n - 1, -1, -1) if backward else range(n)):
        earlier = mask[e] & ((nbr[e] > e) if backward else (nbr[e] < e))
        if earlier.any():
            front[e] = front[nbr[e][earlier]].max() + 1
    return [torch.as_tensor(np.nonzero(front == f)[0], device=op.blocks.device)
            for f in range(int(front.max()) + 1)]


def _gs_sweep_sequential(op, rhs, u, Dinv, omega, backward, fronts=None):
    """One lexicographic block-GS sweep, a batched update per wavefront.
    ``u`` and ``rhs`` are (..., N*B): leading dimensions are a batch of
    independent vectors swept together (the amplification analysis sweeps
    every Fourier mode at once)."""
    n, _, br, bc = op.blocks.shape
    lead = u.shape[:-1]
    rhs2 = rhs.reshape(*lead, n, br)
    u = u.reshape(*lead, n, bc).clone()
    if fronts is None:
        fronts = sweep_fronts(op, backward)
    off_blocks, off_nbr = op.blocks[:, 1:], op.nbr[:, 1:]
    for idx in fronts:
        ublk = u[..., off_nbr[idx], :]                      # (..., m, 4, Bc)
        contrib = torch.einsum("nsij,...nsj->...ni", off_blocks[idx], ublk)
        r = rhs2[..., idx, :] - contrib
        # a batch contracts Dinv once for all its vectors (a broadcast
        # matmul would copy Dinv per vector)
        unew = torch.einsum("nij,...nj->...ni", Dinv[idx], r) if lead else bmv(Dinv[idx], r)
        u[..., idx, :] = omega * unew + (1 - omega) * u[..., idx, :]
    return u.reshape(*lead, n * bc)


def _gs_sweep_colored(op, rhs, u, Dinv, omega, colors):
    """Red-black block-GS sweep: one batched update per color."""
    n, _, br, bc = op.blocks.shape
    rhs2 = rhs.reshape(n, br)
    u = u.reshape(n, bc)
    for c in (0, 1):
        sel = (colors == c)[:, None]
        off = op.offdiag_matvec(u.reshape(-1)).reshape(n, br)
        unew = bmv(Dinv, rhs2 - off)
        unew = omega * unew + (1 - omega) * u
        u = torch.where(sel, unew, u)
    return u.reshape(-1)


class ColorPack:
    """Per-color packed off-diagonal blocks for red-black sweeps: each
    color's rows (idx_c, 4 off-diagonal slots) gathered once at setup, so a
    color pass reads half the stencil's rows.  The update math is that of
    ``_gs_sweep_colored`` (neighbors are gathered from the same pre-update
    vector either way)."""

    def __init__(self, op, colors):
        zero = torch.zeros((), dtype=op.blocks.dtype, device=op.blocks.device)
        self.idx, self.off_blocks, self.off_nbr = [], [], []
        for c in (0, 1):
            idx = torch.nonzero(colors == c)[:, 0]
            self.idx.append(idx)
            self.off_blocks.append(torch.where(op.mask[idx][:, 1:, None, None],
                                               op.blocks[idx][:, 1:], zero))
            self.off_nbr.append(op.nbr[idx][:, 1:])


def _gs_sweep_packed(op, rhs, u, Dinv, omega, pack):
    """Red-black sweep over color-packed blocks (same math, less traffic)."""
    n, _, br, bc = op.blocks.shape
    rhs2 = rhs.reshape(n, br)
    u = u.reshape(n, bc).clone()
    for c in (0, 1):
        idx = pack.idx[c]
        u_nbr = u[pack.off_nbr[c]]                          # (nc, 4, bc)
        off = torch.einsum("nsij,nsj->ni", pack.off_blocks[c], u_nbr)
        unew = bmv(Dinv[idx], rhs2[idx] - off)
        u[idx] = omega * unew + (1 - omega) * u[idx]
    return u.reshape(-1)


def estimate_rho_dinv_a(op, Dinv=None, iterations=30, seed=7, v0=None):
    """Spectral-radius estimate of D^-1 A by power iteration (setup-time),
    to set the Chebyshev smoothing interval: ~30 iterations give rho to a
    few percent, and the caller's 1.1 safety factor absorbs the slack.  The
    start vector is ``v0`` or standard normal from a ``torch.Generator``
    seeded with ``seed`` (not the numbers of dgtpu's PRNG)."""
    if Dinv is None:
        Dinv = block_diag_inv(op)
    n, _, br, _ = op.blocks.shape
    if v0 is None:
        gen = torch.Generator().manual_seed(seed)
        v0 = torch.randn(n * br, generator=gen, dtype=torch.float64)
    v = v0.to(device=op.blocks.device, dtype=op.blocks.dtype)
    v = v / torch.linalg.norm(v)
    rho = 1.0
    for _ in range(int(iterations)):
        w = bmv(Dinv, op.matvec(v).reshape(n, br)).reshape(-1)
        rho = torch.linalg.norm(w)
        v = w / rho
    return float(rho)


def chebyshev(op, rhs, u, degree=3, eig_max=None, eig_ratio=0.3, Dinv=None):
    """Chebyshev polynomial smoother on the block-Jacobi-preconditioned
    operator: ``degree`` stencil matvecs and batched block solves, no
    sequential sweep and no coloring.  Damps the interval
    [eig_ratio*lmax, lmax] of D^-1 A; ``eig_max`` should be a
    power-iteration estimate (``estimate_rho_dinv_a``) times a ~1.1 safety
    factor, supplied by the caller at setup."""
    if Dinv is None:
        Dinv = block_diag_inv(op)
    if eig_max is None:
        eig_max = 1.1 * estimate_rho_dinv_a(op, Dinv)
    n, _, br, bc = op.blocks.shape
    lmax = float(eig_max)
    lmin = eig_ratio * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta

    def prec_residual(x):
        r = (rhs - op.matvec(x)).reshape(n, br)
        return bmv(Dinv, r).reshape(-1)

    x = u.reshape(-1)
    d = prec_residual(x) / theta
    x = x + d
    rho = 1.0 / sigma
    for _ in range(int(degree) - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        z = prec_residual(x)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * z
        x = x + d
        rho = rho_new
    return x


def element_colors(Ni, Nj, device=None):
    """Checkerboard coloring of the element grid (m = j*Ni + i)."""
    m = torch.arange(Ni * Nj, device=device)
    return ((m % Ni + m // Ni) % 2).to(torch.int32)


def block_gauss_seidel(op, rhs, u, direction="symmetric", omega=1.0, iterations=1,
                       Dinv=None, strategy="sequential", colors=None, pack=None,
                       fronts=None):
    """Block Gauss-Seidel with pyamg sweep semantics.

    ``direction``: 'forward' | 'backward' | 'symmetric' (forward then backward
    per iteration, pyamg_relaxation.py:240-250).  ``fronts``: the
    (forward, backward) wavefronts of the sequential sweep
    (``sweep_fronts``), computed here when not given.
    """
    if Dinv is None:
        Dinv = block_diag_inv(op)
    u = u.reshape(-1)

    if strategy == "redblack":
        if colors is None and pack is None:
            raise ValueError("redblack strategy needs element colors")
        # direction is immaterial for colored sweeps; symmetric does 2 passes
        n_pass = 2 if direction == "symmetric" else 1
        for _ in range(iterations * n_pass):
            if pack is not None:
                u = _gs_sweep_packed(op, rhs, u, Dinv, omega, pack)
            else:
                u = _gs_sweep_colored(op, rhs, u, Dinv, omega, colors)
        return u

    if fronts is None:
        fronts = (sweep_fronts(op), sweep_fronts(op, backward=True))
    for _ in range(iterations):
        if direction in ("forward", "symmetric"):
            u = _gs_sweep_sequential(op, rhs, u, Dinv, omega, False, fronts[0])
        if direction in ("backward", "symmetric"):
            u = _gs_sweep_sequential(op, rhs, u, Dinv, omega, True, fronts[1])
    return u


SMOOTHER_ALIASES = {
    # every reference smoother string -> the update it runs
    "jacobi": "jacobi",
    "jacobi_pyamg": "jacobi",
    "block_jacobi": "jacobi",
    "gauss_seidel": "gs",
    "gauss_seidel_pyamg": "gs",
    "block_gauss_seidel": "gs",
    "block_gauss_seidel_pyamg": "gs",
    "block_gauss_seidel_rb": "gs_rb",
    "distributive_gauss_seidel": "dgs",
    "chebyshev": "cheby",
}


def normalize_smoother_name(name):
    """Case-insensitive smoother lookup (the reference paramfile spells
    ``distributive_Gauss_Seidel``)."""
    key = str(name).lower()
    if key not in SMOOTHER_ALIASES:
        raise ValueError(f"Unknown smoother {name!r}; options: {sorted(SMOOTHER_ALIASES)}")
    return key


def apply_smoother(name, op, rhs, u, direction="symmetric", omega=1.0,
                   iterations=1, Dinv=None, strategy="sequential", colors=None,
                   pack=None, eig_max=None, eig_ratio=None, fronts=None):
    """Dispatch a reference smoother string.

    For ``chebyshev``, ``iterations`` is the polynomial degree.  The
    smoothing-interval lower end comes from ``eig_ratio`` (fraction of
    lmax); when it is None, a ``relaxation factor`` inside (0, 1) is
    reinterpreted as eig_ratio **with a warning** — an omega carried over
    from a damped-Jacobi config would otherwise silently narrow the
    interval and weaken the smoother.  The conventional omega=1.0 maps to
    the standard 0.3.
    """
    kind = SMOOTHER_ALIASES[normalize_smoother_name(name)]
    iterations = int(iterations)
    if kind == "cheby":
        if eig_ratio is None:
            if 0.0 < omega < 1.0:
                logging.getLogger("dgtpu_torch").warning(
                    "chebyshev: relaxation factor omega=%g is being "
                    "reinterpreted as eig_ratio (smoothing interval "
                    "[%g*lmax, lmax]); set an explicit 'eig ratio' on the "
                    "smoother node to silence this", omega, omega)
                eig_ratio = omega
            else:
                eig_ratio = 0.3
        return chebyshev(op, rhs, u, degree=iterations, eig_max=eig_max,
                         eig_ratio=eig_ratio, Dinv=Dinv)
    if kind == "jacobi":
        return block_jacobi(op, rhs, u, omega=omega, iterations=iterations, Dinv=Dinv)
    if kind in ("gs", "gs_rb"):
        return block_gauss_seidel(op, rhs, u, direction=direction, omega=omega,
                                  iterations=iterations, Dinv=Dinv,
                                  strategy="redblack" if kind == "gs_rb" else strategy,
                                  colors=colors, pack=pack, fronts=fronts)
    # distributive GS runs on the Stokes levels' own state
    # (models/stokes.make_dgs), not on one operator
    raise ValueError(f"Smoother {name!r} requires the Stokes distributive driver")
