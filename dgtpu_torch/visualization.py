"""Postprocessing plots (port of ``dgtpu/visualization.py``; the reference's
``dgfem/visualization.py``): the sparsity pattern, the amplification
surfaces, grid convergence with slope triangles, residual histories, the
standard element, the 1D and 2D bases, Lebesgue functions and constants,
the Runge demo and the spectral radius of the smoother.

matplotlib is imported when a plot is drawn, with the Agg backend, never at
import: where matplotlib is missing a plot function returns None, as dgtpu's
do without ``HAVE_MPL`` (``plot_spectral_radius`` imports it outright, as
dgtpu's does).  Each function creates its output directory and returns the
file's path.
"""

import os

import numpy as np

from dgtpu_torch.basis import (lagrange_basis, lebesgue_function,
                               legendre_gauss_lobatto, legendre_orthonormal)


def _pyplot():
    """pyplot on the Agg backend, or None where matplotlib is missing."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _outdir(path):
    os.makedirs(path, exist_ok=True)
    return path


def _save(plt, fig, outdir, filename, **kw):
    path = os.path.join(_outdir(str(outdir)), filename)
    fig.savefig(path, bbox_inches="tight", **kw)
    plt.close(fig)
    return path


def plot_sparsity_pattern(op, outdir="postprocessing/plots", name="sparsity"):
    """Spy plot of the assembled operator (visualization.py:195-204)."""
    plt = _pyplot()
    if plt is None:
        return None
    from dgtpu_torch.ops.stencil import as_dense_operator
    A = as_dense_operator(op).A.cpu().numpy()
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.spy(A, markersize=0.5, precision=1e-14)
    ax.set_title(f"nnz = {(np.abs(A) > 1e-14).sum()}")
    return _save(plt, fig, outdir, f"{name}.png", dpi=150)


def plot_amplification_factor(A, theta_x, theta_y, outdir, suffix=""):
    """3D surface of |amplification| over (theta_x, theta_y)
    (visualization.py:206-236)."""
    plt = _pyplot()
    if plt is None:
        return None
    TX, TY = np.meshgrid(theta_x, theta_y, indexing="ij")
    fig = plt.figure(figsize=(7, 5))
    ax = fig.add_subplot(projection="3d")
    ax.plot_surface(TX, TY, A, cmap="viridis", linewidth=0)
    ax.set_xlabel(r"$\theta_x$")
    ax.set_ylabel(r"$\theta_y$")
    ax.set_zlabel(r"$|A|$")
    return _save(plt, fig, outdir, f"amplification_{suffix}.png", dpi=150)


def draw_loglog_slope(ax, origin, width, slope, inverted=False, color="k"):
    """Slope triangle on a log-log plot (visualization.py:797-893)."""
    x0, y0 = origin
    x1 = x0 * width
    y1 = y0 * (width ** slope)
    if inverted:
        xs = [x0, x1, x0, x0]
        ys = [y0, y1, y1, y0]
    else:
        xs = [x0, x1, x1, x0]
        ys = [y0, y0, y1, y0]
    ax.plot(xs, ys, color=color, lw=0.8)
    ax.annotate(f"{slope:g}", xy=(x1, np.sqrt(y0 * y1)), fontsize=8)


def plot_grid_convergence(results, outdir="postprocessing/plots",
                          name="grid_convergence"):
    """L2 error against element count with p+1 slope triangles
    (visualization.py:403-584).  ``results``: {p: [(N, L2_error), ...]}."""
    plt = _pyplot()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(6, 4.5))
    for p, pts in sorted(results.items()):
        pts = sorted(pts)
        Ns = [n for n, _ in pts]
        errs = [e for _, e in pts]
        ax.loglog(Ns, errs, "o-", label=f"$P={p}$")
        if len(Ns) >= 2:
            draw_loglog_slope(ax, (Ns[-1], errs[-1] * 1.5), 1.6, -(p + 1))
    ax.set_xlabel("N (elements per direction)")
    ax.set_ylabel(r"$L_2$ error")
    ax.legend()
    ax.grid(True, which="both", alpha=0.3)
    return _save(plt, fig, outdir, f"{name}.png", dpi=150)


def plot_residual_history(histories, outdir="postprocessing/plots",
                          name="residuals", labels=None):
    """Residual against iteration (visualization.py:722-793).
    ``histories``: 1D arrays of normalized residuals."""
    plt = _pyplot()
    if plt is None:
        return None
    fig, ax = plt.subplots(figsize=(6, 4.5))
    for i, h in enumerate(histories):
        h = np.asarray(h)
        label = labels[i] if labels else f"run {i}"
        ax.semilogy(np.arange(len(h)), h, label=label)
    ax.set_xlabel("iteration")
    ax.set_ylabel("normalized residual")
    ax.legend()
    ax.grid(True, which="both", alpha=0.3)
    return _save(plt, fig, outdir, f"{name}.png", dpi=150)


def plot_standard_element(p_grid, outdir="postprocessing/plots"):
    """Reference element with its LGL nodes (visualization.py:174-193)."""
    plt = _pyplot()
    if plt is None:
        return None
    xi = legendre_gauss_lobatto(p_grid + 1)
    X, Y = np.meshgrid(xi, xi, indexing="ij")
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.plot(X.ravel(), Y.ravel(), "ko", ms=4)
    for v in xi:
        ax.axvline(v, color="0.8", lw=0.5)
        ax.axhline(v, color="0.8", lw=0.5)
    ax.set_xlim(-1.05, 1.05)
    ax.set_ylim(-1.05, 1.05)
    ax.set_aspect("equal")
    return _save(plt, fig, outdir, f"standard_element_p{p_grid}.png", dpi=150)


def plot_lebesgue(p, outdir="postprocessing/plots"):
    """Lebesgue functions of LGL and equidistant nodes
    (visualization.py:238-401)."""
    plt = _pyplot()
    if plt is None:
        return None
    x = np.linspace(-1, 1, 1000)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(x, lebesgue_function(legendre_gauss_lobatto(p + 1), x),
            label=f"LGL nodes (p={p})")
    ax.plot(x, lebesgue_function(np.linspace(-1, 1, p + 1), x), "--",
            label="equidistant nodes")
    ax.set_ylabel("Lebesgue function")
    ax.legend()
    ax.grid(alpha=0.3)
    return _save(plt, fig, outdir, f"lebesgue_p{p}.png", dpi=150)


def plot_runge(p, outdir="postprocessing/plots"):
    """Runge demo: 1/(1+25x^2) interpolated on LGL and equidistant nodes."""
    plt = _pyplot()
    if plt is None:
        return None

    def f(x):
        return 1.0 / (1 + 25 * x ** 2)

    x = np.linspace(-1, 1, 600)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(x, f(x), "k", lw=1, label="1/(1+25x²)")
    for nodes, label, style in ((legendre_gauss_lobatto(p + 1), "LGL", "-"),
                                (np.linspace(-1, 1, p + 1), "equidistant", "--")):
        ax.plot(x, lagrange_basis(x, nodes) @ f(nodes), style,
                label=f"{label} interp (p={p})")
    ax.legend()
    ax.grid(alpha=0.3)
    return _save(plt, fig, outdir, f"runge_p{p}.png", dpi=150)


def plot_basis_1d(p, outdir="postprocessing/plots"):
    """Orthonormal Legendre basis functions (visualization.py:238-401)."""
    plt = _pyplot()
    if plt is None:
        return None
    x = np.linspace(-1, 1, 400)
    fig, ax = plt.subplots(figsize=(6, 4))
    for k in range(p + 1):
        ax.plot(x, legendre_orthonormal(x, k), label=f"$\\tilde P_{k}$")
    ax.legend(ncol=2, fontsize=8)
    ax.grid(alpha=0.3)
    return _save(plt, fig, outdir, f"legendre_basis_p{p}.png", dpi=150)


def plot_basis_nodal_1d(p, outdir="postprocessing/plots"):
    """Lagrange (nodal) basis on LGL nodes (visualization.py:238-263)."""
    plt = _pyplot()
    if plt is None:
        return None
    nodes = legendre_gauss_lobatto(p + 1)
    x = np.linspace(-1, 1, 400)
    L = lagrange_basis(x, nodes)                 # (len(x), p+1)
    fig, ax = plt.subplots(figsize=(6, 4))
    for k in range(p + 1):
        ax.plot(x, L[:, k], label=f"$\\ell_{k}$")
    ax.plot(nodes, np.zeros_like(nodes), "ko", ms=3)
    ax.set_xlabel("$x$")
    ax.set_ylabel(r"$\ell(x)$")
    ax.legend(ncol=2, fontsize=8)
    ax.grid(alpha=0.3)
    return _save(plt, fig, outdir, f"nodal_basis_p{p}.png", dpi=150)


def plot_basis_2d(p, outdir="postprocessing/plots"):
    """2D tensor-product modal basis surfaces, one panel per mode, in the
    column-major mode order n = j*(p+1) + i of the modal solution vectors
    (interpolation.py:133-140)."""
    plt = _pyplot()
    if plt is None:
        return None
    N = p + 1
    x = np.linspace(-1, 1, 60)
    X, Y = np.meshgrid(x, x, indexing="ij")
    fig = plt.figure(figsize=(2.4 * N, 2.2 * N))
    for j in range(N):
        for i in range(N):
            n = j * N + i
            ax = fig.add_subplot(N, N, n + 1, projection="3d")
            Z = (legendre_orthonormal(X.ravel(), i)
                 * legendre_orthonormal(Y.ravel(), j)).reshape(X.shape)
            ax.plot_surface(X, Y, Z, cmap="viridis", linewidth=0,
                            rstride=2, cstride=2, antialiased=False)
            ax.set_title(f"$\\psi_{{{n}}}$", fontsize=8, pad=0)
            ax.set_axis_off()
    return _save(plt, fig, outdir, f"modal_basis_2d_p{p}.png", dpi=110)


def plot_lebesgue_constant(p_max, outdir="postprocessing/plots"):
    """Lebesgue constant against degree, equidistant and LGL nodes
    (visualization.py:293-307, 387-401)."""
    plt = _pyplot()
    if plt is None:
        return None
    x = np.linspace(-1, 1, 1001)
    ps = np.arange(1, p_max + 1)
    lam_equi = [lebesgue_function(np.linspace(-1, 1, p + 1), x).max() for p in ps]
    lam_lgl = [lebesgue_function(legendre_gauss_lobatto(p + 1), x).max() for p in ps]
    fig, ax = plt.subplots(figsize=(5, 4))
    ax.semilogy(ps, lam_equi, "o--", label="equidistant")
    ax.semilogy(ps, lam_lgl, "s-", label="LGL")
    ax.set_xlabel("$p$")
    ax.set_ylabel(r"$\Lambda_p$")
    ax.legend()
    ax.grid(alpha=0.3)
    return _save(plt, fig, outdir, f"lebesgue_constant_p{p_max}.png", dpi=150)


def plot_amplification_quadrants(out, theta, outdir, name="amplification_quadrants"):
    """The 2x2 layout of the A1..A4 surfaces, the reference's deliverable of
    the analysis (relaxation.py:55-68 + visualization.py:206-236).  ``out``:
    the dict of ``calculate_amplification``; ``theta``: the 1D angle grid."""
    plt = _pyplot()
    if plt is None:
        return None
    TX, TY = np.meshgrid(theta, theta, indexing="ij")
    fig = plt.figure(figsize=(10, 8))
    for q in range(1, 5):
        ax = fig.add_subplot(2, 2, q, projection="3d")
        ax.plot_surface(TX, TY, np.asarray(out[f"A{q}"]), cmap="viridis", linewidth=0)
        ax.set_xlabel(r"$\theta_x$")
        ax.set_ylabel(r"$\theta_y$")
        ax.set_title(f"$A_{q}$")
    return _save(plt, fig, outdir, f"{name}.png", dpi=130)


def plot_spectral_radius(results, outdir="postprocessing/plots",
                         name="spectral_radius_Poisson"):
    """rho(B) of the smoother's iteration matrix against grid size, per
    degree (the reference's figure, visualization.py:586-720): a rho=1
    stability line and one marked curve per degree.  ``results``:
    {p: [(n, rho), ...]}."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(dpi=150)
    grids = sorted({n for pts in results.values() for n, _ in pts})
    ax.semilogy(grids, np.ones(len(grids)), "-k", label=r"$\rho(B)=1$")
    markers = ["o", "s", "^", "D", "v", "*"]
    for i, (p, pts) in enumerate(sorted(results.items())):
        ns = [n for n, _ in sorted(pts)]
        rhos = [r for _, r in sorted(pts)]
        ax.semilogy(ns, rhos, "--k", marker=markers[i % len(markers)], label=f"p={p}")
    ax.set_xticks(grids)
    ax.set_xticklabels([f"{n}X{n}" for n in grids])
    ax.set_xlabel("grid")
    ax.set_ylabel(r"$\rho(B)$")
    ax.legend()
    return _save(plt, fig, outdir, f"{name}.svg")
