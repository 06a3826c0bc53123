"""Postprocessing plots of the amplification analysis (port of two functions
of ``dgtpu/visualization.py``; the reference's ``dgfem/visualization.py``).

matplotlib is imported when a plot is drawn, with the Agg backend, never at
import: a machine without it still imports the package.  Each function
creates its output directory and returns the file's path.
"""

import os

import numpy as np


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _outdir(path):
    os.makedirs(path, exist_ok=True)
    return path


def plot_amplification_factor(A, theta_x, theta_y, outdir, suffix=""):
    """3D surface of |amplification| over (theta_x, theta_y)
    (visualization.py:206-236)."""
    plt = _pyplot()
    TX, TY = np.meshgrid(theta_x, theta_y, indexing="ij")
    fig = plt.figure(figsize=(7, 5))
    ax = fig.add_subplot(projection="3d")
    ax.plot_surface(TX, TY, A, cmap="viridis", linewidth=0)
    ax.set_xlabel(r"$\theta_x$")
    ax.set_ylabel(r"$\theta_y$")
    ax.set_zlabel(r"$|A|$")
    path = os.path.join(_outdir(str(outdir)), f"amplification_{suffix}.png")
    fig.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_amplification_quadrants(out, theta, outdir, name="amplification_quadrants"):
    """The 2x2 layout of the A1..A4 surfaces, the reference's deliverable of
    the analysis (relaxation.py:55-68 + visualization.py:206-236).  ``out``:
    the dict of ``calculate_amplification``; ``theta``: the 1D angle grid."""
    plt = _pyplot()
    TX, TY = np.meshgrid(theta, theta, indexing="ij")
    fig = plt.figure(figsize=(10, 8))
    for q in range(1, 5):
        ax = fig.add_subplot(2, 2, q, projection="3d")
        ax.plot_surface(TX, TY, np.asarray(out[f"A{q}"]), cmap="viridis", linewidth=0)
        ax.set_xlabel(r"$\theta_x$")
        ax.set_ylabel(r"$\theta_y$")
        ax.set_title(f"$A_{q}$")
    path = os.path.join(_outdir(str(outdir)), f"{name}.png")
    fig.savefig(path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return path
