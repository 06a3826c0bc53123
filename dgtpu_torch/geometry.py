"""Grids: Plot3D IO, batched element geometry, face topology, h-coarsening.

Port of ``dgtpu/geometry.py``.  A grid level is a *batch*: element nodal
coordinates are an ``(N, G)`` tensor in row-major element order
``m = j*Ni + i`` and the metric terms come from batched float64 products on
the tensors' device (:func:`geometry_terms`).  Coarse (h) levels sample
their metric terms from the fine grid (:func:`coarse_geometry_terms`), as
the reference's ``CoarseElement`` does (``element.py:234-356``).  Index
maps (face topology, neighbors, sub-cell splits) are static host numpy.
"""

import os
import struct

import numpy as np
import torch

from dgtpu_torch.basis import (grad_vandermonde_2d, legendre_gauss_lobatto,
                               vandermonde_2d)
from dgtpu_torch.utils.logger import Logger

SIDES = ("imin", "imax", "jmin", "jmax")
F64 = torch.float64


# --------------------------------------------------------------------------
# Plot3D unformatted-record IO (reference: grid.py:26-63)
# --------------------------------------------------------------------------

def read_plot3d(filepath):
    """Read a single-block 2D Plot3D ``.xyz`` file (Fortran records, little endian).

    Returns ``x, y`` arrays of shape ``(il, jl)``.  Performs the same record
    sanity checks as the reference reader.
    """
    with open(filepath, "rb") as f:
        raw = f.read()

    def record(off):
        n = struct.unpack("<I", raw[off:off + 4])[0]
        data = raw[off + 4:off + 4 + n]
        n2 = struct.unpack("<I", raw[off + 4 + n:off + 8 + n])[0]
        if n != n2:
            raise ValueError(f"Corrupt Fortran record at offset {off}")
        return data, off + 8 + n

    data, off = record(0)
    if len(data) != 4:
        raise ValueError(f"Size of the record nblocks is {len(data)} instead of 4")
    nblocks = struct.unpack("<i", data)[0]
    if nblocks != 1:
        raise ValueError(f"Number of blocks is {nblocks} instead of 1")

    data, off = record(off)
    if len(data) != 12:
        raise ValueError(f"Size of the record dims is {len(data)} instead of 12")
    il, jl, kl = struct.unpack("<3i", data)
    if kl != 1:
        raise ValueError("More than one point in third dimension")

    data, off = record(off)
    coords = np.frombuffer(data, dtype="<f8")
    # Fortran array layout: x then y (then z), each (il, jl) column-major
    x = coords[:il * jl].reshape(jl, il).T.copy()
    y = coords[il * jl:2 * il * jl].reshape(jl, il).T.copy()
    return x, y


def write_plot3d(filepath, x, y):
    """Write a single-block 2D Plot3D ``.xyz`` in the format :func:`read_plot3d` reads."""
    il, jl = x.shape
    z = np.zeros_like(x)

    def rec(payload):
        return struct.pack("<I", len(payload)) + payload + struct.pack("<I", len(payload))

    body = rec(struct.pack("<i", 1))
    body += rec(struct.pack("<3i", il, jl, 1))
    coords = np.concatenate([
        np.asarray(a, dtype="<f8").T.ravel() for a in (x, y, z)])
    body += rec(coords.tobytes())
    with open(filepath, "wb") as f:
        f.write(body)


def generate_rectangle_grid(n_elem_i, n_elem_j, p_grid, extent=(-1.0, 1.0, -1.0, 1.0)):
    """Uniform rectangle grid with per-element LGL(p_grid) node spacing.

    Reproduces the layout of the shipped ``Rectangle_{N}X{N}_nPoly{P}.xyz``
    inputs: elements uniform on the extent, geometry nodes at mapped LGL
    points so neighboring elements share their boundary node.
    """
    xi = legendre_gauss_lobatto(p_grid + 1)  # [-1, 1]

    def axis(n_elem, lo, hi):
        h = (hi - lo) / n_elem
        pts = [lo + h * (k + (x + 1) / 2) for k in range(n_elem) for x in xi[:-1]]
        pts.append(hi)
        return np.array(pts)

    x1 = axis(n_elem_i, extent[0], extent[1])
    y1 = axis(n_elem_j, extent[2], extent[3])
    X, Y = np.meshgrid(x1, y1, indexing="ij")
    return X, Y


class Geometry:
    """Grid file reader + element-count bookkeeping (reference Geometry, grid.py:14-63)."""

    def __init__(self, filepath, settings):
        self.settings = settings
        self.logger = Logger(__name__, settings).logger
        self.filepath = filepath
        self.P_grid = settings.grid.polynomial_degree
        self.N_grid = self.P_grid + 1
        self.N_DOF_grid = self.N_grid ** 2
        self.O_grid = settings.grid.O_grid
        self.fully_periodic_boundaries = settings.grid.fully_periodic_boundaries
        self.read()

    def read(self):
        self.logger.debug(f"Reading grid from {self.filepath}")
        if "circle" in os.path.basename(self.filepath).lower() and not self.O_grid:
            self.logger.warning(
                "It seems that you are reading a circular grid without the O-grid condition")
        self.x, self.y = read_plot3d(self.filepath)
        il, jl = self.x.shape
        if self.O_grid:
            if (not np.all(abs(self.x[0, :] - self.x[-1, :]) < 1e-15)
                    or not np.all(abs(self.y[0, :] - self.y[-1, :]) < 1e-15)):
                raise ValueError("O-grid is not closed")
        self.Ni = (il - 1) // self.P_grid
        self.Nj = (jl - 1) // self.P_grid
        self.N = self.Ni * self.Nj
        self.logger.debug(f"Total number of elements in the domain: {self.Ni}x{self.Nj}")


# --------------------------------------------------------------------------
# Batched element extraction and metric terms
# --------------------------------------------------------------------------

def element_coords(x, y, Ni, Nj, p_grid):
    """Per-element nodal coordinates ``X, Y`` of shape ``(N, (p_grid+1)**2)``.

    Element order ``m = j*Ni + i``; intra-element order F-raveled (i-node
    fastest), matching the reference's ``np.ravel(x_el, order='F')``.
    Host numpy.
    """
    G1 = p_grid + 1
    N = Ni * Nj
    X = np.zeros((N, G1 * G1))
    Y = np.zeros_like(X)
    for m in range(N):
        i, j = m % Ni, m // Ni
        sl = np.ix_(np.arange(i * p_grid, i * p_grid + G1),
                    np.arange(j * p_grid, j * p_grid + G1))
        X[m] = np.ravel(x[sl], order="F")
        Y[m] = np.ravel(y[sl], order="F")
    return X, Y


def _t(a, device):
    return torch.as_tensor(np.asarray(a), dtype=F64, device=device)


def _interp_ops(quad, V, Vr, Vs, device):
    """Nodal interpolation operators over the geometry basis (element.py:76-130):
    x(pts) = (V(pts) @ V_gg^-1) @ x_nodal, likewise for d/dr, d/ds."""
    inv = quad.V_grid_grid_inv
    return tuple(_t(M @ inv, device) for M in (V, Vr, Vs))


def _metric_from_derivs(xr, xs, yr, ys, face=None):
    """J, rx, sx, ry, sy (and face J / unit normal) from coordinate derivatives.

    Matches element.py:93-102.  Face normals use the *raw* contravariant
    direction (+grad r for i-faces, +grad s for j-faces).
    """
    J = xr * ys - yr * xs
    rx, sx = ys / J, -yr / J
    ry, sy = -xs / J, xr / J
    out = {"J": J, "rx": rx, "sx": sx, "ry": ry, "sy": sy}
    if face in ("imin", "imax"):
        out["Jf"] = torch.sqrt(xs ** 2 + ys ** 2)
        nrm = torch.sqrt(rx ** 2 + ry ** 2)
        out["nx"], out["ny"] = rx / nrm, ry / nrm
    elif face in ("jmin", "jmax"):
        out["Jf"] = torch.sqrt(xr ** 2 + yr ** 2)
        nrm = torch.sqrt(sx ** 2 + sy ** 2)
        out["nx"], out["ny"] = sx / nrm, sy / nrm
    return out


def geometry_terms(X, Y, quad, device=None):
    """Batched metric terms for all elements at all quadrature locations.

    ``X, Y``: (N, G) element nodal coordinates; the float64 terms land on
    ``device``::

        gt[var]['e']    : J, rx, sx, ry, sy, x, y           each (N, nq*nq)
        gt[var][side]   : J, Jf, rx, ..., nx, ny, x, y      each (N, nq)
        gt['A']         : element areas (N,)
    """
    dev = device
    X, Y = _t(X, dev), _t(Y, dev)
    gt = {}
    for v in quad.vars:
        L, Dr, Ds = _interp_ops(quad, quad.V_grid_int[v], quad.Vr_grid_int[v],
                                quad.Vs_grid_int[v], dev)
        vol = _metric_from_derivs(X @ Dr.T, X @ Ds.T, Y @ Dr.T, Y @ Ds.T)
        vol["x"], vol["y"] = X @ L.T, Y @ L.T
        entry = {"e": vol}
        for side in SIDES:
            Lf, Drf, Dsf = _interp_ops(quad, quad.V_grid_face[side][v],
                                       quad.Vr_grid_face[side][v],
                                       quad.Vs_grid_face[side][v], dev)
            f = _metric_from_derivs(X @ Drf.T, X @ Dsf.T, Y @ Drf.T, Y @ Dsf.T,
                                    face=side)
            f["x"], f["y"] = X @ Lf.T, Y @ Lf.T
            entry[side] = f
        gt[v] = entry
    gt["A"] = gt["u"]["e"]["J"] @ _t(quad.w_int_2d["u"], dev)
    return gt


# --------------------------------------------------------------------------
# Face topology (static host arrays)
# --------------------------------------------------------------------------

class FaceTopology:
    """Index maps between faces and elements for one direction.

    For direction 'i' (faces normal to i): periodic (O-grid) grids have
    ``Ni`` faces per row with wraparound; otherwise ``Ni+1`` with one-sided
    ends.  j-direction faces are never matrix-periodic (the reference treats
    fully-periodic j boundaries as one-sided faces with zero cross blocks —
    see discrete_system.py:105-125 and grid.py:168-176).
    """

    def __init__(self, Ni, Nj, direction, periodic):
        self.direction = direction
        self.periodic = periodic
        m = lambda i, j: j * Ni + i
        eL, eR, has_L, has_R = [], [], [], []
        f_min = np.zeros(Ni * Nj, dtype=np.int64)
        f_max = np.zeros(Ni * Nj, dtype=np.int64)
        if direction == "i":
            nf_per_row = Ni if periodic else Ni + 1
            for j in range(Nj):
                for fi in range(nf_per_row):
                    if periodic:
                        eL.append(m((fi - 1) % Ni, j)); has_L.append(True)
                        eR.append(m(fi, j)); has_R.append(True)
                    else:
                        eL.append(m(max(fi - 1, 0), j)); has_L.append(fi > 0)
                        eR.append(m(min(fi, Ni - 1), j)); has_R.append(fi < Ni)
            for j in range(Nj):
                for i in range(Ni):
                    base = j * nf_per_row
                    f_min[m(i, j)] = base + i
                    f_max[m(i, j)] = base + ((i + 1) % Ni if periodic else i + 1)
        else:
            nf_per_col = Nj if periodic else Nj + 1
            for fj in range(nf_per_col):
                for i in range(Ni):
                    if periodic:
                        eL.append(m(i, (fj - 1) % Nj)); has_L.append(True)
                        eR.append(m(i, fj)); has_R.append(True)
                    else:
                        eL.append(m(i, max(fj - 1, 0))); has_L.append(fj > 0)
                        eR.append(m(i, min(fj, Nj - 1))); has_R.append(fj < Nj)
            for j in range(Nj):
                for i in range(Ni):
                    f_min[m(i, j)] = j * Ni + i
                    f_max[m(i, j)] = ((j + 1) % Nj if periodic else j + 1) * Ni + i
        self.eL = np.array(eL, dtype=np.int64)
        self.eR = np.array(eR, dtype=np.int64)
        self.has_L = np.array(has_L)
        self.has_R = np.array(has_R)
        self.f_min = f_min  # face index on the 'min' side of each element
        self.f_max = f_max
        self.n_faces = len(self.eL)
        # side-table keys on each element the face trace reads from
        self.side_L = "imax" if direction == "i" else "jmax"
        self.side_R = "imin" if direction == "i" else "jmin"
        # interior/boundary weights for the unified SIP kernels
        both = self.has_L & self.has_R
        self.w_L = np.where(both, 0.5, np.where(self.has_L, 1.0, 0.0))
        self.w_R = np.where(both, 0.5, np.where(self.has_R, 1.0, 0.0))
        self.p_L = self.has_L.astype(np.float64)
        self.p_R = self.has_R.astype(np.float64)


def neighbor_map(Ni, Nj, periodic_i, periodic_j=False):
    """Stencil neighbor indices ``nbr[N, 5] = [self, iL, iR, jL, jR]`` + mask."""
    N = Ni * Nj
    m = lambda i, j: j * Ni + i
    nbr = np.zeros((N, 5), dtype=np.int64)
    mask = np.zeros((N, 5), dtype=bool)
    for j in range(Nj):
        for i in range(Ni):
            e = m(i, j)
            nbr[e, 0], mask[e, 0] = e, True
            if i > 0 or periodic_i:
                nbr[e, 1], mask[e, 1] = m((i - 1) % Ni, j), True
            if i < Ni - 1 or periodic_i:
                nbr[e, 2], mask[e, 2] = m((i + 1) % Ni, j), True
            if j > 0 or periodic_j:
                nbr[e, 3], mask[e, 3] = m(i, (j - 1) % Nj), True
            if j < Nj - 1 or periodic_j:
                nbr[e, 4], mask[e, 4] = m(i, (j + 1) % Nj), True
    return nbr, mask


# --------------------------------------------------------------------------
# h-coarsening: sample coarse-level metric terms from the fine grid
# --------------------------------------------------------------------------

def _subcell_split(points, cf):
    """Map coarse reference coords to (fine sub-cell index, local coord).

    Inverse of the affine sub-cell map r = (2R + 2 - dR*(1 + 2m))/dR with
    dR = 2/cf (element.py:282-287).  Static host math.
    """
    dR = 2.0 / cf
    points = np.atleast_1d(np.asarray(points, dtype=np.float64))
    m = np.clip(np.floor((points + 1.0) / dR).astype(int), 0, cf - 1)
    r_loc = (2.0 * points + 2.0 - dR * (1.0 + 2.0 * m)) / dR
    return m, r_loc


def coarse_geometry_terms(X_fine, Y_fine, quad, Ni_f, Nj_f, cf, device=None):
    """Metric terms of the cf x cf agglomerated grid, sampled from fine elements.

    ``X_fine``: (N_f, G) fine element nodal coords in fine m-order; the
    float64 terms land on ``device``.  Returns the same ``gt`` tree as :func:`geometry_terms` for the
    coarse elements (coarse m-order), with the reference's coarsening-factor
    derivative scaling (element.py:81-85).
    """
    Ni_c, Nj_c = Ni_f // cf, Nj_f // cf
    if Ni_c * cf != Ni_f or Nj_c * cf != Nj_f:
        raise ValueError(
            f"The number of original elements ({Ni_f},{Nj_f}) cannot be divided by a factor {cf}")
    N_c = Ni_c * Nj_c
    dev = device
    X_fine, Y_fine = _t(X_fine, dev), _t(Y_fine, dev)

    # fine element index per coarse element and sub-cell: (N_c, cf, cf)
    sub_idx = np.zeros((N_c, cf, cf), dtype=np.int64)
    for J in range(Nj_c):
        for I in range(Ni_c):
            mc = J * Ni_c + I
            for n in range(cf):
                for m in range(cf):
                    sub_idx[mc, m, n] = (J * cf + n) * Ni_f + (I * cf + m)

    inv = quad.V_grid_grid_inv
    gt = {}

    def sampled(r_pts, s_pts, face):
        """Coarse-level terms at tensor points (r_pts x s_pts), grouped by
        containing sub-cell and scattered into the (p + q*len(r)) layout."""
        m_of, r_loc = _subcell_split(r_pts, cf)
        n_of, s_loc = _subcell_split(s_pts, cf)
        npts = len(r_loc) * len(s_loc)
        res = {k: torch.zeros((N_c, npts), dtype=F64, device=dev)
               for k in ("xr", "xs", "yr", "ys", "x", "y")}
        for m in sorted(set(m_of.tolist())):
            for n in sorted(set(n_of.tolist())):
                pi = np.nonzero(m_of == m)[0]
                qi = np.nonzero(n_of == n)[0]
                if len(pi) == 0 or len(qi) == 0:
                    continue
                rr, ss = r_loc[pi], s_loc[qi]
                V = _t(vandermonde_2d(quad.n_grid, rr, ss) @ inv, dev)
                Vr, Vs = grad_vandermonde_2d(quad.n_grid, rr, ss)
                Dr, Ds = _t(Vr @ inv, dev), _t(Vs @ inv, dev)
                idx = torch.as_tensor(sub_idx[:, m, n], device=dev)
                Xe, Ye = X_fine[idx], Y_fine[idx]
                vals = {"x": Xe @ V.T, "y": Ye @ V.T,
                        "xr": cf * (Xe @ Dr.T), "xs": cf * (Xe @ Ds.T),
                        "yr": cf * (Ye @ Dr.T), "ys": cf * (Ye @ Ds.T)}
                # local tensor index (a over pi, b over qi) -> p + q*len(r)
                cols = torch.as_tensor(
                    (pi[None, :] + qi[:, None] * len(r_loc)).T.ravel(), device=dev)
                for k in res:
                    res[k][:, cols] = (vals[k].reshape(N_c, len(qi), len(pi))
                                       .transpose(1, 2).reshape(N_c, -1))
        out = _metric_from_derivs(res["xr"], res["xs"], res["yr"], res["ys"], face=face)
        out["x"], out["y"] = res["x"], res["y"]
        return out

    for v in quad.vars:
        r_int = quad.r_int[v]
        gt[v] = {"e": sampled(r_int, r_int, None),
                 "imin": sampled(np.array([-1.0]), r_int, "imin"),
                 "imax": sampled(np.array([1.0]), r_int, "imax"),
                 "jmin": sampled(r_int, np.array([-1.0]), "jmin"),
                 "jmax": sampled(r_int, np.array([1.0]), "jmax")}
    gt["A"] = gt["u"]["e"]["J"] @ _t(quad.w_int_2d["u"], dev)
    return gt


def coarse_element_coords(X_fine, Y_fine, Ni_f, Nj_f, p_grid, cf):
    """Coarse element nodal coords: every cf-th fine node (grid.py:282-286).
    Host numpy, same index arithmetic as dgtpu."""
    G1 = p_grid + 1
    Ni_c, Nj_c = Ni_f // cf, Nj_f // cf
    N_c = Ni_c * Nj_c
    Xc = np.zeros((N_c, G1 * G1))
    Yc = np.zeros_like(Xc)
    X_fine = np.asarray(X_fine)
    Y_fine = np.asarray(Y_fine)
    for J in range(Nj_c):
        for I in range(Ni_c):
            mc = J * Ni_c + I
            for b in range(G1):
                for a in range(G1):
                    gi = a * cf
                    gj = b * cf
                    fi = min(gi // p_grid, cf - 1)
                    fj = min(gj // p_grid, cf - 1)
                    li = gi - fi * p_grid
                    lj = gj - fj * p_grid
                    mf = (J * cf + fj) * Ni_f + (I * cf + fi)
                    Xc[mc, a + b * G1] = X_fine[mf, li + lj * G1]
                    Yc[mc, a + b * G1] = Y_fine[mf, li + lj * G1]
    return Xc, Yc
