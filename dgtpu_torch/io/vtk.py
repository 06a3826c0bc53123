"""Minimal VTK XML StructuredGrid (.vts) writer — replaces the pyevtk dependency.

Writes appended raw binary (little-endian) .vts files that ParaView reads;
covers the reference's ``grid_to_vtk`` and ``elements_to_vtk`` surfaces
(visualization.py:52-117).
"""

import struct

import numpy as np


def _da(name, arr, n_comp):
    return (f'<DataArray type="Float64" Name="{name}" '
            f'NumberOfComponents="{n_comp}" format="appended" offset="OFFSET"/>')


def write_vts(path, x, y, point_data=None):
    """Write a 2D structured grid (nx, ny) with optional nodal scalar fields."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    nx, ny = x.shape
    point_data = point_data or {}

    blocks = []

    def add_block(arr):
        raw = arr.astype("<f8").tobytes()
        blocks.append(struct.pack("<Q", len(raw)) + raw)

    pts = np.zeros((nx * ny, 3))
    # VTK expects x varying fastest; our arrays are (i, j) so transpose
    pts[:, 0] = x.T.ravel()
    pts[:, 1] = y.T.ravel()
    add_block(pts)
    fields_xml = []
    for name, arr in point_data.items():
        arr = np.asarray(arr, dtype=np.float64)
        add_block(arr.T.ravel())
        fields_xml.append((name, 1))

    offsets = []
    off = 0
    for b in blocks:
        offsets.append(off)
        off += len(b)

    xml = ['<?xml version="1.0"?>',
           '<VTKFile type="StructuredGrid" version="1.0" byte_order="LittleEndian" '
           'header_type="UInt64">',
           f'<StructuredGrid WholeExtent="0 {nx-1} 0 {ny-1} 0 0">',
           f'<Piece Extent="0 {nx-1} 0 {ny-1} 0 0">',
           '<Points>',
           f'<DataArray type="Float64" Name="Points" NumberOfComponents="3" '
           f'format="appended" offset="{offsets[0]}"/>',
           '</Points>',
           '<PointData>']
    for k, (name, _) in enumerate(fields_xml):
        xml.append(f'<DataArray type="Float64" Name="{name}" NumberOfComponents="1" '
                   f'format="appended" offset="{offsets[k+1]}"/>')
    xml += ['</PointData>', '</Piece>', '</StructuredGrid>',
            '<AppendedData encoding="raw">', '_']
    header = "\n".join(xml).encode()
    footer = b"\n</AppendedData>\n</VTKFile>\n"
    with open(path, "wb") as f:
        f.write(header)
        for b in blocks:
            f.write(b)
        f.write(footer)
    return path


def grid_to_vtk(basepath, x, y):
    """Reference grid export (visualization.py:52-64)."""
    return write_vts(basepath + ".vts", x, y)


def elements_to_vtk(basepath, x, y, point_data=None):
    """Solution export on the global node lattice.

    The reference writes one sub-lattice per element; for a conforming nodal
    lattice a single structured grid is equivalent and lighter.
    ``point_data`` values are (nx, ny) nodal arrays.
    """
    return write_vts(basepath + ".vts", x, y, point_data)


def nodal_lattice(level, per_element):
    """Per-element nodal values ``(N, (P_grid+1)^2)`` (column-major mode
    order, element.py's ``order='F'`` ravel) -> the global ``(il, jl)``
    node lattice, shared edge nodes overwritten like the reference's
    per-element lattice fill (visualization.py:66-117)."""
    il = level.Ni * level.P_grid + 1
    jl = level.Nj * level.P_grid + 1
    G1 = level.P_grid + 1
    out = np.zeros((il, jl))
    a = np.asarray(per_element)
    for m in range(level.N):
        i, j = m % level.Ni, m // level.Ni
        out[i * level.P_grid:i * level.P_grid + G1,
            j * level.P_grid:j * level.P_grid + G1] = \
            a[m].reshape(G1, G1, order="F")
    return out


def modal_to_vtk(basepath, level, u_modal, x, y, var="u", name="phi"):
    """Interpolate a modal DOF vector to the element node lattice and
    export it as ``.vts`` (reference visualization.py:119-128).

    ``u_modal`` is the local-ordering modal vector (or its per-element
    reshape); only the ``var`` component block of each element is used,
    so Poisson vectors pass through whole and Stokes local-order vectors
    export their u block by default.
    """
    u_el = np.asarray(u_modal).reshape(level.N, -1)
    nd = level.N_DOF_sol[var]
    eb = (getattr(level, "element_basis", None) or {}).get(var)
    if eb is not None:
        Vg = np.asarray(eb.apply(level.quad.V_sol_grid[var]))   # (N, G, B)
        nodal = np.einsum("ngb,nb->ng", Vg, u_el[:, :nd])
    else:
        Vg = np.asarray(level.quad.V_sol_grid[var])
        nodal = u_el[:, :nd] @ Vg.T
    return write_vts(basepath + ".vts", x, y,
                     {name: nodal_lattice(level, nodal)})
