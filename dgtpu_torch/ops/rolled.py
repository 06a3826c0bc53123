"""Roll-layout stencil operations (port of ``dgtpu/ops/rolled.py``).

On the structured element grid a stencil operator rolls to a gather-free
layout::

    blocks : (Nj, Ni, 5, B, B)    vectors : (Nj, Ni, B)

where the i-neighbors are circular rolls along axis 1 and the j-neighbors
shifts along axis 0 with zero halos (at physical boundaries the
corresponding blocks are zero, so the rolls are harmless on Dirichlet
topologies and exact for the O-grid wrap).  These plain functions on
tensors of any dtype are what the rolled cycle's kernels
(``ops/vcycle.py``) are held to.

For even Ni the checkerboard colors pack into two (Nj, Ni/2, ...) lattices:
color 0 sits at i = 2*ip + (j % 2), color 1 at i = 2*ip + 1 - (j % 2).  The
SoA cycle (``ops/soa.py``) keeps each color lattice with its cells in the
contiguous axis.  The float-mask blends below select exactly (a factor of 0
or 1), as in dgtpu.
"""

import numpy as np
import torch


def bmv(blocks, u):
    """Batched block matvec (..., a, b) x (..., b) -> (..., a).  ``u`` may
    also be a single vector (b,) broadcast against every block."""
    if u.ndim == 1:
        return torch.matmul(blocks, u)
    return torch.matmul(blocks, u.unsqueeze(-1)).squeeze(-1)


def to_rolled(op, Ni, Nj):
    """StencilOperator blocks -> (Nj, Ni, 5, B, B)."""
    n, s, br, bc = op.blocks.shape
    assert n == Ni * Nj and s == 5
    return op.blocks.reshape(Nj, Ni, 5, br, bc)


def vec_to_rolled(v, Ni, Nj, B):
    return v.reshape(Nj, Ni, B)


def _shift_j(u, up):
    """Neighbor fields in the j direction with zero halos."""
    if u.shape[0] == 1:
        # a single row's j-neighbors are both zero halos
        return torch.zeros_like(u)
    zero = torch.zeros_like(u[:1])
    if up:
        return torch.cat([zero, u[:-1]], dim=0)            # j-1 neighbor values
    return torch.cat([u[1:], zero], dim=0)                 # j+1


def neighbor_fields(u):
    """(u_iL, u_iR, u_jL, u_jR) for a (Nj, Ni, B) field."""
    return (torch.roll(u, 1, dims=1), torch.roll(u, -1, dims=1),
            _shift_j(u, True), _shift_j(u, False))


def _slot_sum(blocks, fields, first_slot):
    """sum_s blocks[:, :, first_slot + s] fields[s], accumulated in slot
    order as dgtpu does."""
    out = bmv(blocks[:, :, first_slot], fields[0])
    for s, f in enumerate(fields[1:], start=first_slot + 1):
        out = out + bmv(blocks[:, :, s], f)
    return out


def matvec(blocks, u):
    return _slot_sum(blocks, (u, *neighbor_fields(u)), 0)


def offdiag_matvec(blocks, u):
    return _slot_sum(blocks, neighbor_fields(u), 1)


def checkerboard(Nj, Ni, dtype=torch.int32, device=None):
    j = torch.arange(Nj, device=device)[:, None]
    i = torch.arange(Ni, device=device)[None, :]
    return ((i + j) % 2).to(dtype)


def color_masks(Nj, Ni, dtype, device=None):
    """Float checkerboard masks (2, Nj, Ni, 1)."""
    cb = checkerboard(Nj, Ni, device=device)
    return torch.stack([cb == 0, cb == 1]).to(dtype)[:, :, :, None]


def rb_half_sweep_masked(blocks, Dinv, rhs, u, mask):
    """One color of the masked red-black sweep: the cells where ``mask`` is 1
    take ``Dinv (rhs - offdiag(u))`` computed from the pre-update ``u``."""
    unew = bmv(Dinv, rhs - offdiag_matvec(blocks, u))
    return mask * unew + (1.0 - mask) * u


def rb_gs_sweeps_masked(blocks, Dinv, rhs, u, masks, n_color_passes):
    """``n_color_passes`` red-black sweeps (two half-sweeps each) with
    precomputed float masks."""
    for _ in range(n_color_passes):
        for c in (0, 1):
            u = rb_half_sweep_masked(blocks, Dinv, rhs, u, masks[c])
    return u


def jacobi_sweeps(blocks, Dinv, rhs, u, n, omega=0.8):
    for _ in range(n):
        unew = bmv(Dinv, rhs - offdiag_matvec(blocks, u))
        u = omega * unew + (1 - omega) * u
    return u


# ---------------------------------------------------------------------------
# Color-split layout: red-black packing with no gathers (rolls + parity masks)
# ---------------------------------------------------------------------------

def parity_mask(Nj, dtype, device=None):
    """(Nj, 1, 1) float mask: 1.0 on even rows, 0.0 on odd rows."""
    return torch.as_tensor((np.arange(Nj) % 2 == 0)[:, None, None],
                           dtype=dtype, device=device)


def pack_colors(u, even):
    """(Nj, Ni, B) -> (u_c0, u_c1) each (Nj, Ni/2, B).

    ``even``: parity_mask(Nj).  Color 0 occupies even i on even rows.
    """
    Nj, Ni, B = u.shape
    pairs = u.reshape(Nj, Ni // 2, 2, B)
    a, b = pairs[:, :, 0], pairs[:, :, 1]
    u0 = even * a + (1.0 - even) * b
    u1 = even * b + (1.0 - even) * a
    return u0, u1


def unpack_colors(u0, u1, even):
    """Inverse of pack_colors."""
    Nj, Nh, B = u0.shape
    a = even * u0 + (1.0 - even) * u1
    b = even * u1 + (1.0 - even) * u0
    return torch.stack([a, b], dim=2).reshape(Nj, 2 * Nh, B)


def _rowsel(even, x_even, x_odd):
    return even * x_even + (1.0 - even) * x_odd


def split_neighbor_fields(other, color, even):
    """(iL, iR, jL, jR) neighbor fields of cells of ``color``, read from the
    opposite color's packed lattice ``other`` (Nj, Ni/2, B).

    i-rolls wrap (exact for O-grids; wrapped blocks are zero otherwise);
    j-shifts use zero halos, matching ``neighbor_fields``.
    """
    if other.shape[1] == 1:
        # Ni == 2: the packed lattice is one cell wide, a roll by +-1 is
        # the identity
        roll_p = roll_m = other
    else:
        roll_p = torch.roll(other, 1, dims=1)      # ip - 1
        roll_m = torch.roll(other, -1, dims=1)     # ip + 1
    if color == 0:
        u_iL = _rowsel(even, roll_p, other)
        u_iR = _rowsel(even, other, roll_m)
    else:
        u_iL = _rowsel(even, other, roll_p)
        u_iR = _rowsel(even, roll_m, other)
    return u_iL, u_iR, _shift_j(other, True), _shift_j(other, False)


def pack_operator_colors(blocks, Dinv=None):
    """Host-side: (Nj, Ni, 5, B, B) -> per-color packed blocks (+ Dinv).

    Returns ((blocks_c0, blocks_c1), (Dinv_c0, Dinv_c1) or None); each
    packed array is (Nj, Ni/2, 5, B, B) in the pack_colors cell ordering.
    """
    Nj, Ni = blocks.shape[:2]
    assert Ni % 2 == 0, "color-split packing needs an even Ni"
    j = np.arange(Nj)[:, None]
    ip = np.arange(Ni // 2)[None, :]
    dev = blocks.device
    i_c0 = torch.as_tensor(2 * ip + (j % 2), device=dev)
    i_c1 = torch.as_tensor(2 * ip + 1 - (j % 2), device=dev)
    jj = torch.as_tensor(np.broadcast_to(j, i_c0.shape).copy(), device=dev)
    out_b = (blocks[jj, i_c0], blocks[jj, i_c1])
    if Dinv is None:
        return out_b, None
    return out_b, (Dinv[jj, i_c0], Dinv[jj, i_c1])


def _split_off(blocks_c, other, color, even):
    return _slot_sum(blocks_c, split_neighbor_fields(other, color, even), 1)


def rb_gs_sweeps_split(blocks_c, Dinv_c, rhs_c, u_c, even, n_color_passes):
    """Packed red-black sweeps in the color-split layout.

    ``blocks_c``/``Dinv_c``/``rhs_c``/``u_c``: (color0, color1) tuples of
    packed arrays; returns the updated (u0, u1).  The same math as
    ``rb_gs_sweeps_masked`` on half the blocks per pass.
    """
    u0, u1 = u_c
    for _ in range(n_color_passes):
        u0 = bmv(Dinv_c[0], rhs_c[0] - _split_off(blocks_c[0], u1, 0, even))
        u1 = bmv(Dinv_c[1], rhs_c[1] - _split_off(blocks_c[1], u0, 1, even))
    return u0, u1


def matvec_split(blocks_c, u_c, even):
    """A @ u in the color-split layout; returns (r0, r1)."""
    u0, u1 = u_c
    r0 = bmv(blocks_c[0][:, :, 0], u0) + _split_off(blocks_c[0], u1, 0, even)
    r1 = bmv(blocks_c[1][:, :, 0], u1) + _split_off(blocks_c[1], u0, 1, even)
    return r0, r1
