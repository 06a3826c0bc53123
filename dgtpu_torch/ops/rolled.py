"""Rolled layout and the red-black color split (port of the color-split
pieces of ``dgtpu/ops/rolled.py``, ``:51-56`` and ``:164-243``).

On the structured element grid a stencil operator rolls to::

    blocks : (Nj, Ni, 5, B, B)    vectors : (Nj, Ni, B)

For even Ni the checkerboard colors pack into two (Nj, Ni/2, ...) lattices:
color 0 sits at i = 2*ip + (j % 2), color 1 at i = 2*ip + 1 - (j % 2).  The
SoA cycle (``ops/soa.py``) keeps each color lattice with its cells in the
contiguous axis.  The float-mask blends below select exactly (a factor of 0
or 1), as in dgtpu.
"""

import numpy as np
import torch


def to_rolled(op, Ni, Nj):
    """StencilOperator blocks -> (Nj, Ni, 5, B, B)."""
    n, s, br, bc = op.blocks.shape
    assert n == Ni * Nj and s == 5
    return op.blocks.reshape(Nj, Ni, 5, br, bc)


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
