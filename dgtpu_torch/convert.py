"""Carry an assembled dgtpu hierarchy across into the port.

dgtpu's operators are the port's "weights": the tests feed the same
numbers to both cycles, so cycle parity is tested apart from assembly
parity.  The input is numpy only (the caller converts dgtpu's jax arrays),
so this module, like the rest of the package, never imports jax.
"""

import numpy as np
import torch

from dgtpu_torch.models.stokes import StokesGlobalOperator
from dgtpu_torch.ops.orthonormal import ElementBasis
from dgtpu_torch.ops.stencil import StencilOperator
from dgtpu_torch.ops.transfer import TransferOp


def from_dgtpu_arrays(levels, transfers, types, dims, device="cpu"):
    """Port objects from numpy copies of a dgtpu hierarchy.

    ``levels``: per level (coarsest first) a mapping with the
    ``StencilOperator`` fields ``blocks`` (N, 5, B, B; 1x1 on an FVM level),
    ``nbr`` (N, 5) and ``mask`` (N, 5); ``transfers``: per transfer a mapping
    with the ``TransferOp`` fields ``kind``, ``R``, ``P`` and, for a
    ``dg_to_fvm`` transfer under the inverse-mass premultiply,
    ``row_scale``; ``types``: the transfer types (one per transfer);
    ``dims``: [(Nj, Ni)] per level.  Returns ``(ops, transfers)``:
    StencilOperators and TransferOps in float64 on ``device``.
    """
    if not (len(levels) == len(dims) == len(transfers) + 1 == len(types) + 1):
        raise ValueError("need one transfer and one type between each pair of "
                         "levels, and one (Nj, Ni) per level")
    ops = [_stencil(lv, nj * ni, device) for lv, (nj, ni) in zip(levels, dims)]
    # transfers[k] sits between levels k and k + 1: its tile grid is level
    # k's (2x2 cells of it for an FVM transfer's 4x4 fine / 2x2 coarse tiles)
    out = []
    for t, (nj, ni) in zip(transfers, dims):
        tiles = (dict(Ni_t=ni // 2, Nj_t=nj // 2, cf_f=4, cf_c=2)
                 if t["kind"] == "geometric_fvm" else dict(Ni_t=ni, Nj_t=nj))
        row_scale = t.get("row_scale")
        out.append(TransferOp(t["kind"], np.array(t["R"]), np.array(t["P"]),
                              device=device, row_scale=None if row_scale is None
                              else np.array(row_scale), **tiles))
    return ops, out


def element_basis_from_arrays(level, fields):
    """An ``ElementBasis`` on ``level`` (its device) from numpy copies of a
    dgtpu ``ElementBasis``'s ``weights`` (N, B, B) and ``norms`` (N, B)."""
    return ElementBasis(level, weights=np.array(fields["weights"], dtype=np.float64),
                        norms=np.array(fields["norms"], dtype=np.float64))


def stencil_from_arrays(fields, device="cpu"):
    """A float64 StencilOperator from numpy copies of a dgtpu
    ``StencilOperator``'s fields ``blocks`` (N, 5, Br, Bc), ``nbr`` and
    ``mask`` (N, 5): a Poisson level's operator, a local-ordering Stokes
    level's (block size 2Nu + Np) or a global-order level's ``block_A``,
    ``block_D`` or ``block_G``."""
    return StencilOperator(
        torch.as_tensor(np.array(fields["blocks"], dtype=np.float64), device=device),
        torch.as_tensor(np.array(fields["nbr"]), dtype=torch.int64, device=device),
        torch.as_tensor(np.array(fields["mask"]), dtype=torch.bool, device=device))


def _stencil(lv, n, device):
    op = stencil_from_arrays(lv, device)
    if op.n_elem != n:
        raise ValueError(f"level with {op.n_elem} elements does not match its {n} cells")
    return op


class StokesLevel:
    """The part of a Stokes GridLevel the SoA cycle and the distributive-GS
    smoothers read: sizes, P_sol / N_DOF_sol and the component stencils
    ``block_A/D/G`` with the (unpinned) saddle operator ``op``."""

    def __init__(self, nj, ni, p_u, p_p, A, D, G):
        self.Nj, self.Ni, self.N = nj, ni, nj * ni
        self.P_sol = {"u": p_u, "p": p_p}
        self.N_DOF_sol = {v: (p + 1) ** 2 for v, p in self.P_sol.items()}
        self.block_A, self.block_D, self.block_G = A, D, G
        self.op = StokesGlobalOperator(A, D, G, pin=False)


class StokesTransfer:
    """A carried-across Stokes transfer: ``kind`` and, per kind, ``Ru``/``Rp``
    (polynomial) or ``tu``/``tp`` TransferOps (geometric)."""

    def __init__(self, kind, **parts):
        self.kind = kind
        for name, value in parts.items():
            setattr(self, name, value)


def from_dgtpu_stokes_arrays(levels, transfers, dims, device="cpu"):
    """Port objects from numpy copies of a dgtpu global-order Stokes
    hierarchy, in float64 on ``device``.

    ``levels``: per level (coarsest first) a mapping with ``p_u``, ``p_p``
    and, for each of ``A``, ``D`` and ``G``, a mapping of the
    ``StencilOperator`` fields ``blocks``, ``nbr`` and ``mask``;
    ``transfers``: per transfer a mapping with ``kind`` and, for
    'polynomial', ``Ru`` and ``Rp``, for 'geometric', ``tu`` and ``tp``
    (each a mapping with ``R`` and ``P``); ``dims``: [(Nj, Ni)] per level.
    Returns ``(levels, transfers)``: StokesLevels and StokesTransfers for
    ``ops.stokes_soa.SoAStokesVCycle``.
    """
    if not len(levels) == len(dims) == len(transfers) + 1:
        raise ValueError("need one transfer between each pair of levels, and "
                         "one (Nj, Ni) per level")
    out_levels = [StokesLevel(nj, ni, int(lv["p_u"]), int(lv["p_p"]),
                              *(_stencil(lv[c], nj * ni, device) for c in "ADG"))
                  for lv, (nj, ni) in zip(levels, dims)]

    def t64(a):
        return torch.as_tensor(np.array(a, dtype=np.float64), device=device)

    out_transfers = []
    for t in transfers:
        if t["kind"] == "polynomial":
            out_transfers.append(StokesTransfer("polynomial", Ru=t64(t["Ru"]),
                                                Rp=t64(t["Rp"])))
        elif t["kind"] == "geometric":
            out_transfers.append(StokesTransfer("geometric", **{
                c: TransferOp("geometric", np.array(t[c]["R"]), np.array(t[c]["P"]),
                              device=device) for c in ("tu", "tp")}))
        else:
            out_transfers.append(StokesTransfer(t["kind"]))
    return out_levels, out_transfers
