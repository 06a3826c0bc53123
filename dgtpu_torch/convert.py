"""Carry an assembled dgtpu hierarchy across into the port.

dgtpu's operators are the port's "weights": the tests feed the same
numbers to both cycles, so cycle parity is tested apart from assembly
parity.  The input is numpy only (the caller converts dgtpu's jax arrays),
so this module, like the rest of the package, never imports jax.
"""

import numpy as np
import torch

from dgtpu_torch.ops.stencil import StencilOperator
from dgtpu_torch.ops.transfer import TransferOp


def from_dgtpu_arrays(levels, transfers, types, dims, device="cpu"):
    """Port objects from numpy copies of a dgtpu hierarchy.

    ``levels``: per level (coarsest first) a mapping with the
    ``StencilOperator`` fields ``blocks`` (N, 5, B, B), ``nbr`` (N, 5) and
    ``mask`` (N, 5); ``transfers``: per transfer a mapping with the
    ``TransferOp`` fields ``kind``, ``R`` and ``P``; ``types``: the transfer
    types (one per transfer); ``dims``: [(Nj, Ni)] per level.
    Returns ``(ops, transfers)``: StencilOperators and TransferOps in float64
    on ``device``.
    """
    if not (len(levels) == len(dims) == len(transfers) + 1 == len(types) + 1):
        raise ValueError("need one transfer and one type between each pair of "
                         "levels, and one (Nj, Ni) per level")
    ops = []
    for lv, (nj, ni) in zip(levels, dims):
        blocks = np.array(lv["blocks"], dtype=np.float64)
        if blocks.shape[0] != nj * ni:
            raise ValueError(f"level with {blocks.shape[0]} elements does not "
                             f"match dims {(nj, ni)}")
        ops.append(StencilOperator(
            torch.as_tensor(blocks, device=device),
            torch.as_tensor(np.array(lv["nbr"]), dtype=torch.int64, device=device),
            torch.as_tensor(np.array(lv["mask"]), dtype=torch.bool, device=device)))
    out = [TransferOp(t["kind"], np.array(t["R"]), np.array(t["P"]), device=device)
           for t in transfers]
    return ops, out
