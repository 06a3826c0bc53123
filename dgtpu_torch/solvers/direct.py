"""Direct solver: dense LU on the device (port of ``dgtpu/solvers/direct.py``;
reference: SuperLU spsolve, solver.py:56-59).

The reference's problem sizes (8x8 p=5 Poisson = 2,304 DOF) are trivially
dense; ``torch.linalg`` runs the LU in the operator's dtype (float64 from
the assembly) on its device: dgtpu computes this outside any Pallas kernel.
For repeated solves the factors can be cached with :func:`lu_factor_dense`.
"""

import torch

from dgtpu_torch.ops.stencil import as_dense_operator


def solve_direct(op, rhs):
    return torch.linalg.solve(as_dense_operator(op).A, rhs)


def lu_factor_dense(op):
    return torch.linalg.lu_factor(as_dense_operator(op).A)


def lu_solve(lu, rhs):
    return torch.linalg.lu_solve(*lu, rhs.unsqueeze(-1)).squeeze(-1)
