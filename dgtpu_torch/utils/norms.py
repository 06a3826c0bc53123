"""Error / residual norms with the reference's size-normalized convention.

The reference defines ``Lp = (sum(|d|^p)/n)^(1/p)`` (``utils/helpers.py:16-26``)
— note the division by the element count — and all logged residuals and MMS
errors use it.
"""

import numpy as np
import torch


def lp_norm(delta, p=2):
    """Size-normalized Lp norm: ``(sum(|delta|**p)/delta.numel())**(1/p)``."""
    delta = torch.as_tensor(delta)
    return (torch.sum(torch.abs(delta) ** p) / delta.numel()) ** (1.0 / p)


def residual_norm(operator, u, rhs, p=2):
    """``Lp(rhs - A @ u)`` for any object with a ``matvec``."""
    return lp_norm(rhs - operator.matvec(u), p)


def compute_row_echelon(A):
    """Row echelon form (host numpy) — the reference's consistency-rank
    helper (utils/helpers.py:117-162), iterative rather than recursive."""
    A = np.array(A, dtype=np.float64)
    r, c = A.shape
    row = 0
    for col in range(c):
        if row >= r:
            break
        piv = row + np.argmax(np.abs(A[row:, col]) > 0)
        if A[piv, col] == 0:
            continue
        if piv != row:
            A[[row, piv]] = A[[piv, row]]
        A[row] = A[row] / A[row, col]
        if row + 1 < r:
            A[row + 1:] -= A[row] * A[row + 1:, col:col + 1]
        row += 1
    return A
