"""Per-element Gram-Schmidt orthonormalization on the physical element (port
of ``dgtpu/ops/orthonormal.py``).

Reference: ``problem.orthonormal_on_physical_element`` — every element's
modal basis is re-orthonormalized against the physical inner product
``<f, g>_e = int_e f g dx = sum_q w_q J_e(q) f g`` (interpolation.py:202-219,
wired per element at element.py:33-43 and per face side at face.py:43-59).

The recursion over modes runs on the host in float64 numpy, each step
batched over all N elements, as dgtpu's does; the result is a per-element
change of basis ``V_e_new = V_table @ W_e * n_e`` held on the level's device,
so every Vandermonde table becomes an (N, nq, B) tensor.

As in dgtpu, the reference's accumulated ``weights`` (which drop the
second-order cross terms of the recursion, interpolation.py:213) are applied
to every table alike: a consistent change of basis, so the discrete
solution is the standard basis's, and the per-element mass matrix is the
identity up to the same O(delta^2) the reference reaches on its traces.
"""

import numpy as np
import torch


def gram_schmidt_weights(V, wJ, eps=1e-16):
    """Batched modified Gram-Schmidt on the columns of V under diag(wJ_e).

    ``V``: (nq, B) shared basis values at volume quadrature; ``wJ``: (N, nq)
    per-element weights (w_2d * J_e).  Returns host arrays (weights, norms):
    ``weights`` (N, B, B) upper-triangular combination matrix, ``norms``
    (N, B), such that the orthonormalized values are
    ``(V @ weights_e) * norms_e`` — interpolation.py:202-219, including its
    eps regularization.
    """
    V = np.asarray(V, dtype=np.float64)
    wJ = np.asarray(wJ, dtype=np.float64)
    N, B = wJ.shape[0], V.shape[1]
    Vo = np.broadcast_to(V, (N,) + V.shape).copy()     # (N, nq, B)
    weights = np.zeros((N, B, B))
    for i in range(B):
        weights[:, i, i] = 1.0
        for j in range(i):
            num = np.einsum("nq,nq,nq->n", Vo[:, :, i], Vo[:, :, j], wJ)
            den = np.einsum("nq,nq,nq->n", Vo[:, :, j], Vo[:, :, j], wJ) + eps
            w = -num / den
            Vo[:, :, i] += w[:, None] * Vo[:, :, j]
            weights[:, j, i] += w
    norms = 1.0 / np.sqrt(np.einsum("nqb,nqb,nq->nb", Vo, Vo, wJ) + eps)
    return weights, norms


class ElementBasis:
    """Per-element basis transform applied to any Vandermonde table:
    ``apply(V_table)`` maps a shared (nq, B) table to the per-element
    (N, nq, B) tensor ``V @ W_e * n_e`` (element.py:41-43: the volume-derived
    weights and norms re-express every trace and derivative table).
    ``weights`` (N, B, B) and ``norms`` (N, B) are float64 on the level's
    device."""

    def __init__(self, level, gt=None, var="u", weights=None, norms=None):
        if weights is None:
            gt = gt if gt is not None else level.gt
            q = level.quad
            wJ = (gt[var]["e"]["J"].cpu().numpy()
                  * np.asarray(q.w_int_2d[var])[None, :])
            weights, norms = gram_schmidt_weights(q.V_sol_int[var][var], wJ)
        self.weights = torch.as_tensor(weights, dtype=torch.float64, device=level.device)
        self.norms = torch.as_tensor(norms, dtype=torch.float64, device=level.device)

    def apply(self, table):
        table = torch.as_tensor(table, dtype=torch.float64, device=self.weights.device)
        return torch.einsum("qb,nbc->nqc", table, self.weights) * self.norms[:, None, :]


def element_bases(level, gt=None, vars=("u",)):
    """{var: ElementBasis} for each requested variable, kept on
    ``level.element_basis``; None (and the attribute cleared) when the
    setting is off.  Each variable gets its own transform under its own
    quadrature's physical inner product (the reference's is u-only)."""
    if not getattr(level.settings.problem, "orthonormal_on_physical_element", False):
        level.element_basis = None
        return None
    cached = dict(getattr(level, "element_basis", None) or {})
    for v in vars:
        if v not in cached:
            cached[v] = ElementBasis(level, gt=gt, var=v)
    level.element_basis = cached
    return cached
