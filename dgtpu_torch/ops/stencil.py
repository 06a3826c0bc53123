"""Block-stencil operators (port of ``dgtpu/ops/stencil.py``).

The reference assembles a scipy ``bsr_array`` with at most 5 blocks per block
row (self + 4 neighbors, ``discrete_system.py:135-145``).  Here, as in dgtpu,
an operator is a dense *stencil tensor*::

    blocks : (N, 5, Br, Bc)   slot order [self, iL, iR, jL, jR]
    nbr    : (N, 5) int64     neighbor element index (self for masked slots)
    mask   : (N, 5) bool      False where no neighbor (blocks are zero there)

The matvec is a gather plus one batched product in plain torch: dgtpu runs
it outside any Pallas kernel.  The mixed route uses it once per outer
refinement round as the float64 defect; the full-precision multigrid
(``solvers/multigrid.py``) and its smoothers (``ops/smoothers.py``) are built
on it.

``DenseOperator`` covers operators whose sparsity is wider than the 5-point
stencil, with the same protocol.
"""

from dataclasses import dataclass

import torch


@dataclass
class StencilOperator:
    """5-point block-stencil linear operator on element-blocked vectors."""

    blocks: torch.Tensor   # (N, 5, Br, Bc)
    nbr: torch.Tensor      # (N, 5) int64
    mask: torch.Tensor     # (N, 5) bool

    @property
    def n_elem(self):
        return self.blocks.shape[0]

    @property
    def block_shape(self):
        return self.blocks.shape[2], self.blocks.shape[3]

    @property
    def shape(self):
        n, _, br, bc = self.blocks.shape
        return (n * br, n * bc)

    def astype(self, dtype):
        return StencilOperator(self.blocks.to(dtype), self.nbr, self.mask)

    def matvec(self, u):
        """A @ u for u of shape (N*Bc,) (or (N, Bc))."""
        n, s, br, bc = self.blocks.shape
        u_nbr = u.reshape(n, bc)[self.nbr]                     # (N, 5, Bc)
        out = torch.bmm(self.blocks.reshape(n * s, br, bc),
                        u_nbr.reshape(n * s, bc, 1))
        return out.reshape(n, s, br).sum(dim=1).reshape(n * br)

    def diag_blocks(self):
        return self.blocks[:, 0]

    def offdiag_matvec(self, u):
        """(A - D) @ u."""
        n, _, br, bc = self.blocks.shape
        u_nbr = u.reshape(n, bc)[self.nbr[:, 1:]]              # (N, 4, Bc)
        out = torch.einsum("nsij,nsj->ni", self.blocks[:, 1:], u_nbr)
        return out.reshape(n * br)

    def to_dense(self):
        """Materialize the full matrix (for the direct coarse solve / tests)."""
        n, _, br, bc = self.blocks.shape
        dev = self.blocks.device
        dense = torch.zeros((n * br, n * bc), dtype=self.blocks.dtype, device=dev)
        rows = (torch.arange(n, device=dev)[:, None, None, None] * br
                + torch.arange(br, device=dev)[None, None, :, None])
        cols = (self.nbr[:, :, None, None] * bc
                + torch.arange(bc, device=dev)[None, None, None, :])
        rows = rows.expand(self.blocks.shape)
        cols = cols.expand(self.blocks.shape)
        vals = torch.where(self.mask[:, :, None, None], self.blocks,
                           torch.zeros((), dtype=self.blocks.dtype, device=dev))
        dense.index_put_((rows.reshape(-1), cols.reshape(-1)), vals.reshape(-1),
                         accumulate=True)
        return dense

    def premultiply_blockdiag(self, M):
        """``diag(M) @ A`` for per-element matrices M (N, Br', Br): the
        inverse-mass premultiply (discrete_system.py:139-142)."""
        return StencilOperator(torch.einsum("nij,nsjk->nsik", M, self.blocks),
                               self.nbr, self.mask)

    def scale(self, alpha):
        return StencilOperator(self.blocks * alpha, self.nbr, self.mask)

    def add(self, other):
        """Sum of two stencils on the same topology."""
        return StencilOperator(self.blocks + other.blocks, self.nbr, self.mask)

    def lower_upper_masks(self):
        """Boolean slot masks for the strict block lower (E) / upper (F) parts.

        Matches the reference's ``split_block_EDF`` (relaxation.py:443-492):
        E = blocks with neighbor index < row index, F = index > row.
        """
        row = torch.arange(self.blocks.shape[0], device=self.nbr.device)[:, None]
        return (self.nbr < row) & self.mask, (self.nbr > row) & self.mask


def stencil_from_contributions(diag, iL, iR, jL, jR, nbr, mask):
    """Stack per-slot block arrays into a StencilOperator, zeroing masked slots."""
    dev = diag.device
    nbr = torch.as_tensor(nbr, dtype=torch.int64, device=dev)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
    blocks = torch.stack([diag, iL, iR, jL, jR], dim=1)
    blocks = torch.where(mask[:, :, None, None], blocks,
                         torch.zeros((), dtype=blocks.dtype, device=dev))
    return StencilOperator(blocks, nbr, mask)


@dataclass
class DenseOperator:
    """A dense matrix with the same operator protocol as StencilOperator."""

    A: torch.Tensor

    @property
    def shape(self):
        return tuple(self.A.shape)

    def astype(self, dtype):
        return DenseOperator(self.A.to(dtype))

    def matvec(self, u):
        return self.A @ u

    def to_dense(self):
        return self.A

    def block_partition(self, blocksize):
        n = self.A.shape[0] // blocksize
        return self.A.reshape(n, blocksize, n, blocksize).permute(0, 2, 1, 3)

    def diag_blocks_of(self, blocksize):
        part = self.block_partition(blocksize)
        idx = torch.arange(part.shape[0], device=self.A.device)
        return part[idx, idx]


def as_dense_operator(op):
    if isinstance(op, DenseOperator):
        return op
    return DenseOperator(op.to_dense())


def dense_block_gs_sweep(A, b, x, blocksize, backward=False, Dinv=None):
    """One forward (or backward) block-GS sweep on a dense matrix.

    Semantics of pyamg's ``amg_core.block_gauss_seidel``: for each block row i
    in order, ``x_i <- Dinv_i @ (b_i - sum_{j != i} A_ij x_j)`` with already-
    updated values for preceding rows.  A sequential loop (the parity
    version); the red-black variants in ``ops/smoothers.py`` are the parallel
    path.
    """
    nb = A.shape[0] // blocksize
    if Dinv is None:
        Dinv = torch.linalg.inv(DenseOperator(A).diag_blocks_of(blocksize))
    x = x.clone()
    for i in (range(nb - 1, -1, -1) if backward else range(nb)):
        sl = slice(i * blocksize, (i + 1) * blocksize)
        row = A[sl]
        x[sl] = Dinv[i] @ (b[sl] - (row @ x - row[:, sl] @ x[sl]))
    return x
