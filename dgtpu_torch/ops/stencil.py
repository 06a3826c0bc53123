"""Block-stencil operators (port of ``dgtpu/ops/stencil.py``).

The reference assembles a scipy ``bsr_array`` with at most 5 blocks per block
row (self + 4 neighbors, ``discrete_system.py:135-145``).  Here, as in dgtpu,
an operator is a dense *stencil tensor*::

    blocks : (N, 5, Br, Bc)   slot order [self, iL, iR, jL, jR]
    nbr    : (N, 5) int64     neighbor element index (self for masked slots)
    mask   : (N, 5) bool      False where no neighbor (blocks are zero there)

The matvec is a gather plus one batched product in plain torch: dgtpu runs
it outside any Pallas kernel, and the mixed route uses it once per outer
refinement round as the float64 defect.
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
    def shape(self):
        n, _, br, bc = self.blocks.shape
        return (n * br, n * bc)

    def matvec(self, u):
        """A @ u for u of shape (N*Bc,) (or (N, Bc))."""
        n, s, br, bc = self.blocks.shape
        u_nbr = u.reshape(n, bc)[self.nbr]                     # (N, 5, Bc)
        out = torch.bmm(self.blocks.reshape(n * s, br, bc),
                        u_nbr.reshape(n * s, bc, 1))
        return out.reshape(n, s, br).sum(dim=1).reshape(n * br)

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


def stencil_from_contributions(diag, iL, iR, jL, jR, nbr, mask):
    """Stack per-slot block arrays into a StencilOperator, zeroing masked slots."""
    dev = diag.device
    nbr = torch.as_tensor(nbr, dtype=torch.int64, device=dev)
    mask = torch.as_tensor(mask, dtype=torch.bool, device=dev)
    blocks = torch.stack([diag, iL, iR, jL, jR], dim=1)
    blocks = torch.where(mask[:, :, None, None], blocks,
                         torch.zeros((), dtype=blocks.dtype, device=dev))
    return StencilOperator(blocks, nbr, mask)
