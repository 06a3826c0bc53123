"""Setup-time linear algebra on the host.

Like dgtpu, the float64 inversions (mass matrices, block-diagonal smoother
inverses, the dense coarse-level inverse) run through host LAPACK via numpy
once at setup; the result comes back on the input's device and dtype.
"""

import numpy as np
import torch


def host_inv(M):
    """Batched matrix inverse computed on the host."""
    M = torch.as_tensor(M)
    return torch.from_numpy(np.linalg.inv(M.cpu().numpy())).to(M.device)


def host_lu_inverse(A):
    """Dense inverse for the cached coarse solve (applied as a product)."""
    return host_inv(A)
