"""Error / residual norms with the reference's size-normalized convention.

The reference defines ``Lp = (sum(|d|^p)/n)^(1/p)`` (``utils/helpers.py:16-26``)
— note the division by the element count — and all logged residuals and MMS
errors use it.
"""

import torch


def lp_norm(delta, p=2):
    """Size-normalized Lp norm: ``(sum(|delta|**p)/delta.numel())**(1/p)``."""
    delta = torch.as_tensor(delta)
    return (torch.sum(torch.abs(delta) ** p) / delta.numel()) ** (1.0 / p)
