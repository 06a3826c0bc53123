"""dgtpu_torch's Stokes SoA cycle against dgtpu's ``build_xla`` cycle in the
V-cycle / smoother-coarse-solve configuration, and the FMG guess, on the
hierarchy of test_torch_stokes_soa.py (carried across from dgtpu).  Kept in
a file of its own so that dgtpu's compiles of these builds run beside the
W-cycle ones.  Bar: < 1e-11 relative.
"""

import jax.numpy as jnp
import numpy as np
import torch

from test_torch_stokes_soa import TOL, _cycles, _pair, _rel, hier  # noqa: F401

torch.set_num_threads(1)


def test_v_cycle_smoother_coarse_matches_build_xla(hier):  # noqa: F811
    j, t = _pair(hier, cycle="V", coarse="smoother")
    rhs = np.array(hier[0].levels[-1].rhs)
    ref = _cycles(j.build_xla(), jnp.asarray(rhs))
    assert _rel(_cycles(t, torch.as_tensor(rhs)), ref) < TOL


def test_fmg_matches(hier):  # noqa: F811
    j, t = _pair(hier, cycle="V", coarse="smoother")
    rhs = np.array(hier[0].levels[-1].rhs)
    ref = np.asarray(j.build_fmg()(jnp.asarray(rhs)))
    assert _rel(t.build_fmg()(torch.as_tensor(rhs)), ref) < TOL
    # the finest level's cycle handed in, as the mixed route does
    assert _rel(t.build_fmg(finest_cycle=t)(torch.as_tensor(rhs)), ref) < TOL
