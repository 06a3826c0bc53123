"""GridLevel: one (multigrid) level = geometry batch + quadrature + topology.

Port of ``dgtpu/level.py``.  A level holds host numpy element coordinates,
constant basis tables and static index maps; its float64 metric terms are
computed on the level's ``device`` (:func:`dgtpu_torch.geometry.geometry_terms`,
or the fine-grid sampling path for h-coarsened levels).
"""

import numpy as np
import torch

from dgtpu_torch.basis import QuadratureSet
from dgtpu_torch.geometry import (FaceTopology, coarse_element_coords,
                                  coarse_geometry_terms, element_coords,
                                  geometry_terms, neighbor_map)
from dgtpu_torch.utils import caching
from dgtpu_torch.utils.logger import Logger


class GridLevel:
    """``discretization``: "dg" (modal SIP-DG) or "fvm" (cell-centered finite
    volumes, ``models/fvm.py``: a 1x1 block per cell)."""

    def __init__(self, geometry, settings, vars, P_sol, sigma=None, gamma=None,
                 device="cpu", discretization="dg"):
        self.settings = settings
        self.logger = Logger(__name__, settings).logger
        self.device = torch.device(device)
        self.vars = list(vars)
        self.discretization = discretization
        self.coarsening_factor = None

        self.P_grid = geometry.P_grid
        self.N_grid = geometry.N_grid
        self.N_DOF_grid = geometry.N_DOF_grid
        self.O_grid = geometry.O_grid
        self.fully_periodic = geometry.fully_periodic_boundaries
        self.Ni, self.Nj, self.N = geometry.Ni, geometry.Nj, geometry.N

        # DOF bookkeeping (grid.py:103-110); a Stokes element carries u, v
        # and p modes
        self.P_sol = dict(P_sol)
        self.N_sol = {v: self.P_sol[v] + 1 for v in self.vars}
        self.N_DOF_sol = {v: self.N_sol[v] ** 2 for v in self.vars}
        if self.vars == ["u"]:
            self.N_DOF_sol_tot = self.N_DOF_sol["u"]
        else:
            self.N_DOF_sol_tot = 2 * self.N_DOF_sol["u"] + self.N_DOF_sol["p"]
        self.N_int = {
            v: getattr(getattr(settings.solution, v), "integration_polynomial_degree_factor")
               * self.P_sol[v] // 2 + 1
            for v in self.vars}

        self.sigma = sigma
        if not self.sigma:
            self.sigma = (settings.problem.SIP_penalty_parameter
                          if settings.problem.SIP_penalty_parameter else
                          (self.P_sol["u"] + 1) ** 2
                          * settings.problem.SIP_penalty_parameter_multiplier)
        self.gamma = gamma or settings.problem.velocity_penalty_parameter

        self.quad = QuadratureSet(self.N_grid, self.N_sol, self.N_int)
        self.X, self.Y = self._element_coords(geometry)
        self._check_closure()
        self._build_topology()
        self._gt = None

        # assembled-system slots
        self.op = None          # StencilOperator (StokesGlobalOperator)
        self.rhs = None
        self.inv_mass = None    # (N, B, B) per-element inverse mass matrices
        self.block_A = None     # Stokes global-order component stencils
        self.block_D = None
        self.block_G = None
        self.Epsilon = None

        self.logger.debug(
            f"Initialized grid level: P_grid={self.P_grid}, P_sol={self.P_sol}, "
            f"sigma={self.sigma}, {self.Ni}x{self.Nj} elements, "
            f"N_DOF_sol_tot={self.N_DOF_sol_tot}")

    # -- construction helpers ------------------------------------------------

    def _element_coords(self, geometry):
        """Per-element nodal coordinates, from the grid cache when caching is
        on (content-addressed by the node lattice, ``utils/caching.py``)."""
        key = (self.settings, geometry.x, geometry.y, self.Ni, self.Nj, self.P_grid)
        cached = caching.load_element_coords(*key)
        if cached is not None:
            return cached
        X, Y = element_coords(geometry.x, geometry.y, self.Ni, self.Nj, self.P_grid)
        caching.save_element_coords(*key, X, Y)
        return X, Y

    def _check_closure(self):
        if self.O_grid:
            G1 = self.P_grid + 1
            first = self.X[np.arange(self.Nj) * self.Ni]           # i = 0 column
            last = self.X[np.arange(self.Nj) * self.Ni + self.Ni - 1]
            fy = self.Y[np.arange(self.Nj) * self.Ni]
            ly = self.Y[np.arange(self.Nj) * self.Ni + self.Ni - 1]
            # element i=0's imin edge nodes (a=0) vs i=Ni-1's imax edge (a=G1-1)
            idx_min = np.arange(G1) * G1
            idx_max = np.arange(G1) * G1 + (G1 - 1)
            if (np.abs(first[:, idx_min] - last[:, idx_max]).max() > 1e-15
                    or np.abs(fy[:, idx_min] - ly[:, idx_max]).max() > 1e-15):
                raise ValueError("Element does not close O-grid with neighbouring element")

    def _build_topology(self):
        periodic_i = self.O_grid
        self.faces_i = FaceTopology(self.Ni, self.Nj, "i", periodic_i)
        self.faces_j = FaceTopology(self.Ni, self.Nj, "j", False)
        self.nbr, self.nbr_mask = neighbor_map(self.Ni, self.Nj, periodic_i, False)

    # -- device geometry ------------------------------------------------------

    @property
    def gt(self):
        if self._gt is None:
            self._gt = geometry_terms(self.X, self.Y, self.quad, self.device)
        return self._gt

    def h_F(self, topo):
        """Face size h_F = mean of sqrt(element areas) of present sides (face.py:13-35)."""
        sa = torch.sqrt(self.gt["A"])
        eL = torch.as_tensor(topo.eL, device=self.device)
        eR = torch.as_tensor(topo.eR, device=self.device)
        hl = torch.as_tensor(topo.has_L, dtype=sa.dtype, device=self.device)
        hr = torch.as_tensor(topo.has_R, dtype=sa.dtype, device=self.device)
        return (hl * sa[eL] + hr * sa[eR]) / (hl + hr)


class CoarseGridLevel(GridLevel):
    """h-coarsened level whose metric terms are sampled from the fine level.

    Reference: CoarseGrid/CoarseElement (grid.py:272-360, element.py:234-356).
    """

    def __init__(self, geometry, fine_level, settings, vars, coarsening_factor,
                 device="cpu", discretization="dg"):
        self._fine = fine_level
        self._cf = coarsening_factor

        class _GeomView:
            pass

        g = _GeomView()
        g.P_grid = fine_level.P_grid
        g.N_grid = fine_level.N_grid
        g.N_DOF_grid = fine_level.N_DOF_grid
        g.O_grid = fine_level.O_grid
        g.fully_periodic_boundaries = fine_level.fully_periodic
        g.Ni = fine_level.Ni // coarsening_factor
        g.Nj = fine_level.Nj // coarsening_factor
        g.N = g.Ni * g.Nj
        if g.Ni == 0 or g.Nj == 0:
            raise ValueError(
                f"The number of original elements ({fine_level.Ni},{fine_level.Nj}) "
                f"cannot be divided by a factor {coarsening_factor} "
                f"(element counts come from (grid nodes - 1) // grid.polynomial_"
                f"degree = {fine_level.P_grid}; if this grid was read with the "
                f"wrong degree, pass --p-grid / set grid.polynomial_degree)")
        # coarse element nodal coordinates: strided fine-grid nodes
        self._Xc, self._Yc = coarse_element_coords(
            fine_level.X, fine_level.Y, fine_level.Ni, fine_level.Nj,
            fine_level.P_grid, coarsening_factor)
        g.x, g.y = self._nodes_from_elements(self._Xc, self._Yc, g.Ni, g.Nj,
                                             g.P_grid)
        # an FVM level carries one cell average per cell (P_sol 0)
        P_sol = ({k: 0 for k in fine_level.P_sol} if discretization == "fvm"
                 else dict(fine_level.P_sol))
        super().__init__(g, settings, vars, P_sol, sigma=fine_level.sigma,
                         gamma=fine_level.gamma, device=device,
                         discretization=discretization)
        self.coarsening_factor = coarsening_factor

    @staticmethod
    def _nodes_from_elements(X, Y, Ni, Nj, p_grid):
        """Reassemble the global node lattice from per-element coords (shared edges)."""
        G1 = p_grid + 1
        il, jl = Ni * p_grid + 1, Nj * p_grid + 1
        x = np.zeros((il, jl))
        y = np.zeros((il, jl))
        for m in range(Ni * Nj):
            i, j = m % Ni, m // Ni
            x[i * p_grid:i * p_grid + G1, j * p_grid:j * p_grid + G1] = \
                X[m].reshape(G1, G1, order="F")
            y[i * p_grid:i * p_grid + G1, j * p_grid:j * p_grid + G1] = \
                Y[m].reshape(G1, G1, order="F")
        return x, y

    @property
    def gt(self):
        if self._gt is None:
            self._gt = coarse_geometry_terms(
                self._fine.X, self._fine.Y, self.quad,
                self._fine.Ni, self._fine.Nj, self._cf, self.device)
        return self._gt
