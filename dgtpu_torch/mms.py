"""Manufactured solutions via torch autograd (port of ``dgtpu/mms.py``).

The exact-solution strings from the paramfile are parsed into scalar
functions over a namespace of torch functions, and the sources come from
automatic differentiation:

    f_mom_x = -nu * laplace(u) (+ dp/dx for Stokes)
    f_cont  = du/dx + dv/dy    (must vanish: divergence-free check)

The expressions are pointwise, so the gradient of their *sum* over a batch
of points is each point's own derivative, and ``create_graph=True`` lets
the first derivative be differentiated again for the Laplacian.  The exact
pressure mean is a high-order Gauss-Legendre quadrature, as in dgtpu.
"""

import math

import numpy as np
import torch

from dgtpu_torch.basis import gauss_legendre

_SAFE_FUNCS = {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "exp": torch.exp, "log": torch.log, "sqrt": torch.sqrt,
    "atan": torch.atan, "asin": torch.asin, "acos": torch.acos,
    "abs": torch.abs, "Abs": torch.abs,
    "pi": math.pi,
}


def parse_expression(expr, constants=None):
    """Compile an exact-solution string (sympy-style) to a scalar fn f(x, y)
    on float64 tensors.

    Only whitelisted math names are visible; ``constants`` adds numeric
    symbols (e.g. lam, nu for the Kovasznay solution).
    """
    if expr is None:
        return None
    if isinstance(expr, (int, float)):
        const = float(expr)
        return lambda x, y: const + 0.0 * x
    ns = dict(_SAFE_FUNCS)
    if constants:
        ns.update(constants)
    code = compile(str(expr), "<mms>", "eval")
    for name in code.co_names:
        if name not in ns and name not in ("x", "y"):
            raise ValueError(f"Unknown symbol {name!r} in exact solution {expr!r}")

    def f(x, y):
        local = dict(ns)
        local["x"], local["y"] = x, y
        return eval(code, {"__builtins__": {}}, local) + 0.0 * x

    return f


def _grad(out, wrt):
    """d(sum out)/d wrt, zeros where ``out`` does not depend on ``wrt``."""
    if not out.requires_grad:
        return torch.zeros_like(wrt)
    (g,) = torch.autograd.grad(out.sum(), wrt, create_graph=True,
                               allow_unused=True)
    return torch.zeros_like(wrt) if g is None else g


def laplacian(f):
    """x, y -> d2f/dx2 + d2f/dy2, pointwise over a batch of points."""
    def lap(x, y):
        x = x.detach().requires_grad_(True)
        y = y.detach().requires_grad_(True)
        val = f(x, y)
        fx, fy = _grad(val, x), _grad(val, y)
        return _grad(fx, x) + _grad(fy, y)
    return lap


def partial(f, axis):
    """x, y -> df/dx (axis 0) or df/dy (axis 1), pointwise."""
    def d(x, y):
        x = x.detach().requires_grad_(True)
        y = y.detach().requires_grad_(True)
        return _grad(f(x, y), (x, y)[axis])
    return d


def _vectorize(f, grad=False):
    """Pointwise application over float64 tensors (or arrays) of any shape;
    the result stays on the input's device."""
    def g(x, y):
        x = torch.as_tensor(x, dtype=torch.float64)
        y = torch.as_tensor(y, dtype=torch.float64, device=x.device)
        with torch.set_grad_enabled(grad):
            out = f(x.reshape(-1), y.reshape(-1))
        return out.detach().reshape(x.shape)
    return g


class ManufacturedSolution:
    """Exact solution + autodiff sources for one Poisson or Stokes
    configuration.

    ``exact`` is a dict of expression strings per variable, ``nu`` the
    kinematic viscosity; optional ``lam`` is substituted as in the Kovasznay
    configuration (dgfem.py:53-56).
    """

    def __init__(self, exact, problem, nu, lam_expr=None):
        if problem not in ("Poisson", "Stokes"):
            raise NotImplementedError(
                f"manufactured solutions for {problem}: possible equation(s) "
                "are Poisson|Stokes")
        constants = {"nu": nu}
        if lam_expr is not None:
            lam_code = compile(str(lam_expr), "<lam>", "eval")
            constants["lam"] = float(eval(lam_code, {"__builtins__": {}},
                                          dict(_SAFE_FUNCS, nu=nu)))
        self.problem = problem
        self.nu = nu
        self.p_mean = 0.0
        self._u = parse_expression(exact.get("u"), constants)
        self.u = _vectorize(self._u)
        lap_u = laplacian(self._u)
        if problem == "Poisson":
            self.v = self.p_raw = self.f_continuity = None
            self.f_momentum = (_vectorize(lambda x, y: -nu * lap_u(x, y),
                                          grad=True),)
            return
        self._v = parse_expression(exact.get("v"), constants)
        self._p = parse_expression(exact.get("p"), constants)
        lap_v = laplacian(self._v)
        px, py = partial(self._p, 0), partial(self._p, 1)
        ux, vy = partial(self._u, 0), partial(self._v, 1)
        self.v = _vectorize(self._v)
        self.p_raw = _vectorize(self._p)
        self.f_momentum = (
            _vectorize(lambda x, y: -nu * lap_u(x, y) + px(x, y), grad=True),
            _vectorize(lambda x, y: -nu * lap_v(x, y) + py(x, y), grad=True))
        self.f_continuity = _vectorize(lambda x, y: ux(x, y) + vy(x, y),
                                       grad=True)

    def check_divergence_free(self, n_sample=64, tol=1e-10):
        """Numeric analog of the reference's symbolic divergence check
        (dgfem.py:425-429), at dgtpu's sample points."""
        if self.f_continuity is None:
            return True
        rng = np.random.default_rng(0)
        xs = rng.uniform(-0.9, 0.9, n_sample)
        ys = rng.uniform(-0.9, 0.9, n_sample)
        div = self.f_continuity(xs, ys).abs().max().item()
        if div > tol:
            raise ValueError(f"Manufactured solution is not divergence-free, "
                             f"max|div u| = {div:.3e}")
        return True

    def p(self, x, y):
        """Mean-shifted exact pressure (the reference subtracts exact_p_mean,
        dgfem.py:443)."""
        return self.p_raw(x, y) - self.p_mean

    def compute_pressure_mean(self, geometry, circular, n_quad=64):
        """Domain average of the exact pressure by Gauss-Legendre quadrature
        on the rectangle's bounding box or the annulus (r dtheta dr weight),
        as dgtpu computes it (the reference integrates symbolically,
        dgfem.py:378-402)."""
        if self.p_raw is None:
            self.p_mean = 0.0
            return 0.0
        r, w = gauss_legendre(n_quad)
        if circular:
            rad = np.sqrt(geometry.x ** 2 + geometry.y ** 2)
            r_min, r_max = float(np.min(rad)), float(np.max(rad))
            rr = r_min + (r + 1) / 2 * (r_max - r_min)
            tt = (r + 1) / 2 * (2 * np.pi)
            R, T = np.meshgrid(rr, tt, indexing="ij")
            W = np.outer(w, w) * (r_max - r_min) / 2 * np.pi * R
            vals = self.p_raw(R * np.cos(T), R * np.sin(T)).numpy()
            A = np.pi * (r_max ** 2 - r_min ** 2)
        else:
            x_min, x_max = float(np.min(geometry.x)), float(np.max(geometry.x))
            y_min, y_max = float(np.min(geometry.y)), float(np.max(geometry.y))
            xx = x_min + (r + 1) / 2 * (x_max - x_min)
            yy = y_min + (r + 1) / 2 * (y_max - y_min)
            X, Y = np.meshgrid(xx, yy, indexing="ij")
            W = np.outer(w, w) * (x_max - x_min) * (y_max - y_min) / 4
            vals = self.p_raw(X, Y).numpy()
            A = (x_max - x_min) * (y_max - y_min)
        self.p_mean = float(np.sum(vals * W) / A)
        return self.p_mean
