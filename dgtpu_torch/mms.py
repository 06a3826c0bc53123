"""Manufactured solutions via torch autograd (port of ``dgtpu/mms.py``).

The exact-solution strings from the paramfile are parsed into scalar
functions over a namespace of torch functions, and the Poisson source
``f = -nu * laplace(u)`` comes from automatic differentiation: the
expressions are pointwise, so the gradient of their *sum* over a batch of
points is each point's own derivative, and ``create_graph=True`` lets the
first derivative be differentiated again for the Laplacian.

Only the Poisson parts are ported; Stokes (momentum + continuity sources,
pressure mean, divergence check) is ROADMAP Queue 1 item 9.
"""

import math

import torch

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
    """Exact solution + autodiff source for one Poisson configuration.

    ``exact`` is a dict of expression strings per variable, ``nu`` the
    kinematic viscosity; optional ``lam`` is substituted as in the Kovasznay
    configuration (dgfem.py:53-56).
    """

    def __init__(self, exact, problem, nu, lam_expr=None):
        if problem != "Poisson":
            raise NotImplementedError(
                f"manufactured solutions for {problem} are not ported yet "
                "(ROADMAP Queue 1 item 9, Stokes)")
        constants = {"nu": nu}
        if lam_expr is not None:
            lam_code = compile(str(lam_expr), "<lam>", "eval")
            constants["lam"] = float(eval(lam_code, {"__builtins__": {}},
                                          dict(_SAFE_FUNCS, nu=nu)))
        self.nu = nu
        self._u = parse_expression(exact.get("u"), constants)
        lap_u = laplacian(self._u)
        self.u = _vectorize(self._u)
        self.f_momentum = (_vectorize(lambda x, y: -nu * lap_u(x, y), grad=True),)
