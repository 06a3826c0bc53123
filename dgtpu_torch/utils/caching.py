"""Assembled-operator caching (port of ``dgtpu/utils/caching.py``; the
reference pickles its caches in ``cache/``).

The reference pickles initialized grids and assembled systems keyed by
problem/size/p/sigma/coarsening in the filename and validates by
settings-dict equality (grid.py:96-148, discrete_system.py:29-50).  Here, as
in dgtpu, the assembled operator arrays are stored as ``.npz`` (no code runs
on load) with a JSON settings fingerprint: dgtpu's key scheme and its
validation.  The fingerprint covers the grid/solution/problem sections and
the per-level assembly inputs (sigma, gamma, P_sol, discretization,
coarsening factor): sigma comes from the penalty-coarsening multipliers, so
changing them must miss although the three sections are unchanged.

Arrays are saved from the host and loaded onto the level's device.  The
port keeps a directory of its own, ``cache/dgtpu_torch/discrete_system`` and
``cache/dgtpu_torch/grid`` (dgtpu's are ``cache/discrete_system`` and
``cache/grid``): the keys are the same, so a shared directory would let a
port run load dgtpu's arrays and hide an assembly fault of the port.
"""

import hashlib
import json
import os

import numpy as np
import torch

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# module-level so tests can point it elsewhere
CACHE_ROOT = os.path.join(REPO_ROOT, "cache", "dgtpu_torch")


def _fingerprint(level):
    relevant = {k: level.settings.to_dict().get(k)
                for k in ("grid", "solution", "problem")}
    # per-level assembly inputs not derivable from the three sections
    relevant["_level"] = {
        "sigma": float(level.sigma),
        "gamma": float(level.gamma) if level.gamma is not None else None,
        "P_sol": {k: int(v) for k, v in level.P_sol.items()},
        "discretization": level.discretization,
        "coarsening_factor": level.coarsening_factor,
    }
    blob = json.dumps(relevant, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def cache_key(level, problem_type):
    p_sol = "_".join(f"p{v}{level.P_sol[v]}" for v in sorted(level.P_sol))
    sigma = f"{float(level.sigma):g}".replace(".", "_")
    name = (f"discrete_system_{problem_type}_{level.Ni}X{level.Nj}"
            f"_nPoly{level.P_grid}_{p_sol}_sigma{sigma}")
    if level.discretization != "dg":
        name += f"_{level.discretization}"
    if problem_type == "Stokes":
        name += f"_{level.settings.solution.ordering}"
    if level.settings.grid.circular:
        name += "_circle"
    if level.coarsening_factor:
        name += f"_coarsened_{level.coarsening_factor}"
    return name


def _cache_subdir(sub):
    path = os.path.join(CACHE_ROOT, sub)
    os.makedirs(path, exist_ok=True)
    return path


def cache_dir():
    return _cache_subdir("discrete_system")


def grid_cache_dir():
    return _cache_subdir("grid")


def _atomic_savez(path, **payload):
    """Write the npz to a temporary file in the same directory, then rename:
    ``os.replace`` is atomic on POSIX, so a concurrent reader sees the old
    file or the whole new one, never a truncated zip."""
    # the temporary name keeps the .npz suffix: np.savez appends it otherwise
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    try:
        np.savez(tmp, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _cache_path(level, problem_type):
    return os.path.join(cache_dir(), cache_key(level, problem_type) + ".npz")


def _with_fingerprint(level, payload):
    payload["fingerprint"] = np.frombuffer(_fingerprint(level).encode(), dtype=np.uint8)
    return payload


def _load_validated(level, problem_type):
    """The npz's arrays as a dict, or None on a miss, a corrupt file or a
    fingerprint mismatch."""
    if not level.settings.caching.enabled:
        return None
    path = _cache_path(level, problem_type)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as data:
            arrays = {k: data[k] for k in data.files}
    except Exception:
        # a corrupt or partial file: a miss, reassemble (the save replaces it)
        return None
    if bytes(arrays["fingerprint"]).decode() != _fingerprint(level):
        # the settings changed since the file was written
        return None
    return arrays


def _on(level, arr, dtype=None):
    return torch.as_tensor(arr, dtype=dtype, device=level.device)


def save_operator(level, problem_type, op, rhs, inv_mass=None):
    if not level.settings.caching.enabled:
        return None
    path = _cache_path(level, problem_type)
    payload = _with_fingerprint(level, {"blocks": _host(op.blocks),
                                        "nbr": _host(op.nbr), "mask": _host(op.mask)})
    if rhs is not None:
        payload["rhs"] = _host(rhs)
    if inv_mass is not None:
        payload["inv_mass"] = _host(inv_mass)
    _atomic_savez(path, **payload)
    return path


def load_operator(level, problem_type):
    """(op, rhs, inv_mass) on the level's device, or None."""
    from dgtpu_torch.ops.stencil import StencilOperator
    data = _load_validated(level, problem_type)
    if data is None:
        return None
    op = StencilOperator(_on(level, data["blocks"]), _on(level, data["nbr"], torch.int64),
                         _on(level, data["mask"], torch.bool))
    rhs = _on(level, data["rhs"]) if "rhs" in data else None
    inv_mass = _on(level, data["inv_mass"]) if "inv_mass" in data else None
    return op, rhs, inv_mass


def _grid_path(x, y, Ni, Nj, p_grid, tag):
    """Content-addressed: the node-coordinate hash is the fingerprint."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(x).tobytes())
    h.update(np.ascontiguousarray(y).tobytes())
    return os.path.join(grid_cache_dir(),
                        f"{tag}_{Ni}X{Nj}_nPoly{p_grid}_{h.hexdigest()[:16]}.npz")


def load_element_coords(settings, x, y, Ni, Nj, p_grid, tag="el_coords"):
    """Cached per-element nodal coordinates (X, Y) as host arrays, or None."""
    if not settings.caching.enabled:
        return None
    path = _grid_path(x, y, Ni, Nj, p_grid, tag)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as data:
            return data["X"], data["Y"]
    except Exception:
        return None


def save_element_coords(settings, x, y, Ni, Nj, p_grid, X, Y, tag="el_coords"):
    if not settings.caching.enabled:
        return None
    path = _grid_path(x, y, Ni, Nj, p_grid, tag)
    _atomic_savez(path, X=np.asarray(X), Y=np.asarray(Y))
    return path


def save_stokes_parts(level, A_blocks, D_blocks, G_blocks, rhs_local, epsilon):
    """Cache the ordering-independent Stokes pieces (before the pressure pin,
    the right-hand side in local order): the layout is cheap to rebuild, the
    assembly and the Epsilon integral are what is stored."""
    if not level.settings.caching.enabled:
        return None
    path = _cache_path(level, "Stokes")
    payload = _with_fingerprint(level, {
        "A_blocks": _host(A_blocks), "D_blocks": _host(D_blocks),
        "G_blocks": _host(G_blocks), "nbr": np.asarray(level.nbr),
        "mask": np.asarray(level.nbr_mask)})
    if rhs_local is not None:
        payload["rhs_local"] = _host(rhs_local)
    if epsilon is not None:
        payload["epsilon"] = np.asarray(epsilon)
    _atomic_savez(path, **payload)
    return path


def load_stokes_parts(level):
    """(A_blocks, D_blocks, G_blocks, rhs_local, epsilon) on the level's
    device, or None."""
    data = _load_validated(level, "Stokes")
    if data is None:
        return None
    rhs = _on(level, data["rhs_local"]) if "rhs_local" in data else None
    eps = float(data["epsilon"]) if "epsilon" in data else None
    return (_on(level, data["A_blocks"]), _on(level, data["D_blocks"]),
            _on(level, data["G_blocks"]), rhs, eps)
