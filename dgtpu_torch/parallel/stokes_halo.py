"""Sharded Stokes multigrid: distributive-GS smoothing over the shards (port
of ``dgtpu/parallel/stokes_halo.py``).

The lsq-splitting distributive Gauss-Seidel sweep written entirely in
5-point stencil applications, so that every step shards over the element
rows like ``parallel/halo.py``::

    momentum   A  : (N, 5, 2Nu, 2Nu)  velocity -> velocity
    gradient   G  : (N, 5, 2Nu, Np)   pressure -> momentum rows
    divergence D  : (N, 5, Np, 2Nu)   velocity -> continuity rows
    DG = D @ G    : 13-point operator, applied as two stencil matvecs (two
                    halo exchanges), never formed.

One sweep is a fixed sequence of halo matvecs and red-black colored block-GS
passes.  The p-/penalty transfers are element-local, the geometric 2x2
agglomeration per component shard-local; the coarsest level is solved with a
replicated dense pinned inverse (one gather per visit).  Red-black sweeps are
dgtpu's documented parallel deviation from the reference's lexicographic
dense sweeps; for the 13-point DG operator the checkerboard coloring is a
hybrid Jacobi/GS pass, which is fine for a smoother.  (dgtpu's design note:
cell-wise Vanka on the local-ordering saddle stencil diverges on this SIP-DG
discretization, so the distributive transform is structural.)

The solves run as ``parallel/halo.py``'s do: on one card from CUDA graphs
(the float32 cycle, the float64 saddle defect, the GMRES(16)-wrapped inner
solve's matvec and arithmetic stages, the full-precision loop as a
``LoopGraph``), on the CPU eagerly with masked loops, across cards as host
loops.
"""

import math

import numpy as np
import torch

from dgtpu_torch.models.stokes import (_dg_diag_blocks, _elem_uv_to_global,
                                       _global_uv_to_elem)
from dgtpu_torch.ops.linalg import host_inv, host_lu_inverse
from dgtpu_torch.ops.rolled import bmv
from dgtpu_torch.ops.smoothers import estimate_rho_dinv_a
from dgtpu_torch.ops.stokes_soa import _blockdiag2
from dgtpu_torch.ops.transfer import p_restriction
from dgtpu_torch.parallel.halo import (ShardColorPack, _add, _cast, _check_defect,
                                       _chebyshev_sweep, _Graphs, _level_smoother_cfgs,
                                       _local_offdiag, _matvec_with_halo as _matvec,
                                       _psum, _rb_gs_sweep_packed, _sub, _zeros_like,
                                       make_mesh, reshape_level,
                                       shardable_device_counts, solve_cycles)
from dgtpu_torch.solvers.refinement import gmres_correction, gmres_stages
from dgtpu_torch.utils import trace


class _LevelData:
    """One level's operands as lists over shards (band k on device k):
    ``A``, ``D``, ``G`` in the (Nj_loc, Ni, 5, ., .) layout, the inverse
    diagonal blocks of A, the diagonal blocks of DG and their inverses, and
    the colors."""

    FIELDS = ("A", "D", "G", "A_Dinv", "DG_diag", "DG_Dinv")

    def __init__(self, level, mesh):
        if level.block_A is None:
            raise ValueError("sharded Stokes needs a global-order assembly "
                             "(level.block_A/D/G)")
        self.Ni, self.Nj = Ni, Nj = level.Ni, level.Nj
        self.nu = level.N_DOF_sol["u"]
        self.npd = level.N_DOF_sol["p"]
        # block_A/D/G arrive masked from assemble_stokes
        A = reshape_level(level.block_A, Ni, Nj)
        D = reshape_level(level.block_D, Ni, Nj)
        G = reshape_level(level.block_G, Ni, Nj)
        dg_diag = _dg_diag_blocks(level.block_D, level.block_G).reshape(
            Nj, Ni, self.npd, self.npd)
        full = {"A": A, "D": D, "G": G, "A_Dinv": host_inv(A[:, :, 0]),
                "DG_diag": dg_diag, "DG_Dinv": host_inv(dg_diag)}
        for name in self.FIELDS:
            setattr(self, name, mesh.split(full[name]))
        i = torch.arange(Ni)[None, :]
        j = torch.arange(Nj)[:, None]
        self.colors = mesh.split(((i + j) % 2).to(torch.int32))

    def to(self, dtype):
        out = object.__new__(_LevelData)
        out.__dict__.update(self.__dict__)
        for name in self.FIELDS:
            setattr(out, name, _cast(getattr(self, name), dtype))
        return out

    def tensors(self):
        return [t for name in self.FIELDS + ("colors",) for t in getattr(self, name)]


# -- shard-local smoother steps ----------------------------------------------


def _color_update(colors, c, new, old):
    return [torch.where((col == c)[:, :, None], n, o)
            for col, n, o in zip(colors, new, old)]


def _rb_bgs_A(A, A_Dinv, colors, rhs, x, n_pass):
    """Red-black block-GS passes on the velocity operator A."""
    for _ in range(n_pass):
        for c in (0, 1):
            off = _local_offdiag(A, x)
            x = _color_update(colors, c, [bmv(d, r - o) for d, r, o in
                                          zip(A_Dinv, rhs, off)], x)
    return x


def _rb_bgs_DG(D, G, DG_diag, DG_Dinv, colors, rhs, p, n_pass):
    """Colored block-GS passes on DG = D@G applied as composed matvecs."""
    for _ in range(n_pass):
        for c in (0, 1):
            off = _sub(_matvec(D, _matvec(G, p)), [bmv(d, x) for d, x in zip(DG_diag, p)])
            p = _color_update(colors, c, [bmv(d, r - o) for d, r, o in
                                          zip(DG_Dinv, rhs, off)], p)
    return p


def _dgs_sweep(data, f_mom, f_cont, uv, p, n_pass=2, apack=None, cheb=None):
    """One distributive-GS (lsq splitting) sweep, the stencil/halo form of
    ``DistributiveGS.sweep``.  The velocity passes use the color-packed form
    when ``apack`` is given; ``cheb=(degree, eig_max)`` replaces them with a
    Chebyshev polynomial on the SPD momentum operator A
    (``performance.dgs_velocity_solver: chebyshev``)."""
    A, D, G = data.A, data.D, data.G

    def bgs_A(rhs, x):
        if cheb is not None:
            return _chebyshev_sweep(A, data.A_Dinv, rhs, x, degree=cheb[0],
                                    eig_max=cheb[1])
        if apack is not None:
            return _rb_gs_sweep_packed(apack, rhs, x, n_pass=n_pass)
        return _rb_bgs_A(A, data.A_Dinv, data.colors, rhs, x, n_pass)

    rhs_mom = _sub(_sub(f_mom, _matvec(A, uv)), _matvec(G, p))
    du_s = bgs_A(rhs_mom, _zeros_like(uv))
    rhs_cont = _sub(f_cont, _matvec(D, _add(uv, du_s)))
    dp_s = _rb_bgs_DG(D, G, data.DG_diag, data.DG_Dinv, data.colors, rhs_cont,
                      _zeros_like(p), n_pass)
    G_dp = _matvec(G, dp_s)
    du = _add(du_s, G_dp)
    rhs_dg = [-x for x in _matvec(D, _matvec(A, G_dp))]
    dp = _rb_bgs_DG(D, G, data.DG_diag, data.DG_Dinv, data.colors, rhs_dg,
                    _zeros_like(p), n_pass)
    return _add(uv, du), _add(p, dp)


def _saddle_residual(data, f_mom, f_cont, uv, p):
    return (_sub(_sub(f_mom, _matvec(data.A, uv)), _matvec(data.G, p)),
            _sub(f_cont, _matvec(data.D, uv)))


def _pnorm_pair(r_mom, r_cont):
    s = _psum([torch.sum(m * m) + torch.sum(c * c) for m, c in zip(r_mom, r_cont)])
    return torch.sqrt(s / sum(m.numel() + c.numel() for m, c in zip(r_mom, r_cont)))


class ShardVector:
    """A vector held as one flat part per shard, with the arithmetic
    ``solvers.refinement.gmres_correction`` uses (sums, differences, scalar
    products and quotients), so the port's GMRES runs unchanged over the
    shards; a scalar moves to each part's device."""

    def __init__(self, parts):
        self.parts = parts

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self):
        return self.parts[0].device

    def __add__(self, other):
        if isinstance(other, ShardVector):
            return ShardVector([a + b for a, b in zip(self.parts, other.parts)])
        return ShardVector([a + _on(other, a) for a in self.parts])

    __radd__ = __add__

    def __sub__(self, other):
        return ShardVector([a - b for a, b in zip(self.parts, other.parts)])

    def __mul__(self, s):
        return ShardVector([a * _on(s, a) for a in self.parts])

    __rmul__ = __mul__

    def __truediv__(self, s):
        return ShardVector([a / _on(s, a) for a in self.parts])


def _on(s, a):
    return s.to(a.device) if torch.is_tensor(s) else s


def _flatten(values):
    """Tensors and ``ShardVector``s -> (their tensors, each value's part
    count: 0 for a tensor)."""
    flat, kinds = [], []
    for v in values:
        if isinstance(v, ShardVector):
            flat += v.parts
            kinds.append(len(v.parts))
        else:
            flat.append(v)
            kinds.append(0)
    return flat, kinds


def _unflatten(flat, kinds):
    out, i = [], 0
    for k in kinds:
        out.append(ShardVector(list(flat[i:i + k])) if k else flat[i])
        i += k or 1
    return out


def _over_parts(stage, graph):
    """``stage``, a function of tensors and ``ShardVector``s returning one
    value or a tuple of them, called through ``graph`` (``CycleGraph``) of
    their tensors: a GMRES stage replayed over the shards' parts."""
    made = {}

    def call(*args):
        flat, kinds = _flatten(args)
        if not made:
            def fn(*tensors):
                out = stage(*_unflatten(tensors, kinds))
                many = isinstance(out, tuple)
                out_flat, made["kinds"] = _flatten(out if many else (out,))
                made["many"] = many
                return tuple(out_flat)
            made["graph"] = graph(fn)
        out = _unflatten(made["graph"](*flat), made["kinds"])
        return tuple(out) if made["many"] else out[0]

    return call


def _dot(a, b):
    """The mesh's psum dot product (on the first shard's device)."""
    return _psum([torch.dot(x, y) for x, y in zip(a.parts, b.parts)])


def _norm(a):
    return torch.sqrt(_psum([torch.sum(x * x) for x in a.parts]))


class ShardedStokesMultigrid(_Graphs):
    """Sharded Stokes cycle with distributive-GS smoothing (dgtpu's
    ``ShardedStokesMultigrid``).

    Levels are coarsest-first, each assembled in global ordering.  Transfer
    kinds come from ``transfers`` / ``transfer_types`` when given (geometric
    coarsening as shard-local 2x2 agglomeration per component); otherwise
    they are inferred from the levels' degrees: equal degrees => penalty
    (identity), else component-wise modal truncation.
    """

    def __init__(self, levels, settings, mesh=None, pre_iters=None, post_iters=None,
                 smoother_passes=2, transfers=None, transfer_types=None):
        self.mesh = mesh if mesh is not None else make_mesh(
            1, levels[-1].block_A.blocks.device)
        n_dev = self.mesh.size
        self.levels = levels
        self.Ni, self.Nj = levels[-1].Ni, levels[-1].Nj
        for l in levels:
            if l.Nj % n_dev:
                raise ValueError(
                    f"level with Nj={l.Nj} element rows does not divide over "
                    f"{n_dev} devices; usable device counts for this "
                    f"hierarchy are {shardable_device_counts(levels)}")
        if transfers is None:
            for l in levels:
                if (l.Ni, l.Nj) != (self.Ni, self.Nj):
                    raise ValueError(
                        "levels with unequal element counts need explicit "
                        "geometric transfers (pass transfers=)")
        mesh = self.mesh
        self.data = [_LevelData(l, mesh) for l in levels]
        dev = levels[-1].block_A.blocks.device
        kinds, Ruv, Puv, Rp, Pp = [], [], [], [], []
        self.cfs = []
        if transfers is not None:
            for k, t in enumerate(transfers):
                kind = (transfer_types[k] if transfer_types is not None
                        else getattr(t, "kind", "penalty"))
                kinds.append({"penalty_parameter": "penalty"}.get(kind, kind))
                if hasattr(t, "tu"):       # geometric: per-component TransferOps
                    # per-child scalar transfer matrices -> component-wise
                    # agglomeration operators (uv 2x2-blockdiag per child)
                    cf = int(getattr(t, "cf", 2))
                    if cf != 2:
                        raise NotImplementedError(
                            "sharded Stokes geometric coarsening supports "
                            f"cf=2 (2x2 agglomeration) only, got cf={cf}")
                    R4u, P4u = t.tu.R, t.tu.P
                    Bu = R4u.shape[1] // 4
                    Ruv.append(torch.cat([_blockdiag2(R4u[:, c * Bu:(c + 1) * Bu])
                                          for c in range(4)], dim=1))
                    Puv.append(torch.cat([_blockdiag2(P4u[c * Bu:(c + 1) * Bu, :])
                                          for c in range(4)], dim=0))
                    Rp.append(t.tp.R)
                    Pp.append(t.tp.P)
                    self.cfs.append(2)
                elif hasattr(t, "Ru"):     # polynomial: per-component R
                    Ru2 = _blockdiag2(t.Ru)
                    Ruv.append(Ru2)
                    Puv.append(Ru2.T)
                    Rp.append(t.Rp)
                    Pp.append(t.Rp.T)
                    self.cfs.append(1)
                else:                      # penalty / identity transfer
                    hi = levels[k + 1]
                    nu_f, np_f = hi.N_DOF_sol["u"], hi.N_DOF_sol["p"]
                    eye_uv = torch.eye(2 * nu_f, dtype=torch.float64, device=dev)
                    eye_p = torch.eye(np_f, dtype=torch.float64, device=dev)
                    Ruv.append(eye_uv)
                    Puv.append(eye_uv)
                    Rp.append(eye_p)
                    Pp.append(eye_p)
                    self.cfs.append(1)
        else:
            for lo, hi in zip(levels[:-1], levels[1:]):
                pu_c, pu_f = lo.P_sol["u"], hi.P_sol["u"]
                pp_c, pp_f = lo.P_sol["p"], hi.P_sol["p"]
                if (pu_c, pp_c) == (pu_f, pp_f):
                    nu_f, np_f = (pu_f + 1) ** 2, (pp_f + 1) ** 2
                    Ru2 = np.eye(2 * nu_f)
                    R_p = np.eye(np_f)
                    kinds.append("penalty")
                else:
                    Ru = p_restriction(pu_f, pu_c)
                    Ru2 = np.block([[Ru, np.zeros_like(Ru)], [np.zeros_like(Ru), Ru]])
                    R_p = p_restriction(pp_f, pp_c)
                    kinds.append("polynomial")
                Ruv.append(torch.as_tensor(Ru2, dtype=torch.float64, device=dev))
                Puv.append(Ruv[-1].T)
                Rp.append(torch.as_tensor(R_p, dtype=torch.float64, device=dev))
                Pp.append(Rp[-1].T)
                self.cfs.append(1)
        # one copy of each transfer matrix per shard: (uv, p) pairs
        self.Rs = [(mesh.replicate(r.contiguous()), mesh.replicate(rp.contiguous()))
                   for r, rp in zip(Ruv, Rp)]
        self.Ps = [(mesh.replicate(pu.contiguous()), mesh.replicate(pp.contiguous()))
                   for pu, pp in zip(Puv, Pp)]
        # pre/post sweep counts per level from the paramfile (the smoother
        # kind is structurally DGS here; the api warns about other kinds)
        self.cfgs = _level_smoother_cfgs(kinds, settings, pre_iters, post_iters)
        self.n_pass = smoother_passes
        # per-level color packing of the velocity stencil (any band height)
        self.a_packs = [ShardColorPack(mesh.join(d.A), mesh.join(d.A_Dinv),
                                       d.Nj // n_dev, d.Ni, mesh)
                        for d in self.data]
        # the velocity-block solve inside DGS: 'gs' (colored block GS, the
        # default) or 'chebyshev' (a polynomial on the SPD momentum block,
        # with per-level power-iteration bounds at setup)
        perf = getattr(settings, "performance", None)
        self.vel_solver = str(getattr(perf, "dgs_velocity_solver", "gs")).lower()
        self.cheb = [None] * len(levels)
        if self.vel_solver == "chebyshev":
            degree = int(getattr(perf, "dgs_velocity_chebyshev_degree", 3))
            self.cheb = [(degree, 1.1 * estimate_rho_dinv_a(l.block_A)) for l in levels]
        elif self.vel_solver != "gs":
            raise ValueError(
                f"performance.dgs_velocity_solver must be 'gs' or "
                f"'chebyshev', got {self.vel_solver!r}")

        # replicated pinned coarse inverse in [uv-interleaved; p] ordering
        c = levels[0]
        A_d = c.block_A.to_dense()
        D_d = c.block_D.to_dense()
        G_d = c.block_G.to_dense()
        n_p = c.N * c.N_DOF_sol["p"]
        Z = torch.zeros((n_p, n_p), dtype=A_d.dtype, device=A_d.device)
        Z[0, 0] = 1.0
        dense = torch.cat([torch.cat([A_d, G_d], dim=1), torch.cat([D_d, Z], dim=1)])
        self.coarse_inv = host_lu_inverse(dense).to(mesh.devices[0])

        mg = settings.solver.multigrid
        self.tol = float(mg.tolerance)
        self.max_cycles = int(mg.max_cycles)
        self.cycle_type = str(getattr(mg, "cycle_type", "V")).upper()
        if self.cycle_type not in ("V", "W", "F"):
            raise NotImplementedError(
                f"the sharded Stokes multigrid implements V, W and F, not "
                f"{self.cycle_type!r}")
        self.full_multigrid = bool(getattr(mg, "full_multigrid", False))
        self._data32 = None
        self.graphs, self._keyed = [], {}

    def _operands(self, dtype=None):
        """(level data, coarse inverse, Rs, Ps, velocity packs) in ``dtype``
        (float32 built once)."""
        ops = (self.data, self.coarse_inv, self.Rs, self.Ps, self.a_packs)
        if dtype is None or dtype == torch.float64:
            return ops
        if self._data32 is None:
            self._data32 = ([d.to(dtype) for d in self.data], self.coarse_inv.to(dtype),
                            [(_cast(r, dtype), _cast(rp, dtype)) for r, rp in self.Rs],
                            [(_cast(pu, dtype), _cast(pp, dtype)) for pu, pp in self.Ps],
                            [pk.to(dtype) for pk in self.a_packs])
        return self._data32

    # -- one cycle (host recursion over the levels) ---------------------------

    def _coarse_solve(self, coarse_inv, f_mom, f_cont):
        mesh = self.mesh
        r_uv, r_p = mesh.join(f_mom), mesh.join(f_cont)
        e = coarse_inv @ torch.cat([r_uv.reshape(-1), r_p.reshape(-1)])
        n_uv = r_uv.numel()
        return (mesh.split(e[:n_uv].reshape(r_uv.shape)),
                mesh.split(e[n_uv:].reshape(r_p.shape)))

    def _restrict_field(self, k, R, r):
        """Level k residual component -> level k-1 rhs, per band; geometric
        transfers agglomerate 2x2 element tiles first."""
        cf = self.cfs[k - 1]
        out = []
        for Rk, x in zip(R, r):
            if cf > 1:
                nj_loc, ni, B = x.shape
                x = x.reshape(nj_loc // cf, cf, ni // cf, cf, B).permute(0, 2, 1, 3, 4)
                x = x.reshape(nj_loc // cf, ni // cf, cf * cf * B)
            out.append(bmv(Rk, x))
        return out

    def _prolong_field(self, k, Pm, e_c):
        cf = self.cfs[k - 1]
        out = []
        for Pk, x in zip(Pm, e_c):
            v = bmv(Pk, x)
            if cf > 1:
                njc_loc, nic, _ = x.shape
                B = v.shape[2] // (cf * cf)
                v = v.reshape(njc_loc, nic, cf, cf, B).permute(0, 2, 1, 3, 4)
                v = v.reshape(njc_loc * cf, nic * cf, B)
            out.append(v)
        return out

    def _v_cycle(self, k, ops, f_mom, f_cont, uv, p, mode=None):
        datas, coarse_inv, Rs, Ps, apacks = ops
        mode = mode or self.cycle_type
        if k == 0:
            return self._coarse_solve(coarse_inv, f_mom, f_cont)
        data = datas[k]
        pre, post = self.cfgs[k]
        for _ in range(pre.iterations):
            uv, p = _dgs_sweep(data, f_mom, f_cont, uv, p, self.n_pass,
                               apack=apacks[k], cheb=self.cheb[k])
        r_mom, r_cont = _saddle_residual(data, f_mom, f_cont, uv, p)
        Ruv, Rp = Rs[k - 1]
        fc_mom = self._restrict_field(k, Ruv, r_mom)
        fc_cont = self._restrict_field(k, Rp, r_cont)
        e_uv, e_p = self._v_cycle(k - 1, ops, fc_mom, fc_cont, _zeros_like(fc_mom),
                                  _zeros_like(fc_cont), mode=mode)
        if mode in ("W", "F") and k - 1 > 0:
            # F revisits with a plain V (MultigridSolver.v_cycle semantics)
            e_uv, e_p = self._v_cycle(k - 1, ops, fc_mom, fc_cont, e_uv, e_p,
                                      mode="W" if mode == "W" else "V")
        Puv, Pp = Ps[k - 1]
        uv = _add(uv, self._prolong_field(k, Puv, e_uv))
        p = _add(p, self._prolong_field(k, Pp, e_p))
        for _ in range(post.iterations):
            uv, p = _dgs_sweep(data, f_mom, f_cont, uv, p, self.n_pass,
                               apack=apacks[k], cheb=self.cheb[k])
        return uv, p

    def _fmg(self, ops, f_mom, f_cont, finest_cycle=None):
        """Full-multigrid guess: restrict the saddle rhs to the coarsest
        level, solve, prolong upward with one configured cycle per level;
        the finest level's through ``finest_cycle`` where given
        (``_cycle32``)."""
        _, _, Rs, Ps, _ = ops
        n_lev = len(self.levels)
        rhss = [(f_mom, f_cont)]
        for k in range(n_lev - 1, 0, -1):
            Ruv, Rp = Rs[k - 1]
            fm, fc = rhss[-1]
            rhss.append((self._restrict_field(k, Ruv, fm), self._restrict_field(k, Rp, fc)))
        rhss = rhss[::-1]                   # coarsest first
        uv, p = self._coarse_solve(ops[1], *rhss[0])
        n = self.mesh.size
        for k in range(1, n_lev):
            Puv, Pp = Ps[k - 1]
            uv, p = self._prolong_field(k, Puv, uv), self._prolong_field(k, Pp, p)
            if k == n_lev - 1 and finest_cycle is not None:
                out = finest_cycle(*rhss[k][0], *rhss[k][1], *uv, *p)
                uv, p = list(out[:n]), list(out[n:])
            else:
                uv, p = self._v_cycle(k, ops, *rhss[k], uv, p)
        return uv, p

    def _cycle_fn(self):
        ops, n, top = self._operands(torch.float32), self.mesh.size, len(self.levels) - 1

        def cycle(*b):
            # (*f_mom, *f_cont, *uv, *p) -> (*uv, *p)
            uv, p = self._v_cycle(top, ops, list(b[:n]), list(b[n:2 * n]),
                                  list(b[2 * n:3 * n]), list(b[3 * n:]))
            return (*uv, *p)

        return cycle

    # -- host-facing API -------------------------------------------------------

    def _split_fields(self, rhs_global):
        """Global-order [all u; all v; p] vector -> bands of (Nj, Ni, 2Nu) and
        (Nj, Ni, Np)."""
        lvl = self.levels[-1]
        n, nu, npd = lvl.N, lvl.N_DOF_sol["u"], lvl.N_DOF_sol["p"]
        uv = _global_uv_to_elem(rhs_global[:2 * n * nu], n, nu)
        return (self.mesh.split(uv.reshape(self.Nj, self.Ni, 2 * nu)),
                self.mesh.split(rhs_global[2 * n * nu:].reshape(self.Nj, self.Ni, npd)))

    def _join_fields(self, uv, p):
        lvl = self.levels[-1]
        uv_g = _elem_uv_to_global(self.mesh.join(uv).reshape(-1), lvl.N, lvl.N_DOF_sol["u"])
        return torch.cat([uv_g, self.mesh.join(p).reshape(-1)])

    def solve(self, rhs_global, u0_global=None, eager=False):
        """Full-precision cycles to ``solver.multigrid.tolerance``; returns
        (u, res, n) with the residual history in ``self.history``; the
        cycles run as ``halo.solve_cycles`` (a ``LoopGraph`` on one card, a
        ``MaskedLoop`` on the CPU, the host loop across cards or with
        ``eager``, a reference for checks)."""
        ops = self._operands()
        top = self.data[-1]
        n_sh = self.mesh.size
        f_mom, f_cont = self._split_fields(rhs_global)
        if u0_global is None:
            uv, p = _zeros_like(f_mom), _zeros_like(f_cont)
        else:
            uv, p = self._split_fields(u0_global)
        r0m, r0c = _saddle_residual(top, f_mom, f_cont, uv, p)
        if self.full_multigrid:
            # FMG guess on the defect; the normalization stays ||rhs||
            e_uv, e_p = self._fmg(ops, r0m, r0c)
            uv, p = _add(uv, e_uv), _add(p, e_p)
            res0 = _pnorm_pair(f_mom, f_cont)
        else:
            res0 = _pnorm_pair(r0m, r0c)
        n_lev = len(self.levels)

        def cycle(f):
            uv, p = self._v_cycle(n_lev - 1, ops, f_mom, f_cont, f[:n_sh], f[n_sh:])
            return uv + p

        def norm(f):
            return _pnorm_pair(*_saddle_residual(top, f_mom, f_cont, f[:n_sh], f[n_sh:]))

        f, res, n, self.history = solve_cycles(cycle, norm, uv + p, res0, self.max_cycles,
                                               self.tol, self._mode(eager) != "eager")
        return self._join_fields(f[:n_sh], f[n_sh:]), res, n

    # -- mixed-precision refinement over the shards ---------------------------

    def build_refined(self, tol=1e-10, n_inner=6, max_outer=20, defect="auto",
                      inner="cycles", eager=False):
        """Sharded Stokes mixed-precision defect correction: one float64
        saddle residual per outer round (halo component matvecs), the inner
        correction as ``n_inner`` float32 sharded DGS cycles, or with
        ``inner='gmres'`` GMRES(n_inner) right-preconditioned by one sharded
        cycle (``solvers.refinement.gmres_correction`` over ``ShardVector``s
        with the mesh's psum dot and norm).  The defect is native float64
        (``defect`` 'auto' or 'f64').  On one card the cycle, the defect
        (the saddle residual, its float32 cast and its norm), the GMRES
        matvec and each arithmetic stage of the GMRES step replay as CUDA
        graphs (the preconditioner M replays the cycle's graph from zero,
        A M the cycle's and the matvec's); a round reads the norm once.
        ``eager``: the same rounds with no graph (a reference for checks).
        Returns ``solve(f_mom, f_cont, uv0, p0) -> (uv, p, res, n,
        history)``."""
        if inner not in ("cycles", "gmres"):
            raise ValueError(inner)
        _check_defect(defect)
        mode = self._mode(eager)
        n = self.mesh.size
        top64 = self.data[-1]
        ops = self._operands(torch.float32)
        f32 = torch.float32
        cycle = self._cycle32(mode)

        def defect_fn(*b):
            # (*f_mom, *f_cont, *uv, *p) -> (*r_mom32, *r_cont32, ||r||)
            rm, rc = _saddle_residual(top64, b[:n], b[n:2 * n], b[2 * n:3 * n], b[3 * n:])
            return (*_cast(rm, f32), *_cast(rc, f32), _pnorm_pair(rm, rc))

        residual = self._graph(defect_fn, mode, "defect")

        def inner_cycles(rm32, rc32):
            e = (*_zeros_like(rm32), *_zeros_like(rc32))
            for _ in range(n_inner):
                e = cycle(*rm32, *rc32, *e)
            return list(e[:n]), list(e[n:])

        def inner_gmres(rm32, rc32):
            top = ops[0][-1]
            shp_m = [x.shape for x in rm32]
            shp_c = [x.shape for x in rc32]

            def flat(am, ac):
                return ShardVector([torch.cat([m.reshape(-1), c.reshape(-1)])
                                    for m, c in zip(am, ac)])

            def unflat(x):
                ms = [v[:sm.numel()].reshape(sm) for v, sm in zip(x.parts, shp_m)]
                cs = [v[sm.numel():].reshape(sc) for v, sm, sc in
                      zip(x.parts, shp_m, shp_c)]
                return ms, cs

            def M(x):
                em, ec = unflat(x)
                out = cycle(*em, *ec, *_zeros_like(em), *_zeros_like(ec))
                return flat(out[:n], out[n:])

            def A(*parts):
                # _saddle_residual(0, 0, u, p) = -A u
                uv, p = unflat(ShardVector(parts))
                am, ac = _saddle_residual(top, _zeros_like(uv), _zeros_like(p), uv, p)
                return tuple(flat([-m for m in am], [-c for c in ac]).parts)

            matvec = self._graph(A, mode, "matvec")

            def AM(x):
                return ShardVector(list(matvec(*M(x).parts)))

            return unflat(gmres_correction(AM, M, flat(rm32, rc32), n_inner, stages=stages))

        if inner == "gmres":
            stages = gmres_stages(n_inner, dot=_dot, norm=_norm)
            if mode == "graphed":
                def graph(fn):
                    return self._graph(fn, mode, None, "refine.capture")
                start, arnoldi, finish = stages
                stages = (_over_parts(start, graph), [_over_parts(a, graph) for a in arnoldi],
                          _over_parts(finish, graph))
            inner_solve = inner_gmres
        else:
            inner_solve = inner_cycles

        def solve(f_mom, f_cont, uv, p):
            dt = f_mom[0].dtype

            def defect_of(uv, p):
                out = residual(*f_mom, *f_cont, *uv, *p)
                return list(out[:n]), list(out[n:2 * n]), out[-1]

            rm, rc, res0 = defect_of(uv, p)          # res0 stays on the device
            if self.full_multigrid:
                with trace.span("solve.fmg"):
                    duv, dp = self._fmg(ops, rm, rc, finest_cycle=cycle)
                    uv, p = _add(uv, _cast(duv, dt)), _add(p, _cast(dp, dt))
                rm, rc, _ = defect_of(uv, p)
            res, hist, k = 1.0, [], 0
            while k < max_outer and res >= tol and math.isfinite(res):
                hist.append(res)
                duv, dp = inner_solve(rm, rc)
                uv, p = _add(uv, _cast(duv, dt)), _add(p, _cast(dp, dt))
                rm, rc, norm = defect_of(uv, p)
                with trace.span("refine.wait"):
                    res = float(norm / res0)
                k += 1
            return uv, p, res, k, hist + [res]

        return solve

    def solve_refined(self, rhs_global, u0_global=None, tol=1e-10, n_inner=6,
                      max_outer=20, defect="auto", inner="cycles", eager=False):
        """Float64-accuracy sharded Stokes solve; returns (u, res, n_outer)."""
        fn = self.build_refined(tol=tol, n_inner=n_inner, max_outer=max_outer,
                                defect=defect, inner=inner, eager=eager)
        f_mom, f_cont = self._split_fields(rhs_global.to(torch.float64))
        if u0_global is None:
            uv0, p0 = _zeros_like(f_mom), _zeros_like(f_cont)
        else:
            uv0, p0 = self._split_fields(u0_global)
        uv, p, res, n, self.history = fn(f_mom, f_cont, uv0, p0)
        return self._join_fields(uv, p), res, n

    def tensors(self):
        """Every operand tensor of the cycle (for device checks)."""
        out = [t for d in self.data for t in d.tensors()]
        out += [t for pair in self.Rs + self.Ps for per in pair for t in per]
        for pk in self.a_packs:
            out += [t for part in (pk.idx, pk.off_nbr, pk.off_blocks, pk.Dinv)
                    for per in part for t in per]
        return out + [self.coarse_inv]
