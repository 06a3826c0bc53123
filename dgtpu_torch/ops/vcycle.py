"""The multigrid cycle in the rolled (cell-major) layout: the cycle for any
element grid, odd Ni included.

Port of ``dgtpu/ops/pallas_vcycle.py`` (``PallasVCycle``).  Layout, per
level::

    vectors  u     : (Nj, Ni, B)          a cell's B modes contiguous
    blocks   A     : (Nj, Ni, 5, B, B)    slots [self, iL, iR, jL, jR]
    Dinv     D     : (Nj, Ni, B, B)

i-neighbors are circular rolls along axis 1 and j-neighbors shifts with zero
halos (``ops/rolled.py``).  The mixed route runs this cycle where the SoA
cycles cannot: an odd Ni on some level (the shipped flagship with
coarsening factors 8,4,2 coarsens to 1x1), or an F-cycle on a grid past the
streaming budget.

The TPU runs the whole cycle as one Pallas kernel.  Here the host-side
recursion (:meth:`RolledVCycle._cycle`) calls four phase functions, each a
hand-written CUDA kernel for CUDA tensors (``csrc/rolled_kernels.cu`` via
``ops/_kernels.py``) and its plain torch version for CPU tensors:

    half_sweep     R1  one color of the masked red-black sweep, out of place
    stencil_apply  R2  base + sign A x  (the residual: base = rhs, sign = -1)
    transfer       R3  per-cell T x (polynomial R/P) and the 2x2 geometric
                       restriction / prolongation with the child interleave
    dense_apply    R4  the dense coarse inverse times the coarse rhs

A CUDA tensor always goes to the kernel; each wrapper counts its launches
in ``launches``.  ``RolledVCycle(reference=True)`` calls the plain versions
on any device: it is the reference the kernels are measured against.

dgtpu packs the two colors into (Nj, Ni/2) lattices when every Ni is even
(``use_split``), which halves the block traffic of a color pass of its
all-cells TPU kernel.  R1 runs one CTA per cell and reads only the active
color's blocks on any grid, so the port keeps the one masked form, which
dgtpu documents as the same math (``rolled.rb_gs_sweeps_split``).
"""

import torch

from dgtpu_torch.ops import _kernels
from dgtpu_torch.ops import rolled
from dgtpu_torch.ops.linalg import host_inv, host_lu_inverse

_CHILDREN = ((0, 0), (0, 1), (1, 0), (1, 1))   # (b, a) of child k = 2b + a


class RolledLevel:
    """One level's rolled operands: ``blocks`` (Nj, Ni, 5, B, B), ``Dinv``
    (Nj, Ni, B, B) and the float color ``masks`` (2, Nj, Ni, 1) of the plain
    path."""

    def __init__(self, blocks, Dinv, masks):
        self.blocks, self.Dinv, self.masks = blocks, Dinv, masks


# ---------------------------------------------------------------------------
# plain torch versions (CPU path, and the on-card reference)
# ---------------------------------------------------------------------------

def half_sweep_plain(lv, rhs, u, color, base=None):
    out = rolled.rb_half_sweep_masked(lv.blocks, lv.Dinv, rhs, u, lv.masks[color])
    return out if base is None else base + out


def stencil_apply_plain(lv, x, base=None, sign=1.0):
    y = rolled.matvec(lv.blocks, x)
    y = y if sign == 1.0 else sign * y
    return y if base is None else base + y


def tile_restrict(r, R4):
    """(2 nj_c, 2 ni_c, B) x (4, B_c, B) -> (nj_c, ni_c, B_c): the sum of
    the four per-child products (``_tile_restrict``)."""
    nj, ni, B = r.shape
    v = r.reshape(nj // 2, 2, ni // 2, 2, B)
    acc = None
    for k, (b, a) in enumerate(_CHILDREN):
        part = torch.matmul(v[:, b, :, a, :], R4[k].T)
        acc = part if acc is None else acc + part
    return acc


def tile_prolong(e, P4):
    """(nj_c, ni_c, B_c) x (4, B, B_c) -> (2 nj_c, 2 ni_c, B) with the child
    interleave (``_tile_prolong``)."""
    nj_c, ni_c, _ = e.shape
    ch = [torch.matmul(e, P4[k].T) for k in range(4)]           # (b, a) order
    rows = [torch.stack([ch[2 * b], ch[2 * b + 1]], dim=2) for b in (0, 1)]
    return torch.stack(rows, dim=1).reshape(2 * nj_c, 2 * ni_c, P4.shape[1])


def transfer_plain(T, x, restrict=False, base=None):
    if T.dim() == 2:
        out = torch.matmul(x, T.T)
    else:
        out = tile_restrict(x, T) if restrict else tile_prolong(x, T)
    return out if base is None else base + out


def dense_apply_plain(W, x):
    return torch.mv(W, x.reshape(-1)).reshape(x.shape)


# ---------------------------------------------------------------------------
# the wrappers: the CUDA kernel for CUDA tensors, the plain version otherwise
# ---------------------------------------------------------------------------

def half_sweep(lv, rhs, u, color, base=None):
    """R1: the cells with (i + j) % 2 == ``color`` take ``Dinv (rhs - sum_s
    A[s] nbr_s(u))`` from the pre-update ``u``; returns a new (Nj, Ni, B)
    with the other cells unchanged, plus ``base`` when given."""
    if not u.is_cuda:
        return half_sweep_plain(lv, rhs, u, color, base)
    out = _kernels.rolled_half_sweep(lv.blocks, lv.Dinv, rhs, u, color, base)
    half_sweep.launches += 1
    return out


def stencil_apply(lv, x, base=None, sign=1.0):
    """R2: ``base + sign * A x`` over all cells.  The residual ``rhs - A u``
    is ``stencil_apply(lv, u, rhs, -1.0)``."""
    if not x.is_cuda:
        return stencil_apply_plain(lv, x, base, sign)
    out = _kernels.rolled_stencil_apply(lv.blocks, x, base, sign)
    stencil_apply.launches += 1
    return out


def transfer(T, x, restrict=False, base=None):
    """R3: ``(base +) T x`` per cell for T (B_out, B_in); for per-child
    T (4, B_out, B_in) the 2x2 restriction (fine -> coarse) when
    ``restrict``, else the prolongation (coarse -> fine, ``(base +)``):
    child (b, a) of coarse cell (jc, ic) is fine cell (2 jc + b, 2 ic + a),
    with matrix k = 2b + a."""
    if not x.is_cuda:
        return transfer_plain(T, x, restrict, base)
    out = _kernels.rolled_transfer(T, x, restrict, base)
    transfer.launches += 1
    return out


def dense_apply(W, x):
    """R4: ``W x`` for the dense (M, M) coarse inverse and the coarse rhs
    (Nj, Ni, B), M = Nj Ni B."""
    if not x.is_cuda:
        return dense_apply_plain(W, x)
    out = _kernels.rolled_dense_apply(W, x)
    dense_apply.launches += 1
    return out


KERNELS = (half_sweep, stencil_apply, transfer, dense_apply)
PLAIN = {half_sweep: half_sweep_plain, stencil_apply: stencil_apply_plain,
         transfer: transfer_plain, dense_apply: dense_apply_plain}


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


reset_launch_counts()


# ---------------------------------------------------------------------------
# the cycle
# ---------------------------------------------------------------------------

class RolledVCycle:
    """Multigrid V/W/F cycle in the rolled layout.

    ``ops``: per-level StencilOperators (coarsest first), ``transfers[k]``
    between levels k and k+1 with ``types[k]`` naming its coarsening node,
    ``dims``: [(Nj, Ni)] per level, any sizes.  The operands are cast to
    ``dtype`` and live on ``device`` (default: the operators' device).  The
    coarse level follows ``coarse_grid_solver``: 'smoother' -> 20 red-black
    half-sweep pairs, 'direct'/'amg' -> the cached dense inverse.
    """

    def __init__(self, ops, transfers, types, settings, dims,
                 dtype=torch.float32, device=None, reference=False):
        self.types = list(types)
        self.transfers = list(transfers)
        self.dtype = dtype
        self.device = torch.device(device) if device is not None \
            else ops[-1].blocks.device
        self.n_lev = len(ops)
        self.dims = [tuple(d) for d in dims]
        # whether dgtpu would pack the colors (an even Ni on every level);
        # the port's cycle is the same either way
        self.use_split = all(ni % 2 == 0 for _, ni in self.dims)
        mg = settings.solver.multigrid
        self.cycle_type = str(getattr(mg, "cycle_type", "V")).upper()
        if self.cycle_type not in ("V", "W", "F"):
            raise NotImplementedError(
                f"the rolled cycle implements V, W and F, not {self.cycle_type!r}")
        self.coarse_solver = mg.coarse_grid_solver
        self._cfg = {}
        for t in set(self.types):
            node = getattr(mg, f"{t}_coarsening")
            self._cfg[t] = (int(node.pre_smoother.iterations),
                            int(node.post_smoother.iterations))
        self._half_sweep, self._stencil, self._transfer, self._dense = (
            [PLAIN[k] for k in KERNELS] if reference else KERNELS)

        self.levels = []
        for op, (nj, ni) in zip(ops, self.dims):
            blocks = self._cast(rolled.to_rolled(op, ni, nj))
            # the diagonal-block inverse in the cycle's dtype, on the host
            self.levels.append(RolledLevel(
                blocks, host_inv(blocks[:, :, 0]).contiguous(),
                rolled.color_masks(nj, ni, dtype, self.device)))
        # geometric transfers per child: R (4, B_c, B), P (4, B, B_c)
        self.R, self.P = [], []
        for t in self.transfers:
            if t.kind == "geometric":
                B = t.R.shape[1] // 4
                self.R.append(self._cast(torch.stack(
                    [t.R[:, k * B:(k + 1) * B] for k in range(4)])))
                self.P.append(self._cast(torch.stack(
                    [t.P[k * B:(k + 1) * B, :] for k in range(4)])))
            elif t.kind == "polynomial":
                self.R.append(self._cast(t.R))
                self.P.append(self._cast(t.P))
            elif t.kind == "penalty":
                self.R.append(None)
                self.P.append(None)
            else:
                raise ValueError(f"the rolled cycle has no {t.kind!r} transfer")
        # the coarse dense inverse (M, M) in cell-major order: dgtpu keeps
        # the same numbers column-blocked as (M0, Nj0, Ni0, B0, B0)
        self.coarse_inv = (
            self._cast(host_lu_inverse(ops[0].to_dense().to(torch.float64)))
            if self.coarse_solver in ("direct", "amg") else None)

    def _cast(self, x):
        return x.to(device=self.device, dtype=self.dtype).contiguous()

    def device_bytes(self):
        """Bytes of the device tensors this cycle holds: per level the blocks,
        diagonal inverses and color masks, per transfer R and P, and the
        coarse inverse.  A cycle reads each of them at least once."""
        held = [t for lv in self.levels for t in (lv.blocks, lv.Dinv, lv.masks)]
        held += [t for t in (*self.R, *self.P, self.coarse_inv) if t is not None]
        return sum(t.numel() * t.element_size() for t in held)

    # -- cycle phases --------------------------------------------------------

    def _smooth(self, k, rhs, u, n_pass):
        lv = self.levels[k]
        for _ in range(n_pass):
            u = self._half_sweep(lv, rhs, u, 0)
            u = self._half_sweep(lv, rhs, u, 1)
        return u

    def _restrict(self, k, r):
        if self.R[k] is None:
            return r
        return self._transfer(self.R[k], r, restrict=True)

    def _prolong(self, k, e, base=None):
        """P e (+ base): the prolonged correction, added to ``base``."""
        if self.P[k] is None:
            return e if base is None else base + e
        return self._transfer(self.P[k], e, base=base)

    def _coarse_solve(self, rhs, u):
        if self.coarse_inv is None:
            # 10 iterations of the pre-smoother (solver.py:199-204 semantics)
            return self._smooth(0, rhs, u, 20)
        return self._dense(self.coarse_inv, rhs)

    def _cycle(self, k, rhs, u, mode=None):
        mode = mode or self.cycle_type
        if k == 0:
            return self._coarse_solve(rhs, u)
        pre, post = self._cfg[self.types[k - 1]]
        u = self._smooth(k, rhs, u, 2 * pre)
        r = self._stencil(self.levels[k], u, base=rhs, sign=-1.0)
        rc = self._restrict(k - 1, r)
        ec = self._cycle(k - 1, rc, torch.zeros_like(rc), mode=mode)
        if mode in ("W", "F") and k - 1 > 0:
            # F revisits with a plain V (MultigridSolver.v_cycle semantics)
            ec = self._cycle(k - 1, rc, ec, mode="W" if mode == "W" else "V")
        u = self._prolong(k - 1, ec, base=u)
        return self._smooth(k, rhs, u, 2 * post)

    def _fmg(self, rhs, skip_finest=False):
        """Full-multigrid (nested-iteration) guess in the rolled layout:
        restrict the rhs to the coarsest level, solve, then prolong upward
        with one configured cycle per level (``PallasVCycle._fmg``).  With
        ``skip_finest`` only the prolonged finest-level guess is returned."""
        rhss = [rhs]
        for k in range(self.n_lev - 1, 0, -1):
            rhss.append(self._restrict(k - 1, rhss[-1]))
        rhss = rhss[::-1]                       # coarsest first
        u = self._coarse_solve(rhss[0], torch.zeros_like(rhss[0]))
        for k in range(1, self.n_lev):
            u = self._prolong(k - 1, u)
            if skip_finest and k == self.n_lev - 1:
                return u
            u = self._cycle(k, rhss[k], u)
        return u

    # -- public entry points -------------------------------------------------

    def _to_rolled(self, v):
        nj, ni = self.dims[-1]
        return v.to(device=self.device, dtype=self.dtype).reshape(nj, ni, -1).contiguous()

    def __call__(self, rhs, u):
        """One cycle on flat finest-level vectors (N*B,); returns ``dtype``."""
        return self._cycle(self.n_lev - 1, self._to_rolled(rhs),
                           self._to_rolled(u)).reshape(-1)

    def build_fmg(self, finest_cycle=None):
        """fmg(rhs) -> u0, the FMG guess.  ``finest_cycle``: a cycle
        ``(rhs, u) -> u`` run in place of the finest level's cycle."""
        # n_lev == 1: there is no finest-level cycle to replace
        skip = finest_cycle is not None and self.n_lev > 1

        def fmg(rhs):
            r = rhs.to(self.dtype)
            u = self._fmg(self._to_rolled(r), skip_finest=skip).reshape(-1)
            return finest_cycle(r, u) if skip else u

        return fmg
