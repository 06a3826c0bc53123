"""Structure-of-arrays multigrid cycle: cells in the contiguous axis.

Port of ``dgtpu/ops/pallas_soa.py`` (``SoAVCycle``) together with what
``PallasVCycle.__init__`` prepares for it (``pallas_vcycle.py:79-144``).
Layout, per level::

    vectors  u              : (2, B, C)          color, mode, cell;  C = Nj * Ni/2
    blocks   A              : (2, 5, B, B, C)    color, slot, b_src, b_dst, cell
    Dinv     D              : (2, B, B, C)       color, b_src, b_dst, cell

Neighbor fields are lane shifts of the opposite color's lattice (the
color-split scheme of ``ops/rolled.py``): i-neighbors are -/+1 lanes picked
by the row parity (row-crossing garbage lands on zero boundary blocks; the
O-grid wrap takes an explicit two-roll blend), j-neighbors -/+(Ni/2) lanes.

The TPU runs the whole cycle as one Pallas kernel.  Here the host-side
recursion (:meth:`SoAVCycle._cycle`, the port of ``_soa_cycle``) calls four
phase functions, each a hand-written CUDA kernel for CUDA tensors
(``csrc/soa_kernels.cu`` via ``ops/_kernels.py``) and its plain torch version
for CPU tensors:

    half_sweep     K1  one red-black half-sweep       (_soa_smooth body)
    stencil_apply  K5  base + sign A x, both colors;  (_soa_residual with
                       rectangular blocks              base = rhs, sign = -1)
    small_gemm     K3  out (+)= W x                    (polynomial R/P, u += P e,
                                                        dense coarse inverse)
    geo_transfer   K4  2x2 agglomeration R / P         (geometric R/P)

The Stokes cycle (``ops/stokes_soa.py``) launches the same four and K6.

A CUDA tensor always goes to the kernel; each wrapper counts its launches
in ``launches``.  ``SoAVCycle(reference=True)`` calls the plain versions on
any device: it is the reference the kernels are measured against.
"""

import functools

import numpy as np
import torch

from dgtpu_torch.ops import _kernels
from dgtpu_torch.ops import rolled
from dgtpu_torch.ops.linalg import host_inv, host_lu_inverse

_CHILDREN = ((0, 0), (0, 1), (1, 0), (1, 1))  # (dj, di); per-child R/P order


def _packed_pos(j, i):
    """(color, packed ip) of cell (j, i) under the color-split layout."""
    c = (i + j) % 2
    ip = (i - (j % 2)) // 2 if c == 0 else (i - 1 + (j % 2)) // 2
    return c, ip


class SoALevel:
    """One level's SoA operands: ``blocks`` (2, 5, B, B, C), ``Dinv``
    (2, B, B, C), the float lane ``masks`` (3, 1, C) = [even row, row start,
    row end] of the plain path, and the lattice geometry."""

    def __init__(self, blocks, Dinv, masks, nj, ni, periodic):
        self.blocks, self.Dinv, self.masks = blocks, Dinv, masks
        self.nj, self.ni, self.periodic = nj, ni, periodic
        self.nh = ni // 2


# ---------------------------------------------------------------------------
# host-side packing (pallas_soa.py:204-236)
# ---------------------------------------------------------------------------

def soa_blocks(rb):
    """Rolled stencil blocks (nj, ni, 5, B_dst, B_src) -> per-color SoA
    (2, 5, B_src, B_dst, C)."""
    nj, ni, _, bd, bs = rb.shape
    pair, _ = rolled.pack_operator_colors(rb)
    return torch.stack([x.permute(2, 4, 3, 0, 1).reshape(5, bs, bd, nj * (ni // 2))
                        for x in pair])


def soa_diag(D):
    """Per-cell matrices (nj, ni, a, b) -> per-color SoA (2, b, a, C), the
    layout of Dinv."""
    nj, ni, a, b = D.shape
    _, pair = rolled.pack_operator_colors(D.new_zeros(nj, ni, 5, 1, 1), D)
    return torch.stack([x.permute(3, 2, 0, 1).reshape(b, a, nj * (ni // 2))
                        for x in pair])


def lane_masks(nj, ni, dtype, device):
    """(3, 1, C) float lane masks [even row, row start, row end]."""
    nh = ni // 2
    lanes_j = np.repeat(np.arange(nj), nh)
    lanes_ip = np.tile(np.arange(nh), nj)
    masks = np.stack([lanes_j % 2 == 0, lanes_ip == 0, lanes_ip == nh - 1])
    return torch.as_tensor(masks[:, None, :], dtype=dtype, device=device)


def is_periodic(op, ni):
    """Whether the lattice wraps in i (an O-grid): cell 0's iL neighbor is
    the row's last cell."""
    nbr = op.nbr.cpu().numpy()
    msk = op.mask.cpu().numpy()
    return bool(ni > 1 and msk[0, 1] and nbr[0, 1] == ni - 1)


# ---------------------------------------------------------------------------
# plain torch versions (CPU path, and the on-card reference)
# ---------------------------------------------------------------------------

def _mac(blk, f):
    """sum_b blk[b] * f[b] for blk (B_src, B_dst, C), f (B_src, C); blocks
    stored narrower than ``f`` (bfloat16) are upconverted first."""
    return torch.einsum("bac,bc->ac", blk.to(f.dtype), f)


def _nbr_fields(o, color, masks, nh, periodic):
    """(iL, iR, jL, jR) neighbor fields of ``color`` cells, read from the
    opposite color's lattice o (B, C) — SoAVCycle._nbr_fields."""
    me, mrs, mre = masks[0], masks[1], masks[2]
    roll_p = torch.roll(o, 1, dims=1)
    roll_m = torch.roll(o, -1, dims=1)
    if periodic:
        roll_p = (1.0 - mrs) * roll_p + mrs * torch.roll(o, 1 - nh, dims=1)
        roll_m = (1.0 - mre) * roll_m + mre * torch.roll(o, nh - 1, dims=1)
    if color == 0:
        iL = me * roll_p + (1.0 - me) * o
        iR = me * o + (1.0 - me) * roll_m
    else:
        iL = me * o + (1.0 - me) * roll_p
        iR = me * roll_m + (1.0 - me) * o
    jL = torch.roll(o, nh, dims=1)
    jR = torch.roll(o, -nh, dims=1)
    return iL, iR, jL, jR


def _off(blk, o, color, lv):
    fields = _nbr_fields(o, color, lv.masks, lv.nh, lv.periodic)
    acc = _mac(blk[1], fields[0])
    for s in range(1, 4):
        acc = acc + _mac(blk[s + 1], fields[s])
    return acc


def half_sweep_plain(lv, rhs, u, color, base=None):
    o = u[1 - color]
    new = _mac(lv.Dinv[color], rhs[color] - _off(lv.blocks[color], o, color, lv))
    out = torch.stack([new, o] if color == 0 else [o, new])
    return out if base is None else base + out


def stencil_apply_plain(lv, blk, x, base=None, sign=1.0):
    y = torch.stack([_mac(blk[c, 0], x[c]) + _off(blk[c], x[1 - c], c, lv)
                     for c in (0, 1)])
    y = y if sign == 1.0 else sign * y
    return y if base is None else base + y


def small_gemm_plain(W, x, base=None):
    out = torch.matmul(W, x)
    return out if base is None else base + out


@functools.lru_cache(maxsize=64)
def _geo_maps(njc, nic):
    """Host index maps of the 2x2 agglomeration between the coarse lattice
    (njc, nic) and its fine lattice (2 njc, 2 nic), both color-split:
    children[cc, k, q] = (color, lane) of coarse cell (cc, q)'s child k, and
    parent[cf, p] = (color, lane, child index) of fine cell (cf, p)."""
    nhc, nhf = nic // 2, nic
    Cc, Cf = njc * nhc, 2 * njc * nhf
    ch_c = np.zeros((2, 4, Cc), np.int64)
    ch_q = np.zeros((2, 4, Cc), np.int64)
    par = np.zeros((3, 2, Cf), np.int64)
    for jc in range(njc):
        for ic in range(nic):
            cc, ipc = _packed_pos(jc, ic)
            q = jc * nhc + ipc
            for kk, (dj, di) in enumerate(_CHILDREN):
                jf, i_f = 2 * jc + dj, 2 * ic + di
                cf, ipf = _packed_pos(jf, i_f)
                p = jf * nhf + ipf
                ch_c[cc, kk, q], ch_q[cc, kk, q] = cf, p
                par[:, cf, p] = (cc, q, kk)
    return ch_c, ch_q, par


def geo_transfer_plain(T4, x, dims_c, restrict, base=None):
    ch_c, ch_q, par = (torch.as_tensor(a, device=x.device)
                       for a in _geo_maps(*dims_c))
    if restrict:
        g = x[ch_c, :, ch_q]                              # (2, 4, Cc, B)
        return torch.einsum("kab,ckqb->caq", T4, g)
    g = x[par[0], :, par[1]]                              # (2, Cf, B_c)
    out = torch.einsum("cpab,cpb->cap", T4[par[2]], g)
    return out if base is None else base + out


# ---------------------------------------------------------------------------
# the wrappers: the CUDA kernel for CUDA tensors, the plain version otherwise
# ---------------------------------------------------------------------------

def half_sweep(lv, rhs, u, color, base=None):
    """K1: ``u[color] <- Dinv_c (rhs_c - sum_s A_c[s] nbr_s(u[1-color]))``;
    returns a new (2, B, C) with the other color unchanged, plus ``base``
    (2, B, C) when given."""
    if not u.is_cuda:
        return half_sweep_plain(lv, rhs, u, color, base)
    out = _kernels.half_sweep(lv.blocks, lv.Dinv, rhs, u, color, lv.nh,
                              lv.periodic, base)
    half_sweep.launches += 1
    return out


def stencil_apply(lv, blk, x, base=None, sign=1.0):
    """K5: ``base + sign * (blk_c[0] x_c + sum_s blk_c[s] nbr_s(x_{1-c}))``
    for both colors; ``blk`` (2, 5, B_src, B_dst, C) is a stencil on ``lv``'s
    lattice, ``x`` (2, B_src, C), ``base`` (2, B_dst, C) or None.  The
    residual ``rhs - A u`` is ``stencil_apply(lv, lv.blocks, u, rhs, -1.0)``."""
    if not x.is_cuda:
        return stencil_apply_plain(lv, blk, x, base, sign)
    out = _kernels.stencil_apply(blk, x, lv.nh, lv.periodic, base, sign)
    stencil_apply.launches += 1
    return out


def small_gemm(W, x, base=None):
    """K3: ``(base +) W (M, K) @ x (batch, K, N)``."""
    if not x.is_cuda:
        return small_gemm_plain(W, x, base)
    out = _kernels.small_gemm(W, x, base)
    small_gemm.launches += 1
    return out


def geo_transfer(T4, x, dims_c, restrict, base=None):
    """K4: 2x2 geometric restriction (fine -> coarse) with ``T4 = R4``
    (4, B_c, B), or prolongation (coarse -> fine, ``(base +)``) with
    ``T4 = P4`` (4, B, B_c); ``dims_c`` = (Nj, Ni) of the coarse level."""
    if not x.is_cuda:
        return geo_transfer_plain(T4, x, dims_c, restrict, base)
    out = _kernels.geo_transfer(T4, x, dims_c, restrict, base)
    geo_transfer.launches += 1
    return out


KERNELS = (half_sweep, stencil_apply, small_gemm, geo_transfer)
PLAIN = {half_sweep: half_sweep_plain, stencil_apply: stencil_apply_plain,
         small_gemm: small_gemm_plain, geo_transfer: geo_transfer_plain}


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


reset_launch_counts()


# ---------------------------------------------------------------------------
# the cycle
# ---------------------------------------------------------------------------

class SoAHierarchy:
    """What the SoA cycle and the streamed hybrid (``ops/stream.py``) share:
    the cast to the cycle's dtype and device, the transfers between levels
    (polynomial R (B_c, B) / P (B, B_c) as matrices for K3, geometric
    per-child R4 (4, B_c, B) / P4 (4, B, B_c) for K4, pallas_vcycle.py:132-143)
    and the finest level's layout conversion.  A subclass sets ``dims``,
    ``dtype``, ``device``, ``transfers`` and the ``_gemm``/``_geo`` phase
    functions."""

    def _cast(self, x):
        return x.to(device=self.device, dtype=self.dtype).contiguous()

    def _pack_transfers(self):
        self.R, self.P = [], []
        for t in self.transfers:
            if t.kind == "geometric":
                B = t.R.shape[1] // 4
                R4 = torch.stack([t.R[:, k * B:(k + 1) * B] for k in range(4)])
                P4 = torch.stack([t.P[k * B:(k + 1) * B, :] for k in range(4)])
                self.R.append(self._cast(R4))
                self.P.append(self._cast(P4))
            elif t.kind == "polynomial":
                self.R.append(self._cast(t.R))
                self.P.append(self._cast(t.P))
            elif t.kind == "penalty":
                self.R.append(None)
                self.P.append(None)
            else:
                raise ValueError(f"the SoA cycle has no {t.kind!r} transfer")

    def _restrict(self, k, r):
        kind = self.transfers[k].kind
        if kind == "penalty":
            return r
        if kind == "polynomial":
            return self._gemm(self.R[k], r)
        return self._geo(self.R[k], r, self.dims[k], True)

    def _prolong(self, k, e, base=None):
        """P e (+ base): the prolonged correction, added to ``base``."""
        kind = self.transfers[k].kind
        if kind == "penalty":
            return e if base is None else base + e
        if kind == "polynomial":
            return self._gemm(self.P[k], e, base)
        return self._geo(self.P[k], e, self.dims[k], False, base)

    def _pack_parity(self):
        """The finest level's row-parity mask ``even`` (Nj, 1, 1), built once
        on the cycle's device: ``to_soa`` / ``from_soa`` run inside a
        captured cycle (``ops/graphs.py``), where a host copy is refused."""
        self.even = rolled.parity_mask(self.dims[-1][0], self.dtype, self.device)

    def to_soa(self, v):
        """(N*B,) -> (2, B, C) color lattices in the cycle's dtype."""
        nj, ni = self.dims[-1]
        B = v.numel() // (nj * ni)
        v = v.to(device=self.device, dtype=self.dtype).reshape(nj, ni, B)
        u0, u1 = rolled.pack_colors(v, self.even)
        return torch.stack([u0.reshape(-1, B).T, u1.reshape(-1, B).T]).contiguous()

    def from_soa(self, u):
        nj, ni = self.dims[-1]
        B = u.shape[1]
        a = u[0].T.reshape(nj, ni // 2, B)
        b = u[1].T.reshape(nj, ni // 2, B)
        return rolled.unpack_colors(a, b, self.even).reshape(-1)


class SoAVCycle(SoAHierarchy):
    """Multigrid V/W/F cycle in the cells-in-lanes layout.

    ``ops``: per-level StencilOperators (coarsest first), ``transfers[k]``
    between levels k and k+1 with ``types[k]`` naming its coarsening node,
    ``dims``: [(Nj, Ni)] per level.  Needs an even Ni on every level (the
    color-split condition).  The operands are cast to ``dtype`` and live on
    ``device`` (default: the operators' device).  The coarse level follows
    ``coarse_grid_solver``: 'smoother' -> 20 red-black passes,
    'direct'/'amg' -> the cached dense inverse.
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
        if any(ni % 2 for _, ni in self.dims):
            raise ValueError("SoAVCycle needs an even Ni on every level")
        self.cycle_type = str(getattr(settings.solver.multigrid,
                                      "cycle_type", "V")).upper()
        if self.cycle_type not in ("V", "W", "F"):
            raise NotImplementedError(
                f"the SoA cycle implements V, W and F, not {self.cycle_type!r}")
        self.coarse_solver = settings.solver.multigrid.coarse_grid_solver
        self._cfg = {}
        for t in set(self.types):
            node = getattr(settings.solver.multigrid, f"{t}_coarsening")
            self._cfg[t] = (int(node.pre_smoother.iterations),
                            int(node.post_smoother.iterations))
        if reference:
            self._half_sweep, self._stencil, self._gemm, self._geo = (
                PLAIN[k] for k in KERNELS)
        else:
            self._half_sweep, self._stencil, self._gemm, self._geo = KERNELS

        self.levels = [self._pack_level(op, nj, ni)
                       for op, (nj, ni) in zip(ops, self.dims)]
        self._pack_transfers()
        self._pack_parity()
        self.coarse_W = (self._coarse_matrix(ops[0])
                         if self.coarse_solver in ("direct", "amg") else None)

    @staticmethod
    def device_bytes(ops, dims, transfers, dtype=torch.float32, with_coarse=True):
        """Bytes of the device tensors a cycle over this hierarchy holds,
        from the shapes alone: per level the blocks (2, 5, B, B, C), Dinv
        (2, B, B, C) and masks (3, 1, C); per transfer R and P (per child for
        a geometric one); with ``with_coarse`` the dense coarse inverse
        (M, M), M = N0 B0.  The streamed hybrid's cut rule reads it."""
        count = 0
        for op, (nj, ni) in zip(ops, dims):
            B = op.blocks.shape[-1]
            count += (2 * 5 * B * B + 2 * B * B + 3) * nj * (ni // 2)
        for k, t in enumerate(transfers):
            children = {"geometric": 4, "polynomial": 1}.get(t.kind, 0)
            count += 2 * children * ops[k].blocks.shape[-1] * ops[k + 1].blocks.shape[-1]
        if with_coarse and ops:
            M = dims[0][0] * dims[0][1] * ops[0].blocks.shape[-1]
            count += M * M
        return count * torch.empty((), dtype=dtype).element_size()

    def _pack_level(self, op, nj, ni):
        blocks = self._cast(rolled.to_rolled(op, ni, nj))     # (nj, ni, 5, B, B)
        # the diagonal-block inverse in the cycle's dtype, on the host
        Dinv = host_inv(blocks[:, :, 0])
        return SoALevel(soa_blocks(blocks).contiguous(), soa_diag(Dinv).contiguous(),
                        lane_masks(nj, ni, self.dtype, self.device), nj, ni,
                        is_periodic(op, ni))

    def _coarse_matrix(self, op):
        """The coarsest level's dense inverse permuted to the flattened SoA
        vector order (color, mode, lane): W (M, M), M = 2 B0 C0."""
        nj0, ni0 = self.dims[0]
        nh0 = ni0 // 2
        C0 = nj0 * nh0
        B0 = op.blocks.shape[-1]
        inv = host_lu_inverse(op.to_dense().to(torch.float64))
        perm = np.zeros(nj0 * ni0 * B0, np.int64)
        for j in range(nj0):
            for i in range(ni0):
                c, ip = _packed_pos(j, i)
                m = j * ni0 + i
                perm[m * B0:(m + 1) * B0] = c * B0 * C0 + np.arange(B0) * C0 \
                    + j * nh0 + ip
        perm = torch.as_tensor(perm, device=inv.device)
        W = torch.zeros_like(inv)
        W[perm[:, None], perm[None, :]] = inv
        return self._cast(W)

    @property
    def periodic(self):
        return [lv.periodic for lv in self.levels]

    # -- cycle phases --------------------------------------------------------

    def _smooth(self, k, rhs, u, n_pass):
        lv = self.levels[k]
        for _ in range(n_pass):
            u = self._half_sweep(lv, rhs, u, 0)
            u = self._half_sweep(lv, rhs, u, 1)
        return u

    def _coarse_solve(self, rhs, u):
        if self.coarse_W is None:
            return self._smooth(0, rhs, u, 20)
        return self._gemm(self.coarse_W, rhs.reshape(1, -1, 1)).reshape(rhs.shape)

    def _cycle(self, k, rhs, u, mode=None):
        mode = mode or self.cycle_type
        if k == 0:
            return self._coarse_solve(rhs, u)
        pre, post = self._cfg[self.types[k - 1]]
        u = self._smooth(k, rhs, u, 2 * pre)
        lv = self.levels[k]
        r = self._stencil(lv, lv.blocks, u, base=rhs, sign=-1.0)
        rc = self._restrict(k - 1, r)
        ec = self._cycle(k - 1, rc, torch.zeros_like(rc), mode=mode)
        if mode in ("W", "F") and k - 1 > 0:
            # F revisits with a plain V (MultigridSolver.v_cycle semantics)
            ec = self._cycle(k - 1, rc, ec, mode="W" if mode == "W" else "V")
        u = self._prolong(k - 1, ec, base=u)
        return self._smooth(k, rhs, u, 2 * post)

    def _fmg(self, rhs, skip_finest=False):
        """Full-multigrid (nested-iteration) guess in the SoA layout:
        restrict the rhs to the coarsest level, solve, then prolong upward
        with one configured cycle per level (SoAVCycle._soa_fmg).  With
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

    def __call__(self, rhs, u):
        """One cycle on flat finest-level vectors (N*B,); returns ``dtype``."""
        v = self._cycle(self.n_lev - 1, self.to_soa(rhs), self.to_soa(u))
        return self.from_soa(v)

    def build_fmg(self, finest_cycle=None):
        """fmg(rhs) -> u0, the FMG guess.  ``finest_cycle``: a cycle
        ``(rhs, u) -> u`` run in place of the finest level's cycle."""
        skip = finest_cycle is not None and self.n_lev > 1

        def fmg(rhs):
            r = rhs.to(self.dtype)
            u = self.from_soa(self._fmg(self.to_soa(r), skip_finest=skip))
            return finest_cycle(r, u) if skip else u

        return fmg
