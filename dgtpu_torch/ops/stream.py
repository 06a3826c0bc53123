"""Streamed smoother / residual / matvec per level and the hybrid Poisson
cycle for hierarchies whose finest levels outgrow the card's L2 cache.

Port of ``dgtpu/ops/pallas_stream.py`` (``StreamedLevel``,
``StreamedVCycle``).  The TPU streams a level's blocks HBM -> VMEM chunk by
chunk inside one ``pallas_call`` per smoother application, because the fused
cycle holds every operand in VMEM.  Here every kernel reads device memory
anyway, so the hybrid keeps what the TPU design buys on this card:

    multi_half_sweep  K7  all n half-sweeps of one smoother application in
                          ONE launch (StreamedLevel.half_sweeps,
                          pallas_stream.py:315): ~2 launches instead of 12 K1
                          on the finest level of a 64x64 p5 V-cycle, each
                          half-sweep K1's cluster body on K1's grid
    block storage         bfloat16 sweep blocks (and optionally residual
                          blocks), upconverted per MAC: half the bytes of the
                          finest level's sweeps

The residual and the matvec are K5 (``ops.soa.stencil_apply``, float32 or
bfloat16 blocks); ``matvec_color`` has no kernel of its own: the streamed
Stokes DG pass runs it fused into K6 (``ops/stokes_stream.py``).  Transfers
stay in the SoA layout (K3/K4 through ``ops.soa.SoAHierarchy``), so no
rolled round trip is made at any level.

Not ported, being TPU DMA schedules around the same math: ``_pick_chunk``
and the chunked grid, the ``ph`` zero-halo padding, the VMEM-resident /
streamed split of the sweep operand, ``_sweep_operand_bytes`` and the VMEM
limits.

The hybrid's cut is dgtpu's rule (pallas_stream.py:570-588) with the port's
own count: the deepest prefix of levels whose ``SoAVCycle.device_bytes``
fits ``budget`` runs as the SoA cycle, the finest level always streams.
"""

import torch

from dgtpu_torch.ops import _kernels, rolled, soa
from dgtpu_torch.ops.linalg import host_inv
from dgtpu_torch.ops.soa import (SoAHierarchy, SoALevel, SoAVCycle, _mac, _off,
                                 is_periodic, lane_masks, soa_blocks, soa_diag)

BF16 = ("bfloat16", "bf16")


# ---------------------------------------------------------------------------
# K7: the plain version and the wrapper
# ---------------------------------------------------------------------------

def multi_half_sweep_plain(lv, blocks, Dinv, rhs, u, n_half, base=None):
    o = None if u is None else u[1]
    out = [None, None]
    for h in range(n_half):
        c = h % 2
        t = rhs[c] if o is None else rhs[c] - _off(blocks[c], o, c, lv)
        out[c] = _mac(Dinv[c], t)
        o = out[c]
    out = torch.stack(out)
    return out if base is None else base + out


def multi_half_sweep(lv, blocks, Dinv, rhs, u, n_half, base=None, clusters=None):
    """K7: ``n_half`` red-black half-sweeps (colors 0, 1, 0, ...)
    ``u_c <- Dinv_c (rhs_c - sum_s blocks_c[s] nbr_s(u_{1-c}))`` from ``u``
    (None: zero) in one launch; returns the new (2, B, C), plus ``base`` when
    given.  ``blocks`` (2, 5, B, B, C) (slots 1..4 read) and ``Dinv``
    (2, B, B, C) are float32 or bfloat16, upconverted per MAC; ``lv`` gives
    the lattice (masks, nh, periodic).  ``clusters``: the grid on the card in
    thread-block clusters (default one per 32 cells, at most the resident
    count)."""
    if not rhs.is_cuda:
        return multi_half_sweep_plain(lv, blocks, Dinv, rhs, u, n_half, base)
    out = _kernels.multi_half_sweep(blocks, Dinv, rhs, u, n_half, lv.nh, lv.periodic,
                                    base, clusters)
    multi_half_sweep.launches += 1
    return out


KERNELS = (multi_half_sweep,)
PLAIN = {multi_half_sweep: multi_half_sweep_plain}


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


reset_launch_counts()


def _narrow(storage, dtype):
    """Whether ``storage`` narrows this cycle's blocks to bfloat16: only a
    float32 cycle's, as in dgtpu."""
    return storage in BF16 and dtype == torch.float32


# ---------------------------------------------------------------------------
# one streamed level
# ---------------------------------------------------------------------------

class StreamedLevel:
    """Streamed smoother / residual / matvec for one stencil (StencilOperator
    ``op`` on an (nj, ni) lattice) in the SoA layout.

    Two operands, as in dgtpu:

    * the residual / matvec operand ``res`` (2, 5, B_src, B_dst, C)
      [diag, iL, iR, jL, jR], float32, or bfloat16 with
      ``res_storage='bfloat16'``;
    * the sweep operand (square blocks only; a rectangular stencil, Stokes
      G or D, has none and only multiplies): the 4 off-diagonal slots and
      Dinv.  In float32 it shares the off-diagonal slots with ``res`` (the
      SoA cycle's blocks + Dinv); with ``block_storage='bfloat16'`` it is
      one bfloat16 tensor (2, 5, B, B, C) [Dinv, iL, iR, jL, jR].

    Dinv is inverted in float64 on the host, then cast (dgtpu's
    StreamedLevel).  Narrowing applies to a float32 level only.  Each
    method returns a function, as dgtpu's do; on CUDA tensors they launch
    K7 / K5, on CPU tensors (or with ``reference=True``) the plain versions.
    """

    def __init__(self, op, nj, ni, dtype=torch.float32, device=None,
                 block_storage=None, res_storage=None, reference=False):
        if ni % 2:
            raise ValueError("StreamedLevel needs an even Ni")
        self.dtype = dtype
        self.device = torch.device(device) if device is not None else op.blocks.device
        rb = rolled.to_rolled(op, ni, nj)                 # (nj, ni, 5, B_dst, B_src)
        self.B_dst, self.B_src = rb.shape[-2:]
        with_dinv = self.B_dst == self.B_src
        cast = self._cast
        blocks = cast(soa_blocks(rb))
        Dinv = cast(soa_diag(host_inv(rb[:, :, 0]))) if with_dinv else None
        res = blocks.to(torch.bfloat16) if _narrow(res_storage, dtype) else blocks
        self.lv = SoALevel(res, Dinv, lane_masks(nj, ni, dtype, self.device), nj, ni,
                           is_periodic(op, ni))
        self.C, self.periodic = nj * (ni // 2), self.lv.periodic
        self.sweep = None
        if with_dinv:
            if _narrow(block_storage, dtype):
                S = torch.cat([Dinv[:, None], blocks[:, 1:]], dim=1).to(torch.bfloat16)
                self.sweep = (S, S[:, 0])
            else:
                self.sweep = (blocks, Dinv)
        if reference:
            self._k7, self._stencil = multi_half_sweep_plain, soa.stencil_apply_plain
        else:
            self._k7, self._stencil = multi_half_sweep, soa.stencil_apply

    def _cast(self, x):
        return x.to(device=self.device, dtype=self.dtype).contiguous()

    @property
    def res(self):
        return self.lv.blocks

    def half_sweeps(self, n_half):
        """fn(rhs01, u01, base=None) running ``n_half`` red-black
        half-sweeps from u01 (None: zero) in one K7 launch."""
        if self.sweep is None:
            raise ValueError("half_sweeps needs the diagonal inverse")
        if n_half < 2 or n_half % 2:
            raise ValueError("half-sweeps come in red/black pairs")
        blocks, Dinv = self.sweep

        def fn(rhs01, u01, base=None):
            return self._k7(self.lv, blocks, Dinv, rhs01, u01, n_half, base)

        return fn

    def residual(self):
        """fn(rhs01, u01) -> rhs01 - A u01, both colors (K5)."""
        def fn(rhs01, u01):
            return self._stencil(self.lv, self.res, u01, rhs01, -1.0)

        return fn

    def matvec(self):
        """fn(x01) -> A x01, both colors, square or rectangular (K5)."""
        def fn(x01):
            return self._stencil(self.lv, self.res, x01)

        return fn

    def matvec_color(self, color):
        """fn(x01) -> (A x01)[color], reading only that color's blocks.  The
        plain version only: on the card the streamed Stokes DG pass runs it
        fused into K6 (``ops.stokes_stream``), its only caller in dgtpu."""
        c = int(color)

        def fn(x01):
            blk = self.res[c]
            return _mac(blk[0], x01[c]) + _off(blk, x01[1 - c], c, self.lv)

        return fn


# ---------------------------------------------------------------------------
# the hybrid cycle
# ---------------------------------------------------------------------------

def cut_level(fits, n_lev, what):
    """dgtpu's cut (pallas_stream.py:570-588): the deepest prefix k < n_lev
    with ``fits(k)``; the finest level always streams."""
    cut = 0
    for k in range(1, n_lev):
        if not fits(k):
            break
        cut = k
    if cut < 1:
        raise ValueError(f"even the coarsest {what} level exceeds the budget")
    return cut


class StreamedVCycle(SoAHierarchy):
    """Hybrid Poisson V/W cycle: levels below ``cut`` run as the SoA cycle
    (``ops.soa.SoAVCycle``), levels from ``cut`` up smooth with K7 and take
    their residual with K5 on the streamed operands.  ``budget``: device
    bytes (the API passes the card's L2 size) that the SoA subtree's
    ``SoAVCycle.device_bytes`` must fit.  ``block_storage`` (default
    ``performance.block_storage``) 'bfloat16' narrows the streamed sweep
    blocks and runs the smoother in defect form; ``res_storage`` narrows the
    residual blocks (constructor only, as in dgtpu).  Interface as
    SoAVCycle: ``cycle(rhs, u)``, ``build_fmg``."""

    def __init__(self, ops, transfers, types, settings, dims, budget,
                 dtype=torch.float32, device=None, block_storage=None,
                 res_storage=None, reference=False):
        if block_storage is None:
            block_storage = str(getattr(getattr(settings, "performance", None),
                                        "block_storage", "float32"))
        self.block_storage, self.res_storage = block_storage, res_storage
        self.defect = block_storage in BF16
        self.dtype = dtype
        self.device = torch.device(device) if device is not None \
            else ops[-1].blocks.device
        self.dims = [tuple(d) for d in dims]
        self.transfers, self.types = list(transfers), list(types)
        self.n_lev = len(ops)
        self.cycle_type = str(getattr(settings.solver.multigrid,
                                      "cycle_type", "V")).upper()
        if self.cycle_type not in ("V", "W"):
            raise NotImplementedError(
                f"the streamed hybrid implements V and W, not {self.cycle_type!r}")
        with_coarse = settings.solver.multigrid.coarse_grid_solver in ("direct", "amg")
        self.cut = cut_level(lambda k: SoAVCycle.device_bytes(
            ops[:k], self.dims[:k], self.transfers[:k - 1], dtype, with_coarse) <= budget,
            self.n_lev, "Poisson")
        cut = self.cut
        self.sub = SoAVCycle(ops[:cut], self.transfers[:cut - 1], self.types[:cut - 1],
                             settings, self.dims[:cut], dtype=dtype, device=self.device,
                             reference=reference)
        self.streams = {k: StreamedLevel(ops[k], *self.dims[k], dtype=dtype,
                                         device=self.device, block_storage=block_storage,
                                         res_storage=res_storage, reference=reference)
                        for k in range(cut, self.n_lev)}
        self._cfg = {}
        for t in set(self.types):
            node = getattr(settings.solver.multigrid, f"{t}_coarsening")
            self._cfg[t] = (int(node.pre_smoother.iterations),
                            int(node.post_smoother.iterations))
        self._gemm, self._geo = (soa.PLAIN[k] if reference else k
                                 for k in (soa.small_gemm, soa.geo_transfer))
        self._pack_transfers()
        self._pack_parity()
        self._kern = {}

    def _level_kernels(self, k):
        if k not in self._kern:
            s = self.streams[k]
            pre, post = self._cfg[self.types[k - 1]]
            self._kern[k] = (s.half_sweeps(4 * pre), s.half_sweeps(4 * post),
                             s.residual())
        return self._kern[k]

    def _smooth(self, fn, res_fn, rhs, u, zero_guess):
        """One smoother application (pallas_stream.py:656-671).  Direct form
        ``fn(rhs, u)`` in float32 storage; with bfloat16 storage the defect
        form ``u + fn(rhs - A u, 0)``, so the narrowed blocks only ever see
        the float32 residual and the cycle's fixed point is untouched; the
        addition rides on K7's ``base``.  ``zero_guess``: u is identically
        zero (a first coarse visit), so the residual is rhs and K7 starts
        from zero without reading u."""
        if not self.defect:
            return fn(rhs, None if zero_guess else u)
        if zero_guess:
            return fn(rhs, None)
        return fn(res_fn(rhs, u), None, base=u)

    def _cycle(self, k, rhs, u, zero_guess=False):
        """rhs / u: (2, B, C) at level k."""
        if k < self.cut:
            return self.sub._cycle(k, rhs, u)
        pre_fn, post_fn, res_fn = self._level_kernels(k)
        u = self._smooth(pre_fn, res_fn, rhs, u, zero_guess)
        rc = self._restrict(k - 1, res_fn(rhs, u))
        ec = self._cycle(k - 1, rc, torch.zeros_like(rc), zero_guess=True)
        if self.cycle_type == "W" and k - 1 > 0:
            # revisit the coarse level; at the subtree boundary this re-runs
            # the whole SoA sub-cycle from the first visit's result, so every
            # level is visited twice as in SoAVCycle (the coarsest level
            # itself is never revisited)
            ec = self._cycle(k - 1, rc, ec)
        u = self._prolong(k - 1, ec, base=u)
        return self._smooth(post_fn, res_fn, rhs, u, zero_guess=False)

    def _fmg(self, rhs):
        """FMG guess (pallas_stream.py:767-799): restrict the rhs down to the
        subtree's top level, the subtree's own FMG there, then one cycle per
        streamed level on the way up."""
        rhss = [rhs]
        for k in range(self.n_lev - 1, self.cut - 1, -1):
            rhss.append(self._restrict(k - 1, rhss[-1]))
        u = self.sub._fmg(rhss[-1])
        for k, r in zip(range(self.cut, self.n_lev), rhss[-2::-1]):
            u = self._cycle(k, r, self._prolong(k - 1, u))
        return u

    def __call__(self, rhs, u):
        """One cycle on flat finest-level vectors (N*B,); returns ``dtype``."""
        return self.from_soa(self._cycle(self.n_lev - 1, self.to_soa(rhs),
                                         self.to_soa(u)))

    def build_fmg(self, finest_cycle=None):
        """fmg(rhs) -> u0.  ``finest_cycle`` is accepted for the SoA cycle's
        interface and ignored, as in dgtpu: the finest level's FMG cycle is
        the hybrid's own."""
        del finest_cycle

        def fmg(rhs):
            return self.from_soa(self._fmg(self.to_soa(rhs)))

        return fmg

    def bytes_per_cycle(self):
        """Operator bytes the kernels of ONE cycle read (the counterpart of
        dgtpu's hbm_bytes_per_cycle, pallas_stream.py:702-749, without tile
        padding): blocks as stored, once per kernel that reads them -- a
        half-sweep one color's four off-diagonal slots and Dinv (Dinv alone
        when it starts from zero), a residual both colors' five slots, a
        transfer its matrix, the coarse solve the dense inverse or 40
        half-sweeps.  Vectors are not counted (under 2% at 64x64 p5)."""
        def nb(t):
            return 0 if t is None else t.numel() * t.element_size()

        def operands(k):
            if k >= self.cut:
                s = self.streams[k]
                return (*s.sweep, s.res, True)
            lv = self.sub.levels[k]
            return lv.blocks, lv.Dinv, lv.blocks, False

        def visit(k, zero):
            blocks, Dinv, res, streamed = operands(k)
            half, off = nb(blocks[0, 1:]) + nb(Dinv[0]), nb(blocks[0, 1:])
            if k == 0:
                return nb(self.sub.coarse_W) if self.sub.coarse_W is not None \
                    else 40 * half
            cfg = self._cfg if streamed else self.sub._cfg
            pre, post = cfg[self.types[k - 1]]
            total = nb(res) + nb(self.R[k - 1]) + nb(self.P[k - 1])
            for n_half, z in ((4 * pre, zero), (4 * post, False)):
                if streamed and self.defect:
                    total += n_half * half - off + (0 if z else nb(res))
                else:
                    total += n_half * half - (off if streamed and z else 0)
            total += visit(k - 1, True)
            if self.cycle_type == "W" and k - 1 > 0:
                total += visit(k - 1, False)
            return total

        return visit(self.n_lev - 1, False)
