"""Sharded Poisson multigrid: element-row bands over a list of devices with a
one-row halo exchange (port of ``dgtpu/parallel/halo.py``).

The element grid is decomposed along j: shard k owns a contiguous band of
element rows.  The only communication in the math is the nearest-neighbor
face coupling of the 5-point block stencil, a one-row halo exchange; the
p-/penalty transfers are element-local and the 2x2 geometric agglomeration
is shard-local when every shard owns whole coarse rows.

dgtpu runs its shards as one ``shard_map`` program over a device mesh.  The
port keeps that single-controller form: one process holds a ``ShardMesh``,
an ordered list of devices (one per shard), and every sharded field is a
list of bands, band k on device k.  The halo rows move by a copy from one
band to the next (a same-device copy when one card holds several shards, a
peer copy across cards); ``psum`` is a sum on the first shard's device and
``all_gather`` a concatenation there.  Every shard-local step is plain
torch, as dgtpu's are ``jnp`` ops (no Pallas kernel runs on dgtpu's
sharded path).

Data layout per level (band k of each):

    blocks : (Nj_loc, Ni, 5, B, B)   stencil slots [self, iL, iR, jL, jR]
    vecs   : (Nj_loc, Ni, B)

i-direction neighbors are rolls inside a band (exact for the O-grid wrap;
the wrapped blocks are zero on Dirichlet grids).  The smoothers are
red-black colored, dgtpu's documented parallel deviation from the
reference's lexicographic sweeps.
"""

import collections

import numpy as np
import torch

from dgtpu_torch.ops.linalg import host_inv, host_lu_inverse
from dgtpu_torch.ops.rolled import bmv
from dgtpu_torch.ops.smoothers import SMOOTHER_ALIASES, estimate_rho_dinv_a
from dgtpu_torch.solvers.multigrid import SmootherConfig

# halo exchanges made, by the device type of the bands ('cuda' or 'cpu'):
# a run on the card shows that its halo rows stayed on the card
EXCHANGES = collections.Counter()


class ShardMesh:
    """An ordered list of devices, one per shard (dgtpu's 1D ``Mesh``)."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]

    @property
    def size(self):
        return len(self.devices)

    @property
    def cards(self):
        """The distinct devices the shards sit on."""
        return list(dict.fromkeys(self.devices))

    def split(self, grid):
        """(Nj, ...) tensor -> its bands of Nj / size rows, band k on device k."""
        return [b.to(d) for b, d in zip(torch.chunk(grid, self.size), self.devices)]

    def replicate(self, t):
        """One copy of ``t`` per shard (one transfer per distinct device)."""
        copies = {d: t.to(d) for d in self.cards}
        return [copies[d] for d in self.devices]

    def join(self, bands):
        """The bands concatenated on the first shard's device."""
        return torch.cat([b.to(self.devices[0]) for b in bands])


def make_mesh(n_shards, device="cuda"):
    """A ``ShardMesh`` of ``n_shards`` shards.  On ``cuda`` shard k goes to
    card k modulo the visible cards (one card holds every shard, four cards
    one each); on ``cpu`` every shard is the CPU.  Unlike dgtpu, which
    refuses fewer devices than shards, several shards may share a card."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but CUDA is not available")
        n_cards = torch.cuda.device_count()
        base = device.index or 0
        return ShardMesh([torch.device("cuda", (base + k) % n_cards)
                          for k in range(n_shards)])
    return ShardMesh([device] * n_shards)


def reshape_level(op, Ni, Nj):
    """StencilOperator -> j-banded layout (Nj, Ni, 5, B, B)."""
    n, s, br, bc = op.blocks.shape
    assert n == Ni * Nj and s == 5
    return op.blocks.reshape(Nj, Ni, 5, br, bc)


def vec_to_grid(v, Ni, Nj, B):
    return v.reshape(Nj, Ni, B)


def grid_to_vec(g):
    return g.reshape(-1)


# -- shard-local steps (each takes the list of bands) ------------------------


def _halo_exchange(u):
    """The j-neighbor boundary rows of each band: per shard (row above, row
    below), each (Ni, B) on the shard's device; zeros at the physical ends
    of the mesh (the matching stencil blocks are zero there)."""
    out = []
    for k, band in enumerate(u):
        up = u[k - 1][-1].to(band.device) if k > 0 else torch.zeros_like(band[0])
        down = (u[k + 1][0].to(band.device) if k < len(u) - 1
                else torch.zeros_like(band[0]))
        out.append((up, down))
        EXCHANGES[band.device.type] += 1
    return out


def _neighbors(u, up, down):
    """(iL, iR, jL, jR) neighbor fields of one band given its halo rows."""
    return (torch.roll(u, 1, dims=1), torch.roll(u, -1, dims=1),
            torch.cat([up[None], u[:-1]]), torch.cat([u[1:], down[None]]))


def _local_matvec(blocks, u, halo_up, halo_down):
    """Stencil matvec on one band given its j-halos."""
    out = bmv(blocks[:, :, 0], u)
    for s, f in enumerate(_neighbors(u, halo_up, halo_down), start=1):
        out = out + bmv(blocks[:, :, s], f)
    return out


def _matvec_with_halo(blocks, u):
    return [_local_matvec(b, x, up, dn)
            for b, x, (up, dn) in zip(blocks, u, _halo_exchange(u))]


def _local_offdiag(blocks, u):
    out = []
    for b, x, (up, dn) in zip(blocks, u, _halo_exchange(u)):
        iL, iR, jL, jR = _neighbors(x, up, dn)
        acc = bmv(b[:, :, 1], iL)
        for s, f in ((2, iR), (3, jL), (4, jR)):
            acc = acc + bmv(b[:, :, s], f)
        out.append(acc)
    return out


def _rb_gs_sweep(blocks, Dinv, rhs, u, colors, omega=1.0, n_pass=2):
    """Red-black block-GS passes; ``colors`` per band (Nj_loc, Ni) 0/1."""
    for _ in range(n_pass):
        for c in (0, 1):
            off = _local_offdiag(blocks, u)
            u = [torch.where((col == c)[:, :, None],
                             omega * bmv(d, r - o) + (1 - omega) * x, x)
                 for d, r, o, x, col in zip(Dinv, rhs, off, u, colors)]
    return u


class ShardColorPack:
    """Per-color packed off-diagonal data for the sharded red-black sweep
    (dgtpu's ``ShardColorPack``): each color pass reads only its own rows'
    off-diagonal blocks.  Index sets are built per shard (the checkerboard
    phase flips between shards when a band has an odd number of rows) and
    padded to a common count with entries that write into a scratch slot
    with a zero Dinv.  ``idx``, ``off_nbr``, ``off_blocks`` (per cell the
    four off-diagonal blocks side by side, (B, 4 B)) and ``Dinv`` are per
    color a list over shards, band k's on device k."""

    def __init__(self, blocks, Dinv, nj_loc, Ni, mesh):
        blocks = torch.as_tensor(blocks).cpu().numpy()    # (Nj, Ni, 5, B, B)
        Dinv = torch.as_tensor(Dinv).cpu().numpy()
        n_dev = blocks.shape[0] // nj_loc
        B = blocks.shape[-1]
        scratch = nj_loc * Ni                 # one past the end of the band
        lj, li = np.meshgrid(np.arange(nj_loc), np.arange(Ni), indexing="ij")
        b6 = blocks.reshape(n_dev, nj_loc, Ni, 5, B, B)
        d6 = Dinv.reshape(n_dev, nj_loc, Ni, B, B)
        self.idx, self.safe, self.off_nbr, self.off_blocks, self.Dinv = \
            [], [], [], [], []
        for c in (0, 1):
            per_shard = []
            for s in range(n_dev):
                # global checkerboard color of local cell (lj, li) on shard s
                sel = ((s * nj_loc + lj + li) % 2) == c
                per_shard.append((lj[sel], li[sel]))
            nc = max(len(a) for a, _ in per_shard)
            idx = np.full((n_dev, nc), scratch, dtype=np.int64)
            nbr = np.zeros((n_dev, nc, 4), dtype=np.int64)
            ob = np.zeros((n_dev, nc, 4, B, B), dtype=blocks.dtype)
            dv = np.zeros((n_dev, nc, B, B), dtype=Dinv.dtype)
            for s, (ljc, lic) in enumerate(per_shard):
                m = len(ljc)
                idx[s, :m] = ljc * Ni + lic
                # neighbors in the (nj_loc + 2, Ni) extended band (row 0 the
                # halo above, row nj_loc + 1 the halo below); i wraps
                iL = (ljc + 1) * Ni + (lic - 1) % Ni
                iR = (ljc + 1) * Ni + (lic + 1) % Ni
                jL = ljc * Ni + lic
                jR = (ljc + 2) * Ni + lic
                nbr[s, :m] = np.stack([iL, iR, jL, jR], axis=1)
                ob[s, :m] = b6[s, ljc, lic, 1:]
                dv[s, :m] = d6[s, ljc, lic]
            dev = mesh.devices
            self.idx.append([torch.as_tensor(idx[s], device=dev[s]) for s in range(n_dev)])
            # padded entries read a cell in range (their write is discarded)
            self.safe.append([torch.as_tensor(np.minimum(idx[s], scratch - 1),
                                              device=dev[s]) for s in range(n_dev)])
            self.off_nbr.append([torch.as_tensor(nbr[s], device=dev[s])
                                 for s in range(n_dev)])
            # (nc, B, 4 B): the four off-diagonal blocks side by side, so a
            # color pass is one batched mat-vec over the stacked neighbors
            ob = ob.transpose(0, 1, 3, 2, 4).reshape(n_dev, nc, B, 4 * B)
            self.off_blocks.append([torch.as_tensor(ob[s], device=dev[s])
                                    for s in range(n_dev)])
            self.Dinv.append([torch.as_tensor(dv[s], device=dev[s]) for s in range(n_dev)])

    def to(self, dtype):
        """A copy with the blocks in ``dtype`` (the index sets shared)."""
        out = object.__new__(ShardColorPack)
        out.idx, out.safe, out.off_nbr = self.idx, self.safe, self.off_nbr
        out.off_blocks = [[b.to(dtype) for b in per] for per in self.off_blocks]
        out.Dinv = [[d.to(dtype) for d in per] for per in self.Dinv]
        return out


def _rb_gs_sweep_packed(pack, rhs, u, omega=1.0, n_pass=2):
    """Color-packed sharded sweep; halos refreshed before each color pass.
    Padded entries carry a zero Dinv and write into the scratch slot past
    the band, so they are no-ops whatever omega is."""
    for _ in range(n_pass):
        for c in (0, 1):
            new = []
            for k, (x, r, (up, dn)) in enumerate(zip(u, rhs, _halo_exchange(u))):
                nj_loc, ni, B = x.shape
                idx, safe = pack.idx[c][k], pack.safe[c][k]
                u_ext = torch.cat([up[None], x, dn[None]]).reshape(-1, B)
                nbr = pack.off_nbr[c][k]
                # bmv, not einsum: on the card einsum's rounding changed with
                # the band height, which moved L2(u) between shard counts
                off = bmv(pack.off_blocks[c][k], u_ext[nbr].reshape(nbr.shape[0], -1))
                x_flat = x.reshape(-1, B)
                unew = bmv(pack.Dinv[c][k], r.reshape(-1, B)[safe] - off)
                unew = omega * unew + (1 - omega) * x_flat[safe]
                u_pad = torch.cat([x_flat, x_flat.new_zeros(1, B)])
                u_pad[idx] = unew
                new.append(u_pad[:-1].reshape(nj_loc, ni, B))
            u = new
    return u


def _block_jacobi_sweep(blocks, Dinv, rhs, u, omega=0.8):
    off = _local_offdiag(blocks, u)
    return [omega * bmv(d, r - o) + (1 - omega) * x
            for d, r, o, x in zip(Dinv, rhs, off, u)]


def _chebyshev_sweep(blocks, Dinv, rhs, u, degree, eig_max, eig_ratio=0.3):
    """Chebyshev polynomial smoother over the shards: ``degree`` halo
    matvecs and batched block solves, no color passes.  Mathematically
    ``ops.smoothers.chebyshev`` (the halo matvec is the global matvec).
    ``eig_max`` is required: the setup-time power-iteration bound."""
    if eig_max is None:
        raise ValueError("chebyshev needs an eig_max bound "
                         "(estimate_rho_dinv_a at setup)")
    lmax = eig_max
    lmin = eig_ratio * lmax
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma = theta / delta

    def prec_residual(x):
        return [bmv(d, r - ax) for d, r, ax in zip(Dinv, rhs, _matvec_with_halo(blocks, x))]

    d = [z / theta for z in prec_residual(u)]
    u = [x + e for x, e in zip(u, d)]
    rho = 1.0 / sigma
    for _ in range(int(degree) - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        z = prec_residual(u)
        d = [(rho_new * rho) * e + (2.0 * rho_new / delta) * zz for e, zz in zip(d, z)]
        u = [x + e for x, e in zip(u, d)]
        rho = rho_new
    return u


def _psum(values):
    """Sum of per-shard scalars on the first shard's device."""
    first = values[0].device
    total = values[0]
    for v in values[1:]:
        total = total + v.to(first)
    return total


def _pnorm2(x):
    """Global size-normalized L2 norm across shards (a tensor on the first
    shard's device)."""
    s = _psum([torch.sum(b * b) for b in x])
    return torch.sqrt(s / sum(b.numel() for b in x))


def _sub(a, b):
    return [x - y for x, y in zip(a, b)]


def _add(a, b):
    return [x + y for x, y in zip(a, b)]


def _cast(bands, dtype):
    return [b.to(dtype) for b in bands]


def _zeros_like(bands):
    return [torch.zeros_like(b) for b in bands]


def _gather_solve(mesh, coarse_inv, bands):
    """Replicated dense solve: gather the bands on the first shard's device,
    apply the inverse, hand each shard its rows back (dgtpu's all_gather +
    dynamic_slice)."""
    full = mesh.join(bands)
    e = (coarse_inv @ full.reshape(-1)).reshape(full.shape)
    return mesh.split(e)


def _check_defect(defect):
    """The port's defect is native float64: 'auto' and 'f64' both mean it."""
    if defect == "df32":
        raise ValueError(
            "defect='df32' is not ported: the H100 computes float64 natively, so "
            "the port's defect is plain float64 (ROADMAP \"Not ported\", ops/df32.py)")
    if defect not in ("auto", "f64"):
        raise ValueError(f"defect must be 'auto', 'f64' or 'df32', got {defect!r}")


_KIND_TO_NODE = {"penalty": "penalty_parameter_coarsening",
                 "polynomial": "polynomial_coarsening",
                 "geometric": "geometric_coarsening",
                 # the FVM coarse level and its agglomerated sublevels are
                 # children of geometric coarsening (the api's hierarchy)
                 "dg_to_fvm": "geometric_coarsening",
                 "geometric_fvm": "geometric_coarsening"}


def shardable_device_counts(levels):
    """Shard counts every level's Nj divides over (for error messages)."""
    njs = [l.Nj for l in levels]
    top = min(njs)
    return [d for d in range(1, top + 1) if all(nj % d == 0 for nj in njs)]


def _level_smoother_cfgs(transfer_kinds, settings, pre_iters=None, post_iters=None):
    """Per-level (pre, post) SmootherConfig pairs from the paramfile.  Level
    k > 0 smooths with the configs of the coarsening type beneath it
    (transfer k-1), like the single-device MultigridSolver; optional pre/post
    iteration overrides apply to every level."""
    cfgs = [None]                     # level 0 smooths only as coarse solver
    for kind in transfer_kinds:
        node = getattr(settings.solver.multigrid, _KIND_TO_NODE[kind])
        pre = SmootherConfig.from_settings(node.pre_smoother)
        post = SmootherConfig.from_settings(node.post_smoother)
        if pre_iters is not None:
            pre.iterations = int(pre_iters)
        if post_iters is not None:
            post.iterations = int(post_iters)
        cfgs.append((pre, post))
    return cfgs


class _Data:
    """The cycle's per-shard operands in one dtype: per level lists over
    shards of the blocks, their diagonal inverses, the colors and the color
    packs; per transfer R (per cell for dg->fvm with a row scale) and P per
    shard; the replicated coarse inverse on the first shard's device."""

    def __init__(self, blocks, Dinv, colors, coarse_inv, packs, Rs, Ps):
        self.blocks, self.Dinv, self.colors = blocks, Dinv, colors
        self.coarse_inv, self.packs, self.Rs, self.Ps = coarse_inv, packs, Rs, Ps

    def to(self, dtype):
        def cast(levels):
            return [[t.to(dtype) for t in per] for per in levels]
        return _Data(cast(self.blocks), cast(self.Dinv), self.colors,
                     self.coarse_inv.to(dtype), [p.to(dtype) for p in self.packs],
                     cast(self.Rs), cast(self.Ps))

    def tensors(self):
        """Every operand tensor (for device checks)."""
        out = [t for lvl in (self.blocks, self.Dinv, self.colors, self.Rs, self.Ps)
               for per in lvl for t in per]
        for p in self.packs:
            out += [t for part in (p.idx, p.off_nbr, p.off_blocks, p.Dinv)
                    for per in part for t in per]
        return out + [self.coarse_inv]


class ShardedMultigrid:
    """Sharded Poisson multigrid over a ``ShardMesh`` (dgtpu's
    ``ShardedMultigrid``).

    p-/penalty coarsening (element-local transfers), geometric (h)
    coarsening (the 2x2 agglomeration is shard-local because each shard owns
    whole coarse-element rows) and the FVM levels (dg->fvm per cell, the
    4x4 -> 2x2 cell tiles shard-local).  Smoother kind, direction,
    iterations and relaxation factor come from the per-coarsening paramfile
    nodes; Gauss-Seidel names run red-black, Jacobi names damped block
    Jacobi, chebyshev the polynomial smoother.  The coarsest level follows
    ``coarse grid solver``: direct/amg = one replicated dense solve per
    visit, smoother = 10 sweeps of the lowest pre-smoother.
    """

    def __init__(self, levels, transfers, settings, mesh=None, pre_iters=None,
                 post_iters=None):
        self.mesh = mesh if mesh is not None else make_mesh(
            1, levels[-1].op.blocks.device)
        n_dev = self.mesh.size
        self.dims = [(l.Ni, l.Nj) for l in levels]
        self.Ni, self.Nj = self.dims[-1]
        for (ni, nj) in self.dims:
            if nj % n_dev:
                ok = shardable_device_counts(levels)
                raise ValueError(
                    f"level with Nj={nj} element rows does not divide over "
                    f"{n_dev} devices; with this hierarchy "
                    f"(Nj per level: {[d[1] for d in self.dims]}) the usable "
                    f"device counts are {ok}")
        for t in transfers:
            if t.kind not in ("polynomial", "penalty", "geometric", "dg_to_fvm",
                              "geometric_fvm"):
                raise NotImplementedError(
                    "sharded multigrid supports p/penalty/geometric/FVM "
                    f"transfers (got {t.kind})")
        self.levels = levels
        self.transfer_meta = [(t.kind, getattr(t, "cf_f", 1), getattr(t, "cf_c", 1))
                              for t in transfers]
        # tiled transfers are shard-local only if every shard owns whole
        # tiles on both sides
        for k, (kind, cf_f, cf_c) in enumerate(self.transfer_meta):
            nj_f = self.dims[k + 1][1]
            nj_c = self.dims[k][1]
            if (nj_f // n_dev) % cf_f or (nj_c // n_dev) % cf_c:
                raise ValueError(
                    f"{kind} transfer tiles ({cf_f}->{cf_c} rows) do not "
                    f"align with {n_dev} devices "
                    f"(local rows: fine {nj_f // n_dev}, coarse {nj_c // n_dev})")
        self.cfgs = _level_smoother_cfgs([t.kind for t in transfers], settings,
                                         pre_iters, post_iters)
        for pair in self.cfgs[1:]:
            for cfg in pair:
                if SMOOTHER_ALIASES[cfg.name] not in ("gs", "gs_rb", "jacobi", "cheby"):
                    raise ValueError(
                        f"smoother {cfg.name!r} is not supported in sharded "
                        "mode (Gauss-Seidel, Jacobi and Chebyshev only)")
        mesh = self.mesh
        blocks = [reshape_level(l.op, ni, nj) for l, (ni, nj) in zip(levels, self.dims)]
        Dinv = [host_inv(b[:, :, 0]) for b in blocks]
        self.coarse_solver = str(settings.solver.multigrid.coarse_grid_solver)

        def uses_cheby(k):
            # level 0 needs a bound only when the coarse solve smooths with
            # cfgs[1]'s pre-smoother
            if k == 0:
                return (self.coarse_solver not in ("direct", "amg") and
                        SMOOTHER_ALIASES[self.cfgs[1][0].name] == "cheby")
            return any(SMOOTHER_ALIASES[cfg.name] == "cheby" for cfg in self.cfgs[k])

        # Chebyshev interval bounds: rho(D^-1 A) is global, so estimated once
        # on the whole (unsharded) operator
        self.eig_max = [1.1 * estimate_rho_dinv_a(l.op) if uses_cheby(k) else None
                        for k, l in enumerate(levels)]
        packs = [ShardColorPack(b, d, nj // n_dev, ni, mesh)
                 for (ni, nj), b, d in zip(self.dims, blocks, Dinv)]
        # the dg->fvm restriction's per-cell residual scale folded into a
        # per-cell R, so it shards with the rows
        Rs = []
        for k, t in enumerate(transfers):
            if t.kind == "dg_to_fvm" and getattr(t, "row_scale", None) is not None:
                ni_c, nj_c = self.dims[k]
                sc = t.row_scale.reshape(nj_c, ni_c)
                Rs.append(mesh.split(sc[:, :, None, None] * t.R[None, None]))
            else:
                Rs.append(mesh.replicate(t.R))
        Ps = [mesh.replicate(t.P) for t in transfers]
        first = mesh.devices[0]
        dtype = blocks[-1].dtype
        if self.coarse_solver in ("direct", "amg"):
            # the single-device collapse: a cached dense inverse beats an AMG
            # setup on the small coarsest system
            coarse_inv = host_lu_inverse(levels[0].op.to_dense()).to(first)
        else:
            coarse_inv = torch.zeros((1, 1), dtype=dtype, device=first)
        colors = []
        for (ni, nj) in self.dims:
            i = torch.arange(ni)[None, :]
            j = torch.arange(nj)[:, None]
            colors.append(mesh.split(((i + j) % 2).to(torch.int32)))
        self.data = _Data([mesh.split(b) for b in blocks], [mesh.split(d) for d in Dinv],
                          colors, coarse_inv, packs, Rs, Ps)
        self._data32 = None
        mg = settings.solver.multigrid
        self.tol = float(mg.tolerance)
        self.max_cycles = int(mg.max_cycles)
        self.cycle_type = str(getattr(mg, "cycle_type", "V")).upper()
        if self.cycle_type not in ("V", "W", "F"):
            raise NotImplementedError(
                f"the sharded multigrid implements V, W and F, not {self.cycle_type!r}")
        self.full_multigrid = bool(getattr(mg, "full_multigrid", False))

    def data32(self):
        """Float32 casts of the cycle operands (built once)."""
        if self._data32 is None:
            self._data32 = self.data.to(torch.float32)
        return self._data32

    def _restrict(self, k, R, r):
        """Level k residual -> level k-1 rhs, on one band."""
        kind, cf_f, cf_c = self.transfer_meta[k - 1]
        if kind == "geometric":
            cf = cf_f
            nj_loc, ni, B = r.shape
            rows = r.reshape(nj_loc // cf, cf, ni // cf, cf, B)
            rows = rows.permute(0, 2, 1, 3, 4).reshape(nj_loc // cf, ni // cf, cf * cf * B)
            return bmv(R, rows)
        if kind == "geometric_fvm":
            # cf_f x cf_f fine cells -> cf_c x cf_c coarse cells per tile
            nj_loc, ni, B = r.shape
            njt, nit = nj_loc // cf_f, ni // cf_f
            rows = r.reshape(njt, cf_f, nit, cf_f, B)
            rows = rows.permute(0, 2, 1, 3, 4).reshape(njt, nit, cf_f * cf_f * B)
            out = bmv(R, rows)
            out = out.reshape(njt, nit, cf_c, cf_c, B).permute(0, 2, 1, 3, 4)
            return out.reshape(njt * cf_c, nit * cf_c, B)
        return bmv(R, r)               # per element (per cell R for dg->fvm)

    def _prolong(self, k, Pm, e_c):
        """Level k-1 correction -> level k, on one band."""
        kind, cf_f, cf_c = self.transfer_meta[k - 1]
        if kind == "geometric_fvm":
            njc_loc, nic, B = e_c.shape
            njt, nit = njc_loc // cf_c, nic // cf_c
            rows = e_c.reshape(njt, cf_c, nit, cf_c, B)
            rows = rows.permute(0, 2, 1, 3, 4).reshape(njt, nit, cf_c * cf_c * B)
            v = bmv(Pm, rows)
            v = v.reshape(njt, nit, cf_f, cf_f, B).permute(0, 2, 1, 3, 4)
            return v.reshape(njt * cf_f, nit * cf_f, B)
        v = bmv(Pm, e_c)
        if kind == "geometric":
            cf = cf_f
            njc_loc, nic, _ = e_c.shape
            B = v.shape[2] // (cf * cf)
            v = v.reshape(njc_loc, nic, cf, cf, B).permute(0, 2, 1, 3, 4)
            return v.reshape(njc_loc * cf, nic * cf, B)
        return v

    def restrict(self, k, data, r):
        return [self._restrict(k, R, x) for R, x in zip(data.Rs[k - 1], r)]

    def prolong(self, k, data, e):
        return [self._prolong(k, Pm, x) for Pm, x in zip(data.Ps[k - 1], e)]

    def _smooth(self, k, data, rhs, u, cfg, iterations=None):
        iters = int(iterations if iterations is not None else cfg.iterations)
        kind = SMOOTHER_ALIASES[cfg.name]
        if kind == "cheby":
            if cfg.eig_ratio is not None:
                ratio = cfg.eig_ratio
            else:
                ratio = cfg.omega if 0.0 < cfg.omega < 1.0 else 0.3
            return _chebyshev_sweep(data.blocks[k], data.Dinv[k], rhs, u, degree=iters,
                                    eig_max=self.eig_max[k], eig_ratio=ratio)
        if kind == "jacobi":
            for _ in range(iters):
                u = _block_jacobi_sweep(data.blocks[k], data.Dinv[k], rhs, u,
                                        omega=cfg.omega)
            return u
        # GS family: red-black (symmetric = 2 color passes per iteration, as
        # ops.smoothers.block_gauss_seidel's redblack strategy)
        n_pass = iters * (2 if cfg.direction == "symmetric" else 1)
        return _rb_gs_sweep_packed(data.packs[k], rhs, u, omega=cfg.omega, n_pass=n_pass)

    def _v_cycle(self, k, data, rhs, u, mode=None):
        mode = mode or self.cycle_type
        if k == 0:
            if self.coarse_solver not in ("direct", "amg"):
                # 10 sweeps of the lowest coarsening type's pre-smoother
                pre, _ = self.cfgs[1]
                return self._smooth(0, data, rhs, u, pre, iterations=10)
            return _gather_solve(self.mesh, data.coarse_inv, rhs)
        pre, post = self.cfgs[k]
        u = self._smooth(k, data, rhs, u, pre)
        r = _sub(rhs, _matvec_with_halo(data.blocks[k], u))
        r_c = self.restrict(k, data, r)
        e_c = self._v_cycle(k - 1, data, r_c, _zeros_like(r_c), mode=mode)
        if mode in ("W", "F") and k - 1 > 0:
            # F revisits with a plain V (MultigridSolver.v_cycle semantics)
            e_c = self._v_cycle(k - 1, data, r_c, e_c, mode="W" if mode == "W" else "V")
        u = _add(u, self.prolong(k, data, e_c))
        return self._smooth(k, data, rhs, u, post)

    def _fmg(self, data, rhs):
        """Full-multigrid (nested-iteration) guess: restrict the rhs down,
        solve the coarsest level, prolong up with one cycle per level."""
        n_lev = len(self.levels)
        rhss = [rhs]
        for k in range(n_lev - 1, 0, -1):
            rhss.append(self.restrict(k, data, rhss[-1]))
        rhss = rhss[::-1]                   # coarsest first
        u = self._v_cycle(0, data, rhss[0], _zeros_like(rhss[0]))
        for k in range(1, n_lev):
            u = self._v_cycle(k, data, rhss[k], self.prolong(k, data, u))
        return u

    def _bands(self, vec, dtype=None):
        B = self.levels[-1].N_DOF_sol_tot
        g = vec_to_grid(vec, self.Ni, self.Nj, B)
        return self.mesh.split(g if dtype is None else g.to(dtype))

    def solve(self, rhs_vec, u0_vec=None):
        """Full-precision cycles to ``solver.multigrid.tolerance``; returns
        (u, res, n) with the residual history in ``self.history``."""
        data = self.data
        blocks = data.blocks[-1]
        rhs = self._bands(rhs_vec)
        u = self._bands(u0_vec) if u0_vec is not None else _zeros_like(rhs)
        n_lev = len(self.levels)
        if self.full_multigrid:
            # FMG guess; the normalization stays ||rhs|| so "res <= tol" keeps
            # its relative-to-zero-iterate meaning
            u = _add(u, self._fmg(data, _sub(rhs, _matvec_with_halo(blocks, u))))
            res0 = float(_pnorm2(rhs))
        else:
            res0 = float(_pnorm2(_sub(rhs, _matvec_with_halo(blocks, u))))
        res = float(_pnorm2(_sub(rhs, _matvec_with_halo(blocks, u)))) / res0
        hist, n = [], 0
        while n < self.max_cycles and res >= self.tol and np.isfinite(res):
            hist.append(res)
            u = self._v_cycle(n_lev - 1, data, rhs, u)
            res = float(_pnorm2(_sub(rhs, _matvec_with_halo(blocks, u)))) / res0
            n += 1
        self.history = hist + [res]
        return grid_to_vec(self.mesh.join(u)), res, n

    # -- mixed-precision refinement over the shards --------------------------

    def build_refined(self, tol=1e-10, n_inner=6, max_outer=20, defect="auto"):
        """Sharded mixed-precision defect correction: one float64 halo
        residual per outer round, the inner correction as ``n_inner`` float32
        sharded cycles.  The defect is native float64 (``defect`` 'auto' or
        'f64'; dgtpu's 'df32' is not ported).  With
        ``solver.multigrid.full_multigrid`` on, the outer loop is seeded with
        the float32 FMG guess on the initial defect, while the criterion
        stays normalized by the pre-seed residual.  Returns
        ``solve(rhs_bands, u0_bands) -> (u_bands, res, n, history)``."""
        _check_defect(defect)
        n_lev = len(self.levels)
        b64 = self.data.blocks[-1]
        data = self.data32()
        f32 = torch.float32

        def inner(r32):
            e = _zeros_like(r32)
            for _ in range(n_inner):
                e = self._v_cycle(n_lev - 1, data, r32, e)
            return e

        def solve(rhs, u):
            r = _sub(rhs, _matvec_with_halo(b64, u))
            res0 = float(_pnorm2(r))
            if self.full_multigrid:
                u = _add(u, _cast(self._fmg(data, _cast(r, f32)), rhs[0].dtype))
                r = _sub(rhs, _matvec_with_halo(b64, u))
            res, hist, n = 1.0, [], 0
            while n < max_outer and res >= tol and np.isfinite(res):
                hist.append(res)
                u = _add(u, _cast(inner(_cast(r, f32)), rhs[0].dtype))
                r = _sub(rhs, _matvec_with_halo(b64, u))
                res = float(_pnorm2(r)) / res0
                n += 1
            return u, res, n, hist + [res]

        return solve

    def solve_refined(self, rhs_vec, u0_vec=None, tol=1e-10, n_inner=6, max_outer=20,
                      defect="auto"):
        """Float64-accuracy sharded solve; returns (u, res, n_outer)."""
        fn = self.build_refined(tol=tol, n_inner=n_inner, max_outer=max_outer,
                                defect=defect)
        rhs = self._bands(rhs_vec, torch.float64)
        u0 = self._bands(u0_vec) if u0_vec is not None else _zeros_like(rhs)
        u, res, n, self.history = fn(rhs, u0)
        return grid_to_vec(self.mesh.join(u)), res, n

    def tensors(self):
        """Every operand tensor of the cycle (for device checks)."""
        return self.data.tensors()
