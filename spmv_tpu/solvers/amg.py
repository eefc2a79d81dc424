"""Algebraic multigrid (pairwise aggregation) — optimal-order preconditioning.

The reference ships the *intent* of multigrid — its ``restrictmain`` demo
wires a restrict/prolongate cycle (reference demos/restrictmain.cpp:60-91)
— but the demo is bit-rotted (uses the removed Eigen-returning ``mult``,
``transpmult`` throws, reference spmv/Matrix.cpp:144-148) and no actual
multilevel solver exists. This module supplies the real thing: an
aggregation-based AMG hierarchy used as a preconditioner for ``cg``,
turning the O(sqrt(kappa)) iteration count of plain CG on a Laplacian
into an O(1)-ish count independent of resolution.

Design decisions:

- **Shard-local aggregation** (decoupled): aggregates never cross the 1-D
  row partition, so restriction and prolongation are COMM-FREE per-shard
  gathers — no halo, no scatter. Each level's coarse unknowns are laid out
  as ``n_devices * ncs_max`` (every shard owns exactly ``ncs_max`` coarse
  slots, its surplus padded with structural zero rows), which makes the
  aggregate->owner map coincide with ``owner_ranges`` by construction.
- **Gather-only transfer operators**: restriction sums each aggregate's
  members via an (nc_pad, S) gather table (S = max aggregate size) —
  S sequential gathers instead of one scatter-add (deterministic, no
  atomics); prolongation is a single gather.
- **Chebyshev-Jacobi smoothing** (solvers/chebyshev.py): zero reductions
  per sweep — on a distributed mesh the smoother's only communication is
  the operator's own halo exchange. Spectrum bound per level is the
  Gershgorin bound of D^-1 A (a vectorized host pass; always an upper
  bound, so Chebyshev never amplifies).
- **Galerkin coarse operators** (A_c = P^T A P with piecewise-constant P)
  are built host-side as one vectorized coalesce over the level's
  triplets and assembled as ordinary ``DistMatrix`` operators — coarse
  SpMV rides the exact same halo-plan machinery as the fine grid.
- **Dense coarsest solve**: the final level's padded operator is inverted
  once on host (identity on padding rows); the apply is one tiny
  all_gather + a row-sharded dense matvec.

The whole hierarchy is a registered pytree: pass it THROUGH jit as an
argument (like every operator in this library) so coarse matrices never
become embedded constants.

Symmetry: identical Chebyshev pre/post smoothing around an exact Galerkin
coarse correction yields a symmetric positive definite V-cycle operator,
so it is a valid ``cg`` preconditioner (plain PCG, no flexible variant
needed).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from spmv_tpu.formats.csr import CSRHost
from spmv_tpu.parallel.dist_matrix import DistMatrix, build_dist_matrix
from spmv_tpu.parallel.partition import owner_ranges
from spmv_tpu.solvers.chebyshev import chebyshev

LANES = 128


# --------------------------------------------------------------------------
# host-side setup: pairwise aggregation
# --------------------------------------------------------------------------

def _strongest_neighbor(rows, cols, w, prio, n):
    """cand[i] = argmax_j w(i,j), ties broken by a random priority so that
    constant-weight graphs (e.g. uniform Laplacians) still produce mutual
    pairs instead of everyone chasing the same direction. Native tier: one
    O(nnz) scan with the lexsort tie-breaking reproduced exactly (last
    occurrence wins equal (w, prio)); numpy fallback below."""
    from spmv_tpu.native.lib import get_lib

    lib = get_lib()
    if lib is not None and len(rows):
        import ctypes

        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        r64 = np.ascontiguousarray(rows, np.int64)
        c64 = np.ascontiguousarray(cols, np.int64)
        w64 = np.ascontiguousarray(w, np.float64)
        p64 = np.ascontiguousarray(prio, np.float64)
        cand = np.empty(n, np.int64)
        rc = lib.spmv_strongest_neighbor(
            r64.ctypes.data_as(i64p), c64.ctypes.data_as(i64p),
            w64.ctypes.data_as(f64p), p64.ctypes.data_as(f64p),
            ctypes.c_int64(len(r64)), ctypes.c_int64(n),
            cand.ctypes.data_as(i64p))
        if rc == 0:
            return cand
    order = np.lexsort((prio[cols], w, rows))
    r_sorted = rows[order]
    if len(r_sorted) == 0:
        return np.full(n, -1, dtype=np.int64)
    last = np.flatnonzero(np.r_[r_sorted[1:] != r_sorted[:-1], True])
    cand = np.full(n, -1, dtype=np.int64)
    cand[r_sorted[last]] = cols[order][last]
    return cand


def _pairwise_pass(rows, cols, vals, n, seed):
    """One matching pass: mutual strongest-neighbor pairs merge, remaining
    singletons attach to their strongest matched neighbor. Returns
    ``agg`` (n,) int64 in [0, nc) and nc. Native tier: one C++ call with
    identical matching/tie-breaking/relabel semantics (regression-tested);
    the numpy tier below materializes 2*nnz symmetrized edge temporaries."""
    idx = np.arange(n, dtype=np.int64)
    if len(rows) == 0:
        return idx.copy(), n
    from spmv_tpu.native.lib import get_lib

    lib = get_lib()
    if lib is not None:
        import ctypes

        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        r64 = np.ascontiguousarray(rows, np.int64)
        c64 = np.ascontiguousarray(cols, np.int64)
        v64 = np.ascontiguousarray(vals, np.float64)
        prio = np.random.default_rng(seed).permutation(n).astype(np.float64)
        agg = np.empty(n, np.int64)
        nc = lib.spmv_pairwise_pass(
            r64.ctypes.data_as(i64p), c64.ctypes.data_as(i64p),
            v64.ctypes.data_as(f64p), ctypes.c_int64(len(r64)),
            ctypes.c_int64(n), prio.ctypes.data_as(f64p),
            agg.ctypes.data_as(i64p))
        if nc >= 0:
            return agg, int(nc)
    off = rows != cols
    rows, cols, vals = rows[off], cols[off], vals[off]
    # symmetrize the strength graph (coalescing not needed for argmax)
    rows2 = np.concatenate([rows, cols])
    cols2 = np.concatenate([cols, rows])
    w = np.abs(np.concatenate([vals, vals]).astype(np.float64))
    prio = np.random.default_rng(seed).permutation(n).astype(np.float64)

    cand = _strongest_neighbor(rows2, cols2, w, prio, n)
    mate = np.where(cand >= 0, cand, idx)
    mutual = (mate[mate] == idx) & (mate != idx)
    rep = np.where(mutual, np.minimum(idx, mate), idx)

    # attach leftover singletons to the aggregate of their strongest
    # already-matched neighbor (one level of indirection only: reps of
    # matched nodes are final, so no chains form)
    matched = mutual
    keep = matched[cols2]
    if keep.any():
        att = _strongest_neighbor(rows2[keep], cols2[keep], w[keep],
                                  prio, n)
        lone = ~matched & (att >= 0)
        rep = rep.copy()
        rep[lone] = rep[att[lone]]

    uniq, agg = np.unique(rep, return_inverse=True)
    return agg.astype(np.int64), len(uniq)


def _coarsen_graph(rows, cols, vals, agg, nc):
    """Galerkin triplets on the aggregated graph (duplicates summed) —
    used to drive the next matching pass."""
    cr = agg[rows]
    cc = agg[cols]
    key = cr * nc + cc
    uniq, inv = np.unique(key, return_inverse=True)
    v = np.bincount(inv, weights=vals.astype(np.float64))
    return uniq // nc, uniq % nc, v


def _aggregate_block(rows, cols, vals, n, passes, seed):
    """Compose ``passes`` pairwise passes on one shard's local block.
    Returns the composed fine->coarse map and the coarse size."""
    agg = np.arange(n, dtype=np.int64)
    nc = n
    r, c, v = rows, cols, vals
    for p in range(passes):
        a_p, nc_p = _pairwise_pass(r, c, v, nc, seed + 101 * p)
        agg = a_p[agg]
        nc = nc_p
        if p + 1 < passes:
            r, c, v = _coarsen_graph(r, c, v, a_p, nc)
    return agg, nc


# _spgemm was promoted to the public spmv_tpu.formats.csr.csr_matmul
# (explicit split operators for CA-CG reuse it); kept under its old name
# for the call sites below.
from spmv_tpu.formats.csr import csr_matmul as _spgemm


def _smoothed_prolongator(a: CSRHost, agg_g: np.ndarray, ncg: int,
                          dinv: np.ndarray, lmax: float,
                          theta: float = 0.0) -> CSRHost:
    """P = (I - omega D^-1 A) P0 with P0 piecewise-constant over the
    aggregates and omega = 4/3 / rho(D^-1 A) (Gershgorin-bounded rho, so
    omega errs small = safe) — the classic smoothed-aggregation
    prolongator (Vanek/Mandel/Brezina)."""
    # NOTE on construction cost: a "direct CSR build" (no sort, fancy
    # indexing) was prototyped and measured SLOWER than from_coo's native
    # counting-sort tier on this host (whose memory-op timings also vary
    # ~3x run-to-run) — keep the robust native path.
    omega = 4.0 / (3.0 * max(lmax, 1e-30))
    lens = a.row_nnz().astype(np.int64)
    rows_g = np.repeat(np.arange(a.nrows, dtype=np.int64), lens)
    idx = np.arange(a.nrows, dtype=np.int64)
    rows = np.concatenate([idx, rows_g])
    cols = np.concatenate([agg_g, agg_g[a.colind.astype(np.int64)]])
    vals = np.concatenate([
        np.ones(a.nrows, np.float64),
        -omega * dinv[rows_g] * a.values.astype(np.float64),
    ])
    p = CSRHost.from_coo(rows, cols, vals, a.nrows, ncg)
    if p.nnz == 0:
        return p
    if theta <= 0.0:
        # theta=0 keeps every entry (|p_ij| >= 0 always) and the
        # renormalization scale is EXACTLY 1.0 (ksum == rsum bitwise, and
        # x/x == 1.0 for finite nonzero x) — the filter block below is an
        # identity whose full-size from_coo re-sort costs ~1/3 of the
        # prolongator at the 3200^2 headline scale. The interval/interval2d
        # aggregations pass theta=0 (amg_setup), so this is their hot path.
        return p
    # filter WEAK interpolation entries (|p_ij| < theta * row max) and
    # renormalize rows to their original sum, so P 1_c == 1 stays exact
    # (constants interpolate exactly) and the Galerkin product downstream
    # is consistent with the P actually applied. This — not filtering the
    # coarse operator — is where stencil growth must be controlled:
    # perturbing A_c directly measured 14 -> 71+ PCG iterations at theta
    # = 0.02, while P-filtering at the same theta is iteration-neutral.
    lens_p = p.row_nnz().astype(np.int64)
    pr = np.repeat(np.arange(p.nrows, dtype=np.int64), lens_p)
    pv = p.values.astype(np.float64)
    rmax = np.zeros(p.nrows, np.float64)
    np.maximum.at(rmax, pr, np.abs(pv))
    keep = np.abs(pv) >= theta * rmax[pr]
    rsum = np.bincount(pr, weights=pv, minlength=p.nrows)
    ksum = np.bincount(pr[keep], weights=pv[keep], minlength=p.nrows)
    scale = np.divide(rsum, ksum, out=np.ones_like(rsum), where=ksum != 0)
    return CSRHost.from_coo(pr[keep], p.colind[keep].astype(np.int64),
                            pv[keep] * scale[pr[keep]], p.nrows, ncg)


def _detect_strides(a: CSRHost, sample: int = 2_000_000,
                    max_strides: int = 2) -> list[int]:
    """Grid strides of a row-major grid, detected algebraically from the
    column-offset histogram (sampled — no nnz-sized temporaries at the
    70M-nnz headline scale). Offsets > 1 with significant counts are
    CLUSTERED (9/27-point stencils put near-equal mass on nx-1, nx, nx+1
    — the cluster's weighted center is the stride; a bare most-frequent
    pick would be off by one): for a 2-D stencil this returns [nx], for
    3-D [nx, nx*ny]; for 1-D or pattern-free operators []."""
    nnz = a.nnz
    if nnz == 0:
        return []
    if nnz > sample:
        step = nnz // sample
        idx = np.arange(0, nnz, step, dtype=np.int64)
    else:
        idx = np.arange(nnz, dtype=np.int64)
    rows = np.searchsorted(a.rowptr, idx, side="right") - 1
    d = a.colind[idx].astype(np.int64) - rows
    d = d[d > 1]
    if len(d) == 0:
        return []
    vals_u, counts = np.unique(d, return_counts=True)
    sig = counts >= 0.02 * len(idx)  # offsets present in ~every row
    vals_u, counts = vals_u[sig], counts[sig]
    if len(vals_u) == 0:
        return []
    # cluster: consecutive significant offsets within a small relative
    # gap belong to one stencil plane (nx-1, nx, nx+1, ...)
    strides: list[int] = []
    start = 0
    for i in range(1, len(vals_u) + 1):
        if (i == len(vals_u)
                or vals_u[i] - vals_u[i - 1] > max(2, vals_u[i - 1] // 8)):
            c = counts[start:i]
            v = vals_u[start:i]
            center = int(round(float((v * c).sum() / c.sum())))
            strides.append(center)
            start = i
    # keep the most-supported clusters in ascending-stride order, and
    # demand divisibility consistency for the 3-D pair (s2 % s1 == 0
    # within the cluster slack)
    strides = strides[:max_strides + 2]
    out = []
    for s in strides:
        if s <= 1:
            continue
        if out and abs(s % out[0]) > max(2, out[0] // 8) \
                and abs(out[0] - s % out[0]) > max(2, out[0] // 8):
            continue  # inconsistent with the base stride — not a grid axis
        out.append(s)
        if len(out) == max_strides:
            break
    return out


def _gershgorin_scaled(rows, cols, vals, diag):
    """max_i sum_j |a_ij| / |a_ii| — an upper bound on lambda_max(D^-1 A)
    (rows with zero diagonal — padding — are excluded; the smoother leaves
    them untouched)."""
    absrow = np.bincount(rows, weights=np.abs(vals.astype(np.float64)),
                         minlength=len(diag))
    d = np.abs(diag.astype(np.float64))
    ratio = np.divide(absrow, d, out=np.zeros_like(absrow), where=d > 0)
    return float(ratio.max()) if len(ratio) else 1.0


# --------------------------------------------------------------------------
# hierarchy pytrees
# --------------------------------------------------------------------------

@dataclasses.dataclass
class AMGLevel:
    """One fine level: its operator, Jacobi scaling, smoother bounds, and
    the transfer operators down to the next level — either comm-free
    aggregate gather tables (unsmoothed P0) or rectangular DistMatrix
    operators (smoothed prolongator), per ``amg_setup(smooth=...)``."""

    A: DistMatrix
    dinv: jax.Array          # (D*row_pad/128, 128) 1/diag (0 where diag==0)
    restrict_tab: jax.Array | None  # (D, nc_pad, S) int32; dump = row_pad
    prolong_tab: jax.Array | None   # (D, row_pad)   int32; dump = nc_pad
    P: DistMatrix | None     # smoothed prolongator (fine x coarse)
    R: DistMatrix | None     # its transpose (coarse x fine)
    lmax: float              # Gershgorin bound on lambda_max(D^-1 A)
    lmin: float              # bottom of the smoothing band
    nc_pad: int              # next level's per-shard padded size
    degree: int              # Chebyshev smoothing steps
    # interval-aggregation mode (aggregate="interval"): transfers are
    # reshape/repeat ops — P0 x = repeat(x, interval), P0^T r = interval-
    # block sums — and the prolongator smoothing factor (I - omega_p D^-1 A)
    # is applied IMPLICITLY through this level's own (fast, banded) kernel,
    # so no rectangular transfer operator is ever stored or gathered.
    interval: int = 0        # aggregate run length (0 = table/operator mode)
    omega_p: float = 0.0     # prolongator smoothing weight (0 = unsmoothed)
    omega_c: float = 0.0     # per-level coarse-correction over-relaxation
    #                          (0 = use the hierarchy-wide omega)
    smoothed: bool = True    # False: this level fell back to unsmoothed P0
    #                          (smooth_levels cutoff or galerkin_budget trip)
    stride: int = 1          # interval mode: detected grid x-extent
    #                          (1 = consecutive-row 1-D aggregates; >1 =
    #                          grid-block aggregates along (x, y[, z]),
    #                          composed reshape transfers)
    stride2: int = 0         # 3-D grids: the plane stride nx*ny (0 = 2-D)


jax.tree_util.register_dataclass(
    AMGLevel,
    data_fields=["A", "dinv", "restrict_tab", "prolong_tab", "P", "R"],
    meta_fields=["lmax", "lmin", "nc_pad", "degree", "interval", "omega_p",
                 "omega_c", "smoothed", "stride", "stride2"],
)


@dataclasses.dataclass
class AMGHierarchy:
    """The full grid hierarchy. A pytree — pass it through jit as an
    argument; ``as_preconditioner()`` plugs into ``cg``."""

    levels: list[AMGLevel]
    coarse_A: DistMatrix          # coarsest operator (for diagnostics)
    coarse_inv: jax.Array | None  # (D*cpad, D*cpad) row-sharded dense inv
    coarse_dinv: jax.Array        # fallback smoother scaling on coarsest
    coarse_lmax: float
    coarse_lmin: float
    coarse_iters: int             # Chebyshev fallback iterations
    cycle: int                    # 1 = V-cycle, 2 = W-cycle
    omega: float = 1.0            # coarse-correction over-relaxation

    @property
    def n_levels(self) -> int:
        return len(self.levels) + 1

    def grid_complexity(self) -> float:
        """sum of level unknowns / fine unknowns (memory/work overhead)."""
        tot = sum(lvl.A.nrows_global for lvl in self.levels)
        tot += self.coarse_A.nrows_global
        return tot / self.levels[0].A.nrows_global if self.levels else 1.0

    def as_preconditioner(self) -> Callable[[jax.Array], jax.Array]:
        """z = M^-1 r closure for ``cg(preconditioner=...)``. Casts f64
        residuals through the (f32-class) cycle and back, so it also
        accelerates DS/f64 outer solves."""

        def apply(r):
            if r.dtype == jnp.float64:
                return _cycle(self, 0, r.astype(jnp.float32)).astype(r.dtype)
            return _cycle(self, 0, r)

        return apply


jax.tree_util.register_dataclass(
    AMGHierarchy,
    data_fields=["levels", "coarse_A", "coarse_inv", "coarse_dinv"],
    meta_fields=["coarse_lmax", "coarse_lmin", "coarse_iters", "cycle",
                 "omega"],
)


# --------------------------------------------------------------------------
# device-side cycle
# --------------------------------------------------------------------------

def _smooth(A, dinv, lmax, lmin, degree, r, x0=None):
    """``degree`` Chebyshev steps on D^-1 A x = D^-1 r (reduction-free;
    the halo exchange inside A.matvec is the only communication)."""
    mv = lambda v: dinv * A.matvec(v)
    return chebyshev(mv, dinv * r, lmin, lmax, iters=degree, x0=x0).x


def _relayout(x: jax.Array, pad_out: int, Aref: DistMatrix) -> jax.Array:
    """Per-shard zero-pad / truncate between lane layouts with different
    per-shard padded lengths (formats align row_pad differently — e.g.
    WELL to tile_groups*128, DIA to 1024, ELL to 128). Truncation only
    ever drops structural padding: every layout's real entries occupy
    [0, nlocal) and nlocal <= min(pad_in, pad_out)."""
    nd = Aref.n_devices
    pad_in = x.shape[0] // nd * LANES
    if pad_in == pad_out:
        return x
    spec = P(Aref.axis_name, None)

    def per_shard(x_s):
        v = x_s.reshape(-1)
        v = (jnp.pad(v, (0, pad_out - pad_in)) if pad_out > pad_in
             else v[:pad_out])
        return v.reshape(pad_out // LANES, LANES)

    return jax.shard_map(
        per_shard, mesh=Aref.mesh, in_specs=(spec,), out_specs=spec,
    )(x)


def _interval_stages(lvl: AMGLevel) -> list[int]:
    """The transfer's reshape-sum stages, outermost grid axis first:
    strided stages (z with stride2, y with stride), then the consecutive
    x stage encoded as stride 1."""
    stages = []
    if lvl.stride2 > 1:
        stages.append(lvl.stride2)
    if lvl.stride > 1:
        stages.append(lvl.stride)
    stages.append(1)
    return stages


def _restrict_interval(lvl: AMGLevel, r: jax.Array) -> jax.Array:
    """R r = P0^T (I - omega_p A D^-1) r with P0^T = aggregate-block sums
    (per-shard reshape-reduces — no gather, no table). Requires a
    symmetric level operator so that R = P^T exactly.

    ``stride == 1``: aggregates are ``interval`` consecutive local rows
    (1-D x-coarsening). ``stride > 1`` (interval2d on a 2-D grid):
    interval x interval grid blocks, composed as TWO reshape-sums —
    ``interval`` rows spaced ``stride`` apart (y), then ``interval``
    consecutive intermediate entries (x). ``stride2 > 1`` (3-D grid):
    a third z stage at the plane stride runs first. Coarsening EVERY
    grid direction in one level is what keeps the smoothed Galerkin
    stencil BOUNDED (smoothing triples each direction's extent, block
    coarsening divides it by ``interval`` >= 3); leaving any direction
    uncoarsened grows its stencil x3 per level without bound (measured
    138 nnz/row by level 3 at 2048^2 under 1-D alternation)."""
    A = lvl.A
    if lvl.omega_p != 0.0:
        r = r - lvl.omega_p * A.matvec(lvl.dinv * r)
    size = lvl.interval
    stages = _interval_stages(lvl)
    nc_pad = lvl.nc_pad
    rp = A.row_pad
    spec = P(A.axis_name, None)

    def per_shard(r_s):
        v = r_s.reshape(-1)
        ln = rp
        for s in stages:
            nb = -(-ln // (size * s))
            v = jnp.pad(v, (0, nb * size * s - ln))
            v = v.reshape(nb, size, s).sum(axis=1).reshape(-1)
            ln = nb * s
        vc = (jnp.pad(v, (0, nc_pad - ln)) if nc_pad > ln
              else v[:nc_pad])
        return vc.reshape(nc_pad // LANES, LANES)

    return jax.shard_map(per_shard, mesh=A.mesh, in_specs=(spec,),
                         out_specs=spec)(r)


def _prolong_interval(lvl: AMGLevel, xc: jax.Array) -> jax.Array:
    """P xc = (I - omega_p D^-1 A) P0 xc with P0 = aggregate-block repeat
    (the exact reverse of _restrict_interval's stage chain: broadcast x,
    then y, then z). Fine padding rows are masked by dinv's zero pattern
    (structural padding has zero diagonal) so junk never leaks into the
    outer solve's dot products."""
    A = lvl.A
    size = lvl.interval
    stages = _interval_stages(lvl)
    nc_pad = lvl.nc_pad
    rp = A.row_pad
    spec = P(A.axis_name, None)
    # forward stage lengths (same chain as _restrict_interval)
    lens = [rp]
    for s in stages:
        nb = -(-lens[-1] // (size * s))
        lens.append(nb * s)

    def per_shard(xc_s):
        v = xc_s.reshape(-1)
        ln = lens[-1]
        v = jnp.pad(v, (0, ln - nc_pad)) if ln > nc_pad else v[:ln]
        for i in range(len(stages) - 1, -1, -1):
            s = stages[i]
            nb = lens[i + 1] // s
            v = jnp.broadcast_to(
                v.reshape(nb, 1, s), (nb, size, s)).reshape(-1)
            v = v[: lens[i]] if v.shape[0] >= lens[i] else jnp.pad(
                v, (0, lens[i] - v.shape[0]))
        return v.reshape(rp // LANES, LANES)

    xf = jax.shard_map(per_shard, mesh=A.mesh, in_specs=(spec,),
                       out_specs=spec)(xc)
    mask = (lvl.dinv != 0).astype(xf.dtype)
    xf = xf * mask
    if lvl.omega_p != 0.0:
        xf = xf - lvl.omega_p * lvl.dinv * A.matvec(xf)
    return xf


def _restrict(lvl: AMGLevel, r: jax.Array) -> jax.Array:
    if lvl.interval:
        return _restrict_interval(lvl, r)
    if lvl.R is not None:
        rc = lvl.R.matvec(_relayout(r, lvl.R.col_pad, lvl.R))
        return _relayout(rc, lvl.nc_pad, lvl.R)
    A = lvl.A
    s = lvl.restrict_tab.shape[-1]
    nc_pad = lvl.nc_pad
    spec = P(A.axis_name, None)

    def per_shard(r_s, t_s):
        rf = jnp.concatenate(
            [r_s.reshape(-1), jnp.zeros((1,), r_s.dtype)])
        t = t_s[0]  # (nc_pad, S)
        rc = rf[t[:, 0]]
        for k in range(1, s):
            rc = rc + rf[t[:, k]]
        return rc.reshape(nc_pad // LANES, LANES)

    return jax.shard_map(
        per_shard, mesh=A.mesh,
        in_specs=(spec, P(A.axis_name, None, None)), out_specs=spec,
    )(r, lvl.restrict_tab)


def _prolong(lvl: AMGLevel, xc: jax.Array) -> jax.Array:
    if lvl.interval:
        return _prolong_interval(lvl, xc)
    if lvl.P is not None:
        xf = lvl.P.matvec(_relayout(xc, lvl.P.col_pad, lvl.P))
        return _relayout(xf, lvl.A.row_pad, lvl.P)
    A = lvl.A
    rp = A.row_pad
    spec = P(A.axis_name, None)

    def per_shard(xc_s, t_s):
        xf = jnp.concatenate(
            [xc_s.reshape(-1), jnp.zeros((1,), xc_s.dtype)])
        return xf[t_s[0]].reshape(rp // LANES, LANES)

    return jax.shard_map(
        per_shard, mesh=A.mesh,
        in_specs=(spec, P(A.axis_name, None)), out_specs=spec,
    )(xc, lvl.prolong_tab)


def _coarse_solve(h: AMGHierarchy, r: jax.Array) -> jax.Array:
    A = h.coarse_A
    if h.coarse_inv is None:
        # Chebyshev fallback when the coarsest grid was too large to invert
        return _smooth(A, h.coarse_dinv, h.coarse_lmax, h.coarse_lmin,
                       h.coarse_iters, r)
    cpad = A.row_pad
    spec = P(A.axis_name, None)

    def per_shard(r_s, inv_s):
        r_full = jax.lax.all_gather(
            r_s.reshape(-1), axis_name=A.comm_axes, tiled=True)
        y = inv_s @ r_full
        return y.reshape(cpad // LANES, LANES)

    return jax.shard_map(
        per_shard, mesh=A.mesh, in_specs=(spec, spec), out_specs=spec,
    )(r, h.coarse_inv)


def _cycle(h: AMGHierarchy, l: int, r: jax.Array) -> jax.Array:
    if l == len(h.levels):
        return _coarse_solve(h, r)
    lvl = h.levels[l]
    w = lvl.omega_c if lvl.omega_c != 0.0 else h.omega
    x = _smooth(lvl.A, lvl.dinv, lvl.lmax, lvl.lmin, lvl.degree, r)
    for _ in range(h.cycle):  # 1 = V, 2 = W
        rc = _restrict(lvl, r - lvl.A.matvec(x))
        x = x + w * _prolong(lvl, _cycle(h, l + 1, rc))
    return _smooth(lvl.A, lvl.dinv, lvl.lmax, lvl.lmin, lvl.degree, r, x0=x)


# --------------------------------------------------------------------------
# setup
# --------------------------------------------------------------------------

def _level_tables(a: CSRHost, A: DistMatrix, passes: int, seed: int):
    """Shard-local aggregation of one level. Returns (global fine->coarse
    map, coarse global size ``D*ncs_max``, per-shard restrict/prolong
    tables as numpy, ncs_max)."""
    nd = A.n_devices
    ranges = owner_ranges(a.nrows, nd)
    lens = a.row_nnz()
    rows_g = np.repeat(np.arange(a.nrows, dtype=np.int64), lens)
    cols_g = a.colind.astype(np.int64)

    aggs, ncs = [], []
    for s in range(nd):
        r0, r1 = int(ranges[s]), int(ranges[s + 1])
        nloc = r1 - r0
        lo, hi = a.rowptr[r0], a.rowptr[r1]
        rs = rows_g[lo:hi] - r0
        cs = cols_g[lo:hi]
        keep = (cs >= r0) & (cs < r1)  # aggregation sees the local block
        agg_s, nc_s = _aggregate_block(
            rs[keep], cs[keep] - r0, a.values[lo:hi][keep], nloc,
            passes, seed + 977 * s)
        aggs.append(agg_s)
        ncs.append(nc_s)

    ncs_max = max(max(ncs), 1)
    agg_global = np.concatenate(
        [s * ncs_max + aggs[s] for s in range(nd)]
    ) if a.nrows else np.zeros(0, np.int64)
    return agg_global, nd * ncs_max, aggs, ncs, ncs_max


def _build_tables(aggs, ncs, row_pad, nc_pad, nd):
    """Gather tables: restrict (nd, nc_pad, S) and prolong (nd, row_pad)."""
    s_max = 1
    per_shard = []
    for s in range(nd):
        agg = aggs[s]
        counts = np.bincount(agg, minlength=ncs[s]) if len(agg) else \
            np.zeros(ncs[s], np.int64)
        s_max = max(s_max, int(counts.max()) if len(counts) else 1)
        per_shard.append(counts)

    restrict = np.full((nd, nc_pad, s_max), row_pad, dtype=np.int32)
    prolong = np.full((nd, row_pad), nc_pad, dtype=np.int32)
    for s in range(nd):
        agg = aggs[s]
        n = len(agg)
        prolong[s, :n] = agg
        order = np.argsort(agg, kind="stable")
        counts = per_shard[s]
        offsets = np.zeros(len(counts) + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        pos = np.arange(n) - offsets[agg[order]]
        restrict[s, agg[order], pos] = order
    return restrict, prolong


def amg_setup(
    a: CSRHost,
    A: DistMatrix,
    passes: int = 1,
    max_levels: int = 16,
    coarse_max: int = 3072,
    dense_cap: int = 6144,
    degree: int = 2,
    band: float = 4.0,
    cycle: int = 1,
    omega: float = 1.0,
    smooth: bool = True,
    filter_theta: float = 0.05,
    coarse_iters: int = 24,
    galerkin_budget: float = 12.0,
    seed: int = 0,
    local_format: str = "ell",
    transfer_format: str | None = None,
    aggregate: str = "match",
    interval_size: int = 2,
    smooth_levels: int | None = None,
    dtype=np.float32,
) -> AMGHierarchy:
    """Build the AMG hierarchy for SPD ``a`` (host CSR) whose distributed
    operator is ``A`` (the object the outer solve uses — any local format,
    including symmetric and DS storage).

    Defaults are classic smoothed aggregation (``smooth=True, passes=1``):
    pairwise aggregates of ~3, Jacobi-smoothed prolongator, degree-2
    Chebyshev smoothing — measured mesh-INDEPENDENT PCG counts (13-14
    iterations to 1e-6 on 256^2..512^2 Laplacians, vs 122+ plain CG and
    growing). For setup-time-bound cases use the cheap unsmoothed variant
    ``smooth=False, passes=2, omega=1.7`` (gather-table transfers, ~3x
    faster setup, mildly size-dependent counts).

    ``passes``: pairwise matching passes per level (1 -> aggregates ~3,
    2 -> ~10). ``band``: the smoother damps [lmax/band, lmax].
    ``cycle``: 1 = V, 2 = W. ``omega``: coarse-correction
    over-relaxation — leave at 1.0 with a smoothed prolongator; ~1.7
    compensates the unsmoothed P0's stiffness overestimate. Coarse grids
    are assembled at f32 (``dtype``) regardless of the fine operator's
    precision — preconditioning accuracy does not limit the outer solve's
    attainable residual.

    ``galerkin_budget``: per-level stencil-growth cap — when the Galerkin
    triple product's partial-product count would exceed
    ``galerkin_budget * nnz(level)``, the level falls back to the
    unsmoothed P0 (same mechanism as ``smooth_levels``, but driven by the
    measured pattern instead of a fixed depth). Keeps deep coarse
    operators bounded in both storage and per-cycle cost; at 10M-row
    scale the unguarded default was 213 ms/V-cycle in 2-D and an
    out-of-memory SpGEMM in 3-D.

    ``aggregate="interval"`` (for BANDED / RCM-ordered operators): each
    shard aggregates ``interval_size`` consecutive rows instead of graph
    matching. Index-contiguous aggregates keep every Galerkin coarse
    operator banded (DIA-packable — the stencil fast path), and the
    transfers become pure reshape ops: P0 = repeat, P0^T = interval block
    sums, with the prolongator smoothing factor (I - omega_p D^-1 A)
    applied implicitly through the level's own kernel. Nothing
    rectangular is stored, gathered, or exchanged. The cost is REAL
    mesh-dependence — pure 1-D semicoarsening with point smoothers
    doubles the PCG count per mesh doubling (measured 22 -> 44 -> 97 at
    256^2 -> 1024^2, non-convergent by 3163^2) — so for 2-D/3-D
    grid-like operators use ``aggregate="interval2d"`` instead.

    ``aggregate="interval2d"`` (grid-like operators — the headline
    config): per level, the grid stride (x-extent) is detected
    algebraically (most frequent column offset > 1, sampled) and
    aggregates are ``interval_size`` x ``interval_size`` grid BLOCKS —
    full 2-D coarsening every level, as two composed reshape-sums
    (y-strided then x-consecutive, _restrict_interval). This restores
    mesh-INDEPENDENT counts AND bounds the smoothed Galerkin stencil (a
    9-point forever: smoothing triples each direction's extent, block
    coarsening divides by interval_size >= 3 — one-direction
    semicoarsening densified without bound, 138 nnz/row by level 3 at
    2048^2), while keeping everything the interval mode buys: banded
    DIA-packable coarse operators, reshape-only transfers, implicit
    prolongator smoothing. Falls back to consecutive-row coarsening
    automatically when no grid stride is detected (1-D operators).
    """
    if a.nrows != a.ncols:
        raise ValueError("AMG requires a square (SPD) operator")
    if aggregate not in ("match", "interval", "interval2d"):
        raise ValueError(f"unknown aggregate mode {aggregate!r}")
    if aggregate.startswith("interval") and interval_size < 2:
        raise ValueError("interval_size must be >= 2")
    if transfer_format is None:
        # transfers are rectangular — DIA cannot store them
        transfer_format = "ell" if local_format.startswith("dia") \
            else local_format
    levels: list[AMGLevel] = []
    cur = a
    cur_A = A
    if A.local_format in ("dia_ds", "well_ds") or A.dtype == np.float64:
        # DS/f64 outer operators apply at f64 class; the smoother needs a
        # plain f32 apply — build a dedicated fine-level operator (the
        # preconditioner's accuracy does not limit the outer residual)
        cur_A = build_dist_matrix(a, mesh=A.mesh,
                                  local_format=local_format, dtype=dtype)
    nd = A.n_devices

    while (len(levels) < max_levels - 1
           and cur.nrows > max(coarse_max, nd * LANES)):
        lvl_stride = 1
        lvl_stride2 = 0
        if aggregate in ("interval", "interval2d"):
            if aggregate == "interval2d":
                # grid-block aggregation (interval^d patches of the
                # detected 2-D/3-D grid): coarsening EVERY direction per
                # level keeps the smoothed Galerkin stencil bounded AND
                # the hierarchy isotropic — the fix for 1-D
                # semicoarsening's mesh-DEPENDENT counts (measured
                # 22 -> 44 -> 97 PCG iterations at 256^2 -> 1024^2,
                # non-convergent at 3163^2; see _restrict_interval).
                s_det = _detect_strides(cur)
                if s_det and cur.nrows // s_det[0] >= interval_size:
                    lvl_stride = s_det[0]
                    if (len(s_det) > 1
                            and cur.nrows // s_det[1] >= interval_size):
                        lvl_stride2 = s_det[1]
            ranges_l = owner_ranges(cur.nrows, nd)
            nlocs = np.diff(ranges_l)
            # uniform stage formula stage(v, s) = (v // (I*s))*s + v % s,
            # applied outermost-axis-first (z with stride2, y with stride,
            # x with 1) — identical to the device reshape chain
            # (_restrict_interval)
            stages_h = ([lvl_stride2] if lvl_stride2 > 1 else []) + \
                ([lvl_stride] if lvl_stride > 1 else []) + [1]
            aggs, ncs = [], []
            for nl in nlocs:
                v = np.arange(int(nl), dtype=np.int64)
                for s in stages_h:
                    v = (v // (interval_size * s)) * s + (v % s)
                aggs.append(v)
                ncs.append(max(int(v.max()) + 1 if len(v) else 1, 1))
            ncs_max = max(ncs)
            agg_g = (np.concatenate(
                [s * ncs_max + aggs[s] for s in range(nd)])
                if cur.nrows else np.zeros(0, np.int64))
            ncg = nd * ncs_max
        else:
            agg_g, ncg, aggs, ncs, _ = _level_tables(cur, cur_A, passes,
                                                     seed
                                                     + 7919 * len(levels))
        if ncg >= 0.8 * cur.nrows:  # coarsening stalled
            break
        diag, lmax = _level_diag(cur)
        restrict = prolong = Pop = Rop = None
        omega_p = 0.0
        omega_c = 0.0
        # hybrid depth cutoff: smoothing each level's P convolves the
        # stencil; under interval aggregation the un-coarsened direction
        # never collapses it back, so deep Galerkin operators densify
        # (measured: ndiag 19 -> 71 -> 163 -> 297 on 1024^2). smooth_levels
        # bounds that: deeper levels fall back to the unsmoothed P0
        # (bounded stencil forever) with a 1.7 over-relaxed correction.
        sm_l = smooth and (smooth_levels is None
                           or len(levels) < smooth_levels)
        if sm_l:
            dinv_h = np.divide(1.0, diag, out=np.zeros_like(diag),
                               where=diag != 0)
            # interval mode applies P implicitly — assembly must use the
            # UNFILTERED smoothed P so apply and Galerkin product agree
            theta = (0.0 if aggregate.startswith("interval")
                     else filter_theta)
            p_host = _smoothed_prolongator(cur, agg_g, ncg, dinv_h, lmax,
                                           theta=theta)
            # densification guard: bound the Galerkin product BEFORE
            # running it. Partial-product count of cur @ P (the SpGEMM ESC
            # expansion bound, formats/csr.csr_matmul) relative to this
            # level's nnz measures stencil growth; past the budget, fall
            # back to the unsmoothed P0 for this level — bounded stencil,
            # 1.7 over-relaxed correction. Without this, deep smoothed
            # levels densify without bound (2-D interval: ndiag 19 -> 71
            # -> 163 -> 297; 3-D at 216^3 the expansion bound alone
            # reached 76e9 partial products = a 283 GiB allocation).
            # flops = sum_ij pp_nnz[colind] — computed as an ncols-sized
            # histogram instead of an nnz-sized int64 gather (~1 GB
            # transient at the 70M-nnz headline scale otherwise)
            pp_nnz = np.diff(p_host.rowptr).astype(np.float64)
            col_hist = np.bincount(cur.colind, minlength=cur.ncols)
            flops_ap = int(pp_nnz @ col_hist[: len(pp_nnz)])
            if flops_ap > galerkin_budget * max(cur.nnz, 1):
                sm_l = False
                import warnings

                warnings.warn(
                    f"amg_setup: level {len(levels)} "
                    f"(n={cur.nrows}) falls back to unsmoothed P0 — "
                    f"Galerkin expansion {flops_ap} > budget "
                    f"{galerkin_budget} * nnz ({cur.nnz}); raise "
                    "galerkin_budget to force smoothing here",
                    stacklevel=2)
        if sm_l:
            coarse = _spgemm(p_host.transpose(), _spgemm(cur, p_host))
            A_c = _build_op(coarse, cur_A.mesh, local_format, dtype)
            if aggregate.startswith("interval"):
                omega_p = 4.0 / (3.0 * max(lmax, 1e-30))
            else:
                Pop = _build_op(p_host, cur_A.mesh, transfer_format, dtype)
                Rop = _build_op(p_host.transpose(), cur_A.mesh,
                                transfer_format, dtype)
                # padding differences between formats are bridged by
                # _relayout shims at apply time
        else:
            lens = cur.row_nnz()
            rows_g = np.repeat(np.arange(cur.nrows, dtype=np.int64), lens)
            coarse = CSRHost.from_coo(
                agg_g[rows_g], agg_g[cur.colind.astype(np.int64)],
                cur.values.astype(np.float64), ncg, ncg)
            A_c = _build_op(coarse, cur_A.mesh, local_format, dtype)
            if not aggregate.startswith("interval"):
                restrict, prolong = _build_tables(
                    aggs, ncs, cur_A.row_pad, A_c.row_pad, nd)
            if smooth:  # unsmoothed P0 only because of the depth cutoff
                omega_c = 1.7
        levels.append(_make_level(
            cur_A, diag, lmax, restrict, prolong, Pop, Rop, A_c.row_pad,
            degree, band,
            interval=(interval_size if aggregate.startswith("interval")
                      else 0),
            omega_p=omega_p, omega_c=omega_c, smoothed=bool(sm_l),
            stride=lvl_stride, stride2=lvl_stride2))
        cur, cur_A = coarse, A_c

    # coarsest: dense inverse (identity on padding rows) when small enough
    diag, lmax = _level_diag(cur)
    cpad = cur_A.row_pad
    ng = nd * cpad
    if ng <= dense_cap:
        ranges = owner_ranges(cur.nrows, nd)
        dense = np.eye(ng, dtype=np.float64)
        rows_g = np.repeat(np.arange(cur.nrows, dtype=np.int64),
                           cur.row_nnz())
        pr = _padded_index(rows_g, ranges, cpad)
        pc = _padded_index(cur.colind.astype(np.int64), ranges, cpad)
        own = _padded_index(np.arange(cur.nrows, dtype=np.int64), ranges,
                            cpad)
        dense[own, own] = 0.0
        np.add.at(dense, (pr, pc), cur.values.astype(np.float64))
        # structurally-zero rows (padding or isolated) keep the identity
        empty = np.abs(dense).sum(axis=1) == 0
        dense[empty, empty] = 1.0
        inv = np.linalg.inv(dense).astype(dtype)
        coarse_inv = jax.device_put(
            jnp.asarray(inv),
            NamedSharding(cur_A.mesh, P(cur_A.axis_name, None)))
    else:
        coarse_inv = None
    coarse_dinv = _dinv_dist(cur_A, diag)

    return AMGHierarchy(
        levels=levels,
        coarse_A=cur_A,
        coarse_inv=coarse_inv,
        coarse_dinv=coarse_dinv,
        coarse_lmax=lmax,
        coarse_lmin=lmax / max(band * band, 16.0),
        coarse_iters=coarse_iters,
        cycle=cycle,
        omega=omega,
    )


def _build_op(csr, mesh, fmt, dtype):
    """build_dist_matrix with a per-level ELL fallback: deep Galerkin
    coarse grids grow dense rows that can overflow WELL's slot cap — those
    levels are small, so the XLA ELL path is fine there."""
    try:
        kw = {"well_max_k": 128} if fmt.startswith("well") else {}
        if fmt.startswith("dia"):
            # Galerkin coarse grids of banded operators are near-dense
            # within their band (interval aggregation: measured >= 0.95
            # nnz per stored diagonal slot), so a wide DIA is the right
            # store even at hundreds of diagonals — but gate on density so
            # a scattered pattern can't allocate ndiags * nrows of junk
            lens = csr.row_nnz()
            rg = np.repeat(np.arange(csr.nrows, dtype=np.int64), lens)
            nd_ = len(np.unique(csr.colind.astype(np.int64) - rg))
            if nd_ and csr.nnz / (nd_ * max(csr.nrows, 1)) >= 0.3:
                kw = {"dia_max_diags": max(nd_, 64)}
        return build_dist_matrix(csr, mesh=mesh, local_format=fmt,
                                 dtype=dtype, **kw)
    except ValueError:
        if fmt == "ell":
            raise
        return build_dist_matrix(csr, mesh=mesh, local_format="ell",
                                 dtype=dtype)


def _padded_index(idx_g, ranges, pad):
    """Global index -> padded-global index (shard*pad + local)."""
    s = np.searchsorted(ranges, idx_g, side="right") - 1
    return s * pad + (idx_g - ranges[s])


def _level_diag(a: CSRHost):
    lens = a.row_nnz()
    rows_g = np.repeat(np.arange(a.nrows, dtype=np.int64), lens)
    on_diag = rows_g == a.colind
    # bincount, not ufunc.at (np.add.at is ~10x slower at 51M nnz)
    diag = np.bincount(rows_g[on_diag],
                       weights=a.values[on_diag].astype(np.float64),
                       minlength=a.nrows)
    lmax = _gershgorin_scaled(rows_g, a.colind, a.values, diag)
    return diag, lmax


def _dinv_dist(A: DistMatrix, diag: np.ndarray) -> jax.Array:
    nd = A.n_devices
    rp = A.row_pad
    ranges = owner_ranges(len(diag), nd)
    out = np.zeros((nd, rp), np.float64)
    for s in range(nd):
        r0, r1 = int(ranges[s]), int(ranges[s + 1])
        d = diag[r0:r1]
        out[s, : r1 - r0] = np.divide(1.0, d, out=np.zeros_like(d),
                                      where=d != 0)
    arr = out.reshape(nd * rp // LANES, LANES).astype(A.dtype
                      if A.dtype != np.float64 else np.float32)
    return jax.device_put(
        jnp.asarray(arr), NamedSharding(A.mesh, P(A.axis_name, None)))


def _make_level(A, diag, lmax, restrict, prolong, Pop, Rop, nc_pad,
                degree, band, interval=0, omega_p=0.0,
                omega_c=0.0, smoothed=True, stride=1,
                stride2=0) -> AMGLevel:
    spec2 = P(A.axis_name, None, None)
    return AMGLevel(
        A=A,
        dinv=_dinv_dist(A, diag),
        restrict_tab=None if restrict is None else jax.device_put(
            jnp.asarray(restrict), NamedSharding(A.mesh, spec2)),
        prolong_tab=None if prolong is None else jax.device_put(
            jnp.asarray(prolong), NamedSharding(A.mesh, P(A.axis_name, None))),
        P=Pop,
        R=Rop,
        lmax=lmax,
        lmin=lmax / band,
        nc_pad=nc_pad,
        degree=degree,
        interval=interval,
        omega_p=float(omega_p),
        omega_c=float(omega_c),
        smoothed=bool(smoothed),
        stride=int(stride),
        stride2=int(stride2),
    )


def amg_preconditioner(a: CSRHost, A: DistMatrix, **kw):
    """Convenience: ``(apply, hierarchy)`` for
    ``cg(..., preconditioner=apply)``. For jit boundaries, prefer passing
    the hierarchy as an argument and calling ``h.as_preconditioner()``
    inside."""
    h = amg_setup(a, A, **kw)
    return h.as_preconditioner(), h
