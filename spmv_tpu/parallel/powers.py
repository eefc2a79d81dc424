"""Matrix-powers kernel — communication-avoiding Krylov basis builder.

``cg_sstep`` reduced the REDUCTION count to one psum per s iterations, but
its basis build still pays s halo exchanges (one per matvec). This module
removes that second communication axis: fetch a DEPTH-s ghost region ONCE,
then build all s+1 Chebyshev basis vectors with purely local applies —
one ppermute round set + one psum per s iterations, the full
communication-avoiding Krylov recipe (the "matrix powers kernel" of
Demmel/Hoemmen/Mohiyuddin; reference LIBSPMV has neither the concept nor
the plan machinery — its L2GMap is strictly depth-1,
reference spmv/L2GMap.cpp:18-478).

How it works (per shard):

1. At PLAN time (host, once): BFS the sparsity pattern s hops outward
   from the owned row range. Hop sets F_1..F_s are this shard's extended
   ghosts; the extended operator is the rows of A for owned ∪ F_1..F_s
   with columns renumbered into the extended-local space
   [owned-padded | ghosts]. Column references that leave the extended
   space (possible only on hop-s rows) are DROPPED — see the validity
   argument below. The ghost exchange itself is an ordinary ``CommPlan``
   compiled over the depth-s ghost lists (same ppermute schedule
   machinery as the depth-1 halo, bigger payload).

2. At APPLY time (device, inside one ``shard_map``): ONE ``halo_gather``
   fills the extended tail, then s local ELL applies run the shifted-
   Chebyshev three-term recurrence on extended-length vectors. No
   masking is needed: after j applies, entries at hop distance > s-j are
   garbage, but garbage only propagates OUTWARD (row at hop h reads
   columns at hops <= h+1), so the OWNED slice of every basis vector
   v_0..v_s is exact. Each shard simply never reads the contaminated
   tail region it returns to nobody.

The validity argument is the standard MPK one; what JAX adds is that the
whole thing is one compiled SPMD program — the deep halo_gather is a
static ppermute schedule XLA can overlap with the first local apply, and
the local applies are gather+multiply-reduce ops with no collectives at
all (HLO-counted in tests/test_powers.py).

When to use: reduction- and halo-LATENCY-bound regimes (large meshes,
DCN-crossing pods) with sparsity whose s-hop ghost growth is modest —
banded/stencil operators grow ghosts LINEARLY in s (s * bandwidth rows
per boundary), which is the sweet spot. General scrambled sparsity can
blow the ghost set up exponentially; ``plan.nghost_pad`` (and
``powers_ghost_stats``) make the cost visible before you pay it — RCM
reordering (``spmv_tpu.reorder``) localizes the pattern first. The
collective counts are the contract the tests verify.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from spmv_tpu.formats.csr import CSRHost
from spmv_tpu.ops.spmv_dia import dia_apply
from spmv_tpu.parallel.comm_plan import (
    CommPlan,
    CommPlan2,
    _round_up,
    compile_plan,
    compile_plan_two_tier,
    halo_gather,
    halo_gather_two_tier,
)
from spmv_tpu.parallel.partition import owner_ranges


@dataclasses.dataclass
class PowersPlan:
    """Depth-s ghost plan + extended-local operator, stacked over the
    device axis.

    ELL realization (``local_format='ell'``, works for any sparsity):
      colind/values: (D, next_pad, K) — extended operator rows in the
      extended-local vector layout [owned (col_pad) | ghosts
      (nghost_pad)]; padding slots carry value 0 (colind 0, harmless).

    DIA realization (``local_format='dia'``, banded operators — the
    chip-speed path): the extended window is the CONTIGUOUS global range
    around the owned block under the affine map pos(g) = gl_pad + g - r0,
    which preserves every diagonal offset exactly, so the extended block
    is one per-shard ``DiaMatrix`` applied by the DIA apply (ops.spmv_dia).
      dia_data: (D, dia_rows/128, K*128) row-interleaved lane layout
      ghost_pos: (D, nghost_pad) — xe positions the sorted ghost buffer
      scatters into (OOB padding slots drop)
    """

    colind: jax.Array
    values: jax.Array
    plan: CommPlan
    dia_data: jax.Array | None
    ghost_pos: jax.Array | None
    s: int
    next_pad: int
    mesh: object
    axis_name: str
    local_format: str = "ell"
    dia_offsets: tuple = ()
    gl_pad: int = 0
    dia_rows: int = 0


jax.tree_util.register_dataclass(
    PowersPlan,
    data_fields=["colind", "values", "plan", "dia_data", "ghost_pos"],
    meta_fields=["s", "next_pad", "mesh", "axis_name", "local_format",
                 "dia_offsets", "gl_pad", "dia_rows"],
)


def _expand_rows(rowptr: np.ndarray, rows: np.ndarray):
    """Indices into colind/values for the given rows, plus the per-row
    repeat vector (vectorized CSR row gather)."""
    starts = rowptr[rows]
    cnt = (rowptr[rows + 1] - starts).astype(np.int64)
    total = int(cnt.sum())
    if total == 0:
        return np.empty(0, np.int64), cnt
    # idx = concat(arange(starts[i], starts[i]+cnt[i]))
    off = np.repeat(np.cumsum(cnt) - cnt, cnt)
    idx = np.repeat(starts, cnt) + (np.arange(total) - off)
    return idx, cnt


def _classify_ext_cols(a, ext_ids, r0, r1, ghosts, dtype):
    """Expand the extended rows of ``a`` and classify each entry's column
    against [r0, r1) ∪ ghosts. Entries referencing columns OUTSIDE the
    extended space occur only on hop-s rows, whose values are never
    validly read — ``keep`` drops them. Shared by the ELL and DIA
    realizations so the hop-(s+1) drop logic has one implementation.

    Returns (cnt, gcols, gvals, owned, gclip, keep): per-ext-row entry
    counts, global columns/values, owned mask, the clipped ghost-list
    position of each column, and the keep mask."""
    ng = len(ghosts)
    idx, cnt = _expand_rows(a.rowptr, ext_ids)
    gcols = a.colind[idx].astype(np.int64)
    gvals = a.values[idx].astype(dtype)
    owned = (gcols >= r0) & (gcols < r1)
    if ng:
        gpos = np.searchsorted(ghosts, gcols)
        gclip = np.minimum(gpos, ng - 1)
        hit = (~owned) & (ghosts[gclip] == gcols)
    else:
        gclip = np.zeros(len(gcols), np.int64)
        hit = np.zeros(len(gcols), bool)
    return cnt, gcols, gvals, owned, gclip, owned | hit


def build_powers_plan(a: CSRHost, A, s: int,
                      local_format: str = "auto") -> PowersPlan:
    """Compile the depth-``s`` matrix-powers plan for the square operator
    ``a`` distributed as ``A`` (a ``DistMatrix`` built from the same
    host matrix; used for mesh/layout/dtype). Works on 1-D meshes and on
    two-tier (dcn, ici) meshes — the deep ghosts then ride the same
    dcn-first two-tier schedule as the operator's own halo. Host-side,
    vectorized numpy; call once at assembly time like ``fsai_setup``/
    ``amg_setup``. The resulting plan is a pytree — pass it through jit
    as an argument.

    ``local_format``: 'ell' (any sparsity, XLA gather applies), 'dia'
    (banded operators — the extended block rides the DIA apply; raises if
    the union of diagonal offsets exceeds 64), or
    'auto' (default: 'dia' when the distributed operator itself uses DIA
    local blocks and the extended window stays banded, else 'ell')."""
    if a.nrows != a.ncols:
        raise ValueError("matrix powers need a square operator")
    if s < 1:
        raise ValueError(f"s must be >= 1, got {s}")
    two_tier = isinstance(A.plan, CommPlan2)
    n = a.nrows
    D = A.n_devices
    col_pad = A.col_pad
    dtype = A.dtype
    ranges = owner_ranges(n, D)

    # --- BFS hop sets per shard ---
    ghost_lists: list[np.ndarray] = []
    for sh in range(D):
        r0, r1 = int(ranges[sh]), int(ranges[sh + 1])
        seen = np.arange(r0, r1, dtype=np.int64)
        cur = seen
        levels = []
        for _hop in range(s):
            idx, _ = _expand_rows(a.rowptr, cur)
            if len(idx) == 0:
                break
            nb = np.unique(a.colind[idx].astype(np.int64))
            new = np.setdiff1d(nb, seen, assume_unique=True)
            if len(new) == 0:
                break
            levels.append(new)
            seen = np.union1d(seen, new)
            cur = new
        ghosts = (np.sort(np.concatenate(levels))
                  if levels else np.empty(0, np.int64))
        ghost_lists.append(ghosts)

    if two_tier:
        # same BFS ghosts, two-tier schedule: dcn-first rounds over the
        # (dcn, ici) factorization the operator's own plan uses
        plan = compile_plan_two_tier(ranges, ghost_lists,
                                     n_dcn=A.plan.n_dcn,
                                     n_ici=A.plan.n_ici,
                                     row_align=col_pad)
    else:
        plan = compile_plan(ranges, ghost_lists, row_align=col_pad)
    assert plan.nlocal_pad == col_pad, (plan.nlocal_pad, col_pad)
    next_pad = col_pad + plan.nghost_pad

    if local_format not in ("auto", "ell", "dia"):
        raise ValueError(f"unknown local_format {local_format!r}")
    want_dia = (local_format == "dia"
                or (local_format == "auto"
                    and getattr(A, "local_format", "") == "dia"))
    if want_dia:
        built = _build_dia_powers(a, A, s, ranges, ghost_lists, plan,
                                  col_pad, dtype,
                                  strict=local_format == "dia")
        if built is not None:
            return built

    # --- extended-local ELL operator per shard ---
    per_shard = []
    K = 1
    for sh in range(D):
        r0, r1 = int(ranges[sh]), int(ranges[sh + 1])
        ghosts = ghost_lists[sh]
        ng = len(ghosts)
        ext_ids = np.concatenate([np.arange(r0, r1, dtype=np.int64), ghosts])
        xe_pos = np.concatenate([
            np.arange(r1 - r0, dtype=np.int64),
            col_pad + np.arange(ng, dtype=np.int64),
        ])
        cnt, gcols, gvals, owned, gclip, keep = _classify_ext_cols(
            a, ext_ids, r0, r1, ghosts, dtype)
        rows_rep = np.repeat(xe_pos, cnt)
        lcols = np.where(owned, gcols - r0, col_pad + gclip)
        rows_rep, lcols, gvals = rows_rep[keep], lcols[keep], gvals[keep]
        kc = np.bincount(rows_rep, minlength=next_pad).astype(np.int64)
        K = max(K, int(kc.max()) if len(kc) else 1)
        per_shard.append((rows_rep, lcols, gvals, kc))

    colind = np.zeros((D, next_pad, K), np.int32)
    values = np.zeros((D, next_pad, K), dtype)
    for sh, (rows_rep, lcols, gvals, kc) in enumerate(per_shard):
        if len(rows_rep) == 0:
            continue
        order = np.argsort(rows_rep, kind="stable")
        rs = rows_rep[order]
        row_start = np.cumsum(kc) - kc  # first slot index of each row
        slot = np.arange(len(rs)) - row_start[rs]
        colind[sh, rs, slot] = lcols[order].astype(np.int32)
        values[sh, rs, slot] = gvals[order]

    return PowersPlan(
        colind=jnp.asarray(colind),
        values=jnp.asarray(values),
        plan=plan,
        dia_data=None,
        ghost_pos=None,
        s=s,
        next_pad=next_pad,
        mesh=A.mesh,
        axis_name=A.axis_name,
        local_format="ell",
    )


def _build_dia_powers(a, A, s, ranges, ghost_lists, plan, col_pad, dtype,
                      strict: bool):
    """DIA realization of the extended operator (see PowersPlan). Returns
    None when the window is not banded enough (> 64 diagonals) and
    ``strict`` is False — the caller then falls back to ELL."""
    D = len(ghost_lists)
    OOBi = np.int32(2**31 - 1)
    gl_needed = []
    right_span = []
    for sh in range(D):
        r0, r1 = int(ranges[sh]), int(ranges[sh + 1])
        g = ghost_lists[sh]
        gl_needed.append(int(r0 - g.min()) if len(g) and g.min() < r0 else 0)
        gr = int(g.max() + 1 - r1) if len(g) and g.max() >= r1 else 0
        right_span.append(r1 - r0 + gr)
    # 128-row alignment: the window is applied in the (rows, 128) lane layout
    gl_pad = _round_up(max(gl_needed), 128)
    L = gl_pad + _round_up(max(max(right_span), col_pad), 128)

    # entry lists in window coordinates; the affine pos(g) = gl_pad + g - r0
    # preserves diagonal offsets EXACTLY (pcol - prow = gcol - grow)
    per_shard = []
    all_offs = []
    for sh in range(D):
        r0, r1 = int(ranges[sh]), int(ranges[sh + 1])
        ghosts = ghost_lists[sh]
        ext_ids = np.concatenate([np.arange(r0, r1, dtype=np.int64), ghosts])
        cnt, gcols, gvals, _owned, _gclip, keep = _classify_ext_cols(
            a, ext_ids, r0, r1, ghosts, dtype)
        grow = np.repeat(ext_ids, cnt)
        prow = gl_pad + grow[keep] - r0
        offs = (gcols - grow)[keep]
        per_shard.append((prow, offs, gvals[keep]))
        all_offs.append(np.unique(offs))

    union = np.unique(np.concatenate(all_offs)) if all_offs else np.array([0])
    if len(union) > 64:
        if strict:
            raise ValueError(
                f"extended window has {len(union)} distinct diagonals; "
                "local_format='dia' powers plans are for banded operators")
        return None
    kd = max(len(union), 1)
    dd = np.zeros((D, kd, L), dtype=dtype)
    for sh, (prow, offs, vals) in enumerate(per_shard):
        if len(prow) == 0:
            continue
        dsel = np.searchsorted(union, offs)
        key = dsel * np.int64(L) + prow
        if np.iscomplexobj(dd):
            # bincount weights must be real — split like _csr_to_dia_host
            acc = (np.bincount(key, weights=vals.real, minlength=kd * L)
                   + 1j * np.bincount(key, weights=vals.imag,
                                      minlength=kd * L))
        else:
            acc = np.bincount(key, weights=vals, minlength=kd * L)
        dd[sh] += acc.reshape(kd, L).astype(dd.dtype)
    dia_data = (dd.reshape(D, kd, L // 128, 128)
                .transpose(0, 2, 1, 3)
                .reshape(D, L // 128, kd * 128))

    ghost_pos = np.full((D, max(plan.nghost_pad, 1)), OOBi, np.int32)
    for sh in range(D):
        g = ghost_lists[sh]
        if len(g):
            ghost_pos[sh, : len(g)] = (gl_pad + g - int(ranges[sh])).astype(
                np.int32)

    return PowersPlan(
        colind=jnp.zeros((D, 1, 1), jnp.int32),
        values=jnp.zeros((D, 1, 1), dd.dtype),
        plan=plan,
        dia_data=jnp.asarray(dia_data),
        ghost_pos=jnp.asarray(ghost_pos),
        s=s,
        next_pad=col_pad + plan.nghost_pad,
        mesh=A.mesh,
        axis_name=A.axis_name,
        local_format="dia",
        dia_offsets=tuple(int(o) for o in union),
        gl_pad=gl_pad,
        dia_rows=L,
    )


def powers_ghost_stats(pp: PowersPlan, A) -> dict:
    """Cost visibility: depth-s ghost volume vs the operator's depth-1
    halo. A growth factor ~s means stencil-like sparsity (MPK sweet
    spot); much larger means the pattern defeats the trade."""
    if pp.local_format == "dia":
        ext_rows = pp.dia_rows
        nnz_slots = len(pp.dia_offsets) * pp.dia_rows
    else:
        ext_rows = pp.next_pad
        nnz_slots = int(pp.values.shape[1] * pp.values.shape[2])
    return {
        "s": pp.s,
        "nghost_pad_depth_s": pp.plan.nghost_pad,
        "nghost_pad_depth_1": A.plan.nghost_pad,
        "growth": (pp.plan.nghost_pad / max(A.plan.nghost_pad, 1)),
        "ext_rows_pad": ext_rows,
        "ext_nnz_slots": nnz_slots,
    }


def chebyshev_powers_basis(pp: PowersPlan, x: jax.Array, c, e) -> jax.Array:
    """The s+1 shifted-Chebyshev Krylov basis vectors of ``x`` in the
    distributed lane layout — with ONE halo exchange total.

    Returns ``V`` of shape (s+1, *x.shape); ``V[j]`` equals the naive
    ``v_{j+1} = 2((A - c)/e) v_j - v_{j-1}`` recurrence built with s
    separate halo-exchanged matvecs (tests pin the equivalence). Use as
    ``cg_sstep(..., basis_builder=lambda r, c, e:
    chebyshev_powers_basis(pp, r, c, e))`` with matching ``s``."""

    def recur(xe, apply_op):
        cc = jnp.asarray(c, xe.dtype)
        ee = jnp.asarray(e, xe.dtype)
        vs = [xe, (apply_op(xe) - cc * xe) / ee]
        for _ in range(1, pp.s):
            vs.append(2 * (apply_op(vs[-1]) - cc * vs[-1]) / ee - vs[-2])
        return vs

    return _powers_basis(pp, x, recur)


def newton_powers_basis(pp: PowersPlan, x: jax.Array, ops) -> jax.Array:
    """The s+1 Leja-ordered NEWTON basis vectors of ``x`` — one halo
    exchange total, same extended-operator machinery as
    ``chebyshev_powers_basis`` but running the real Newton recurrence
    ``v_{j+1} = (A v_j - alpha_j v_j + gamma_j v_{j-1}) / sigma_j`` from
    the static ``ops`` of ``solvers/newton_basis.newton_basis_ops``
    (``len(ops)`` must equal the plan depth ``s``). The off-axis-spectrum
    CA-GMRES configuration: ``gmres_sstep(..., shifts=ritz,
    basis_builder=lambda q: newton_powers_basis(pp, q, ops))``.

    Validity is the same MPK garbage-propagation argument as Chebyshev
    (module docstring) — shifted applies and the 3-term pair coupling
    read at most one hop outward per step."""
    if len(ops) != pp.s:
        raise ValueError(
            f"ops length {len(ops)} != plan depth s={pp.s}")
    if ops and ops[0][1] != 0.0:
        raise ValueError("ops[0] must have gamma == 0 (a conjugate pair "
                         "cannot START the recurrence); got "
                         f"gamma={ops[0][1]!r}")

    def recur(xe, apply_op):
        vs = [xe]
        for alpha, gamma, sigma in ops:
            w = apply_op(vs[-1]) - jnp.asarray(alpha, xe.dtype) * vs[-1]
            if gamma != 0.0:
                w = w + jnp.asarray(gamma, xe.dtype) * vs[-2]
            vs.append(w / jnp.asarray(sigma, xe.dtype))
        return vs

    return _powers_basis(pp, x, recur)


def _powers_basis(pp: PowersPlan, x: jax.Array, recur) -> jax.Array:
    """Shared MPK execution: one deep halo_gather, then ``recur(xe,
    apply_op) -> [v_0..v_s]`` on extended-length vectors, owned slices
    returned stacked as (s+1, *x.shape)."""
    spec = P(pp.axis_name, None)
    mspec3 = P(pp.axis_name, None, None)
    plan = pp.plan
    two_tier = isinstance(plan, CommPlan2)
    axes = (pp.axis_name if isinstance(pp.axis_name, tuple)
            else (pp.axis_name,))
    tables = ((plan.ici_send_idx, plan.ici_recv_pos,
               plan.dcn_send_idx, plan.dcn_recv_pos)
              if two_tier else (plan.send_idx, plan.recv_pos))

    def gather(xf, tabs):
        if two_tier:
            return halo_gather_two_tier(
                xf, *tabs, plan.rounds_ici, plan.rounds_dcn,
                plan.n_dcn, plan.n_ici, plan.nghost_pad, axes[0], axes[1])
        return halo_gather(xf, tabs[0], tabs[1], plan.rounds,
                           plan.n_devices, plan.nghost_pad, axes[0])

    if pp.local_format == "dia":
        def per_shard_dia(x_s, dd, gpos, nloc, *tabs):
            dd, gpos, nloc = dd[0], gpos[0], nloc[0]
            tabs = tuple(t[0] for t in tabs)
            xf = x_s.reshape(-1)  # (col_pad,)
            g = gather(xf, tabs)
            xe = jnp.zeros((pp.dia_rows,), xf.dtype)
            # owned block lands at the affine window position; the sorted
            # ghost buffer scatters to pos(g) = gl_pad + g - r0 (padding
            # slots drop). The owned write goes FIRST: its padding tail
            # [nl, col_pad) overlaps the right-ghost region, which the
            # scatter then overwrites with real values.
            xe = jax.lax.dynamic_update_slice(xe, xf, (pp.gl_pad,))
            if plan.nghost_pad:
                xe = xe.at[gpos].set(g, mode="drop")
            def apply_op(v):
                return dia_apply(dd, pp.dia_offsets,
                                 v.reshape(-1, 1, 128)).reshape(-1)

            vs = recur(xe, apply_op)
            own = (jnp.arange(xf.shape[0]) < nloc).astype(xf.dtype)
            V = jnp.stack([
                jax.lax.dynamic_slice(v, (pp.gl_pad,), (xf.shape[0],)) * own
                for v in vs])
            return V.reshape((pp.s + 1,) + x_s.shape)

        return jax.shard_map(
            per_shard_dia,
            mesh=pp.mesh,
            in_specs=(spec, mspec3, P(pp.axis_name, None),
                      P(pp.axis_name)) + (mspec3,) * len(tables),
            out_specs=P(None, pp.axis_name, None),
            check_vma=False,
        )(x, pp.dia_data, pp.ghost_pos, plan.nlocal, *tables)

    def per_shard(x_s, ci, vals, *tabs):
        ci, vals = ci[0], vals[0]
        tabs = tuple(t[0] for t in tabs)
        xf = x_s.reshape(-1)  # (col_pad,)
        g = gather(xf, tabs)
        xe = jnp.concatenate([xf, g])

        def ell(v):
            # gather + multiply-reduce, exact at storage precision
            return jnp.einsum("rk,rk->r", vals, jnp.take(v, ci, axis=0),
                              precision=jax.lax.Precision.HIGHEST)

        vs = recur(xe, ell)
        V = jnp.stack([v[: xf.shape[0]] for v in vs])  # owned slices
        return V.reshape((pp.s + 1,) + x_s.shape)

    return jax.shard_map(
        per_shard,
        mesh=pp.mesh,
        in_specs=(spec, mspec3, mspec3) + (mspec3,) * len(tables),
        out_specs=P(None, pp.axis_name, None),
        check_vma=False,
    )(x, pp.colind, pp.values, *tables)
