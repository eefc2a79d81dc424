"""CommPlan — the compiled halo-exchange schedule (the L2GMap rebuilt).

The reference's L2GMap (reference spmv/L2GMap.cpp, 1018 LoC) implements 8
MPI communication models for one logical operation: deliver each shard's
ghost values from their owners into the vector's ghost tail (forward), and
accumulate ghost-tail values back into their owners (reverse). Here all 8
models collapse into ONE mechanism (SURVEY.md section 5): at assembly time
the ghost pattern is compiled into a static schedule of ``ppermute`` rounds
over the mesh axis; XLA lowers these to device-to-device sends (NCCL on
GPUs), and comm/compute overlap is obtained by program order + the latency-hiding scheduler rather than by
nonblocking-MPI plumbing.

Plan compilation mirrors L2GMap's constructor (reference spmv/L2GMap.cpp:18,
:351-478): ownership ranges, per-ghost owner lookup, symmetrized neighbor
discovery, and the owner-side index buffer ("which of my locals do I send") —
but done once in vectorized numpy on the host, with all counts padded to
static per-round maxima so the executed program is shape-static SPMD.

Execution model per round (offset d): every device src gathers its send
values, ``ppermute``s them to (src+d) % n, and the receiver scatters them
into its ghost buffer. Padding slots carry an out-of-bounds position and are
dropped by the scatter (forward) or gather-filled with 0 (reverse), so no
masks are materialized.

Layout note: the reference appends ghosts as a tail of the owned vector
("padded vectors", reference spmv/cg.cpp:36-42). Here ghosts live in a
SEPARATE buffer instead: the local-block SpMV then has no data dependence on
the halo exchange at all, so XLA's scheduler is free to overlap the ppermute
rounds with the interior kernel — the reference needs nonblocking MPI plus
an explicit update_finalise call for the same effect
(reference spmv/Matrix.cpp:498-511, spmv/L2GMap.cpp:528-561).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from spmv_tpu.parallel.partition import owner_of

OOB = np.int32(2**31 - 1)  # scatter-drop sentinel for padding slots


@dataclasses.dataclass
class CommPlan:
    """Static halo-exchange schedule for a 1-D device mesh axis.

    Stacked over the device axis (leading dim = n_devices) so it shards with
    everything else:
      send_idx: (D, R, S) int32 — owned-local indices each device gathers to
                send in round r (pad = 0; harmless, dropped at receiver)
      recv_pos: (D, R, S) int32 — positions in the ghost buffer where round
                r's received values land (pad = OOB -> dropped)
      nlocal:   (D,) int32 — logical owned size per shard (varies by +-1)
      nghosts:  (D,) int32 — logical ghost count per shard
    Static:
      rounds:     tuple of ppermute offsets d (src -> (src+d) % D)
      n_devices, nlocal_pad, nghost_pad
    """

    send_idx: jax.Array
    recv_pos: jax.Array
    nlocal: jax.Array
    nghosts: jax.Array
    rounds: tuple[int, ...]
    n_devices: int
    nlocal_pad: int
    nghost_pad: int


jax.tree_util.register_dataclass(
    CommPlan,
    data_fields=["send_idx", "recv_pos", "nlocal", "nghosts"],
    meta_fields=["rounds", "n_devices", "nlocal_pad", "nghost_pad"],
)


def plan_stats(plan) -> dict:
    """Round-count / padding accounting for a CommPlan or CommPlan2.

    The schedule serializes one ppermute per distinct ring offset, each
    padded to the round's global max transfer — a scattered pattern can cost
    many rounds of mostly-padding. ``compile_plan`` logs a warning above
    thresholds; this returns the numbers: total transfer slots, real
    (non-padding) slots, and the waste fraction.
    """
    import numpy as _np

    tabs = []
    if hasattr(plan, "recv_pos"):
        tabs.append(_np.asarray(plan.recv_pos))
    else:
        tabs += [_np.asarray(plan.ici_recv_pos), _np.asarray(plan.dcn_recv_pos)]
    return _stats_from_tables(len(plan.rounds), tabs)


def _stats_from_tables(n_rounds: int, tabs) -> dict:
    slots = sum(t.size for t in tabs)
    real = sum(int((t != OOB).sum()) for t in tabs)
    return {
        "rounds": n_rounds,
        "slots": slots,
        "real": real,
        "padding_waste": 0.0 if slots == 0 else 1.0 - real / slots,
    }


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def compile_plan(
    ranges: np.ndarray,
    ghost_lists: list[np.ndarray],
    row_align: int = 8,
) -> CommPlan:
    """Compile ghost index lists into a CommPlan.

    ranges: (D+1,) ownership prefix array (partition.owner_ranges)
    ghost_lists[s]: sorted global indices shard s needs but does not own
                    (ghosts inside the owned range are an error, as in
                    reference spmv/L2GMap.cpp:371-372)
    """
    n = len(ghost_lists)
    assert len(ranges) == n + 1
    # requirements[(owner, dest)] = global indices dest needs from owner
    reqs: dict[tuple[int, int], np.ndarray] = {}
    for s, ghosts in enumerate(ghost_lists):
        ghosts = np.asarray(ghosts, dtype=np.int64)
        if len(ghosts) == 0:
            continue
        if np.any((ghosts >= ranges[s]) & (ghosts < ranges[s + 1])):
            raise ValueError(f"shard {s}: ghost index inside owned range")
        if np.any(ghosts < 0) or np.any(ghosts >= ranges[-1]):
            raise ValueError(f"shard {s}: ghost index outside global range")
        owners = owner_of(ranges, ghosts)
        for o in np.unique(owners):
            reqs[(int(o), s)] = ghosts[owners == o]

    # Rounds: distinct ring offsets present in the (owner -> dest) graph.
    rounds = sorted({(d - o) % n for (o, d) in reqs})
    nlocal = np.diff(ranges).astype(np.int32)
    nghosts = np.array([len(g) for g in ghost_lists], dtype=np.int32)
    nlocal_pad = max(_round_up(int(nlocal.max()), row_align), row_align)
    nghost_pad = max(_round_up(int(nghosts.max()), row_align), row_align) if nghosts.max() else 0

    # Per-round padded send/recv tables.
    max_send = {
        r: max(
            (len(v) for (o, d), v in reqs.items() if (d - o) % n == r), default=0
        )
        for r in rounds
    }
    nr = len(rounds)
    smax = max(max_send.values(), default=0)
    send_idx = np.zeros((n, nr, smax), dtype=np.int32)
    recv_pos = np.full((n, nr, smax), OOB, dtype=np.int32)
    for (o, d), glob in reqs.items():
        r = rounds.index((d - o) % n)
        c = len(glob)
        send_idx[o, r, :c] = (glob - ranges[o]).astype(np.int32)
        # receiver scatters into its ghost buffer at the ghost-list position
        gpos = np.searchsorted(ghost_lists[d], glob)
        recv_pos[d, r, :c] = gpos.astype(np.int32)

    plan = CommPlan(
        send_idx=jnp.asarray(send_idx),
        recv_pos=jnp.asarray(recv_pos),
        nlocal=jnp.asarray(nlocal),
        nghosts=jnp.asarray(nghosts),
        rounds=tuple(rounds),
        n_devices=n,
        nlocal_pad=nlocal_pad,
        nghost_pad=nghost_pad,
    )
    # warn from the HOST tables: plan_stats(plan) would round-trip the
    # just-uploaded device arrays back to the host
    _warn_if_inefficient(_stats_from_tables(len(rounds), [recv_pos]))
    return plan


def _warn_if_inefficient(s: dict) -> None:
    """Accounting guard: many serialized rounds or heavy per-round padding
    mean the ghost pattern maps poorly onto ring offsets (e.g. a general
    matrix before reordering) — surface it instead of silently paying it."""
    import logging
    if s["rounds"] > 8 or (s["rounds"] > 1 and s["padding_waste"] > 0.75):
        logging.getLogger("spmv_tpu").warning(
            "halo plan: %d ppermute rounds, %.0f%% of transfer slots are "
            "padding (%d real / %d total). Consider RCM reordering "
            "(spmv_tpu.reorder.rcm_reorder) to localize the ghost pattern.",
            s["rounds"], 100 * s["padding_waste"], s["real"], s["slots"],
        )


# ---------------------------------------------------------------------------
# Execution — these run INSIDE shard_map; array args are per-device views
# (leading device axis already stripped by the caller's in_specs).
# ---------------------------------------------------------------------------


def _perm(n: int, d: int) -> list[tuple[int, int]]:
    return [(j, (j + d) % n) for j in range(n)]


def halo_gather(
    x: jax.Array,          # (nlocal_pad,) owned values
    send_idx: jax.Array,   # (R, S)
    recv_pos: jax.Array,   # (R, S)
    rounds: tuple[int, ...],
    n_devices: int,
    nghost_pad: int,
    axis_name: str = "shards",
) -> jax.Array:
    """Forward halo exchange: build this shard's ghost buffer from owners.

    The analogue of L2GMap::update (reference spmv/L2GMap.cpp:501-526):
    device-side gather into the send buffer (= gather_ghosts_run,
    reference_executor.cpp:150-164) then one collective per round landing
    directly in the ghost buffer. Returns the (nghost_pad,) ghost values.

    Block-capable: x may be (nlocal_pad, nrhs) — each round then moves the
    whole block in ONE ppermute (nrhs times the payload instead of nrhs
    separate collectives; latency-bound halo rounds amortize).
    """
    g = jnp.zeros((nghost_pad,) + x.shape[1:], dtype=x.dtype)
    for i, d in enumerate(rounds):
        buf = jnp.take(x, send_idx[i], axis=0)
        buf = jax.lax.ppermute(buf, axis_name, perm=_perm(n_devices, d))
        g = g.at[recv_pos[i]].set(buf, mode="drop")
    return g


def halo_scatter_add(
    gz: jax.Array,         # (nghost_pad,) ghost-slot contributions
    y: jax.Array,          # (nlocal_pad,) owned accumulator
    send_idx: jax.Array,
    recv_pos: jax.Array,
    rounds: tuple[int, ...],
    n_devices: int,
    axis_name: str = "shards",
) -> jax.Array:
    """Reverse halo exchange: route ghost-slot contributions back to their
    owners and ACCUMULATE into the owned entries — the scatter-add semantics
    of L2GMap::reverse_update (reference spmv/L2GMap.cpp:907-959), here
    implemented for every schedule (the reference covers only 2 of its 8 comm
    models, spmv/L2GMap.cpp:955-958). Used by the symmetric-matrix remote
    reduce-scatter and by transpose products.
    """
    for i, d in enumerate(rounds):
        # read my ghost contributions (padding slots gather-fill 0)
        buf = gz.at[recv_pos[i]].get(mode="fill", fill_value=0)
        buf = jax.lax.ppermute(buf, axis_name, perm=_perm(n_devices, (-d) % n_devices))
        # accumulate at the owner (padding adds 0 at index 0 — harmless)
        y = y.at[send_idx[i]].add(buf, mode="promise_in_bounds")
    return y


# ---------------------------------------------------------------------------
# Two-tier (ICI/DCN) plans — the multi-slice analogue of the reference's
# on-node shared-memory vs off-node split (reference spmv/L2GMap.cpp:723-865:
# shmem windows intra-node, Neighbor_alltoallv off-node). On a 2-D
# (slow, fast) mesh — hosts x cards per host — the fast tier ("ici") is the
# in-host axis and the slow tier ("dcn") the cross-host axis: pairs within
# one host exchange on the fast axis only; pairs crossing hosts route
# slow-axis-first (one ppermute hop per axis). Slow-axis rounds are issued
# FIRST so their long-latency transfers overlap both the fast rounds and
# the interior SpMV.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CommPlan2:
    """Static two-tier halo-exchange schedule for a (dcn, ici) 2-D mesh.

    Devices flatten as d = dcn * n_ici + ici (the P((dcn_axis, ici_axis))
    sharding order). Tables are stacked over the flat device axis:
      ici_send_idx/ici_recv_pos: (D, Ri, Si) — same-slice rounds (ici ring
          offset per round)
      dcn_send_idx/dcn_recv_pos: (D, Rd, Sd) — cross-slice rounds, keyed by
          (dcn ring offset, ici ring offset); executed as a dcn-axis
          ppermute followed (when the ici offset is nonzero) by an ici-axis
          ppermute
    """

    ici_send_idx: jax.Array
    ici_recv_pos: jax.Array
    dcn_send_idx: jax.Array
    dcn_recv_pos: jax.Array
    nlocal: jax.Array
    nghosts: jax.Array
    rounds_ici: tuple[int, ...]
    rounds_dcn: tuple[tuple[int, int], ...]
    n_dcn: int
    n_ici: int
    nlocal_pad: int
    nghost_pad: int

    @property
    def n_devices(self) -> int:
        return self.n_dcn * self.n_ici

    @property
    def rounds(self) -> tuple:
        """All rounds (for diagnostics), DCN tier first."""
        return tuple(self.rounds_dcn) + tuple(self.rounds_ici)


jax.tree_util.register_dataclass(
    CommPlan2,
    data_fields=["ici_send_idx", "ici_recv_pos", "dcn_send_idx",
                 "dcn_recv_pos", "nlocal", "nghosts"],
    meta_fields=["rounds_ici", "rounds_dcn", "n_dcn", "n_ici",
                 "nlocal_pad", "nghost_pad"],
)


def compile_plan_two_tier(
    ranges: np.ndarray,
    ghost_lists: list[np.ndarray],
    n_dcn: int,
    n_ici: int,
    row_align: int = 8,
) -> CommPlan2:
    """Compile ghost index lists into a two-tier CommPlan2 (see CommPlan /
    compile_plan for the single-tier semantics this extends)."""
    n = n_dcn * n_ici
    assert len(ghost_lists) == n and len(ranges) == n + 1
    reqs: dict[tuple[int, int], np.ndarray] = {}
    for s, ghosts in enumerate(ghost_lists):
        ghosts = np.asarray(ghosts, dtype=np.int64)
        if len(ghosts) == 0:
            continue
        if np.any((ghosts >= ranges[s]) & (ghosts < ranges[s + 1])):
            raise ValueError(f"shard {s}: ghost index inside owned range")
        if np.any(ghosts < 0) or np.any(ghosts >= ranges[-1]):
            raise ValueError(f"shard {s}: ghost index outside global range")
        owners = owner_of(ranges, ghosts)
        for o in np.unique(owners):
            reqs[(int(o), s)] = ghosts[owners == o]

    def tier_key(o: int, d: int) -> tuple[int, int]:
        od, oi = divmod(o, n_ici)
        dd, di = divmod(d, n_ici)
        return ((dd - od) % n_dcn, (di - oi) % n_ici)

    ici_reqs = {k: v for k, v in reqs.items() if tier_key(*k)[0] == 0}
    dcn_reqs = {k: v for k, v in reqs.items() if tier_key(*k)[0] != 0}

    rounds_ici = sorted({tier_key(o, d)[1] for (o, d) in ici_reqs})
    rounds_dcn = sorted({tier_key(o, d) for (o, d) in dcn_reqs})

    nlocal = np.diff(ranges).astype(np.int32)
    nghosts = np.array([len(g) for g in ghost_lists], dtype=np.int32)
    nlocal_pad = max(_round_up(int(nlocal.max()), row_align), row_align)
    nghost_pad = (max(_round_up(int(nghosts.max()), row_align), row_align)
                  if nghosts.max() else 0)

    def build_tables(tier_reqs, rounds, key_fn):
        nr = len(rounds)
        smax = 0
        for (o, d), v in tier_reqs.items():
            smax = max(smax, len(v))
        si = np.zeros((n, max(nr, 1), max(smax, 1)), dtype=np.int32)
        rp = np.full((n, max(nr, 1), max(smax, 1)), OOB, dtype=np.int32)
        for (o, d), glob in tier_reqs.items():
            r = rounds.index(key_fn(o, d))
            c = len(glob)
            si[o, r, :c] = (glob - ranges[o]).astype(np.int32)
            gpos = np.searchsorted(ghost_lists[d], glob)
            rp[d, r, :c] = gpos.astype(np.int32)
        return si, rp

    ici_si, ici_rp = build_tables(
        ici_reqs, rounds_ici, lambda o, d: tier_key(o, d)[1]
    )
    dcn_si, dcn_rp = build_tables(dcn_reqs, rounds_dcn, tier_key)

    plan2 = CommPlan2(
        ici_send_idx=jnp.asarray(ici_si),
        ici_recv_pos=jnp.asarray(ici_rp),
        dcn_send_idx=jnp.asarray(dcn_si),
        dcn_recv_pos=jnp.asarray(dcn_rp),
        nlocal=jnp.asarray(nlocal),
        nghosts=jnp.asarray(nghosts),
        rounds_ici=tuple(rounds_ici),
        rounds_dcn=tuple(rounds_dcn),
        n_dcn=n_dcn,
        n_ici=n_ici,
        nlocal_pad=nlocal_pad,
        nghost_pad=nghost_pad,
    )
    _warn_if_inefficient(
        _stats_from_tables(len(rounds_dcn) + len(rounds_ici),
                           [ici_rp, dcn_rp]))
    return plan2


def halo_gather_two_tier(
    x: jax.Array,
    ici_si: jax.Array, ici_rp: jax.Array,
    dcn_si: jax.Array, dcn_rp: jax.Array,
    rounds_ici: tuple[int, ...],
    rounds_dcn: tuple[tuple[int, int], ...],
    n_dcn: int, n_ici: int,
    nghost_pad: int,
    dcn_axis: str = "dcn",
    ici_axis: str = "ici",
) -> jax.Array:
    """Two-tier forward halo exchange. DCN rounds are issued first: their
    sends have the longest latency and overlap the ICI rounds and the
    interior kernel in program order. Block-capable like halo_gather."""
    g = jnp.zeros((nghost_pad,) + x.shape[1:], dtype=x.dtype)
    for i, (dd, di) in enumerate(rounds_dcn):
        buf = jnp.take(x, dcn_si[i], axis=0)
        buf = jax.lax.ppermute(buf, dcn_axis, perm=_perm(n_dcn, dd))
        if di != 0:
            buf = jax.lax.ppermute(buf, ici_axis, perm=_perm(n_ici, di))
        g = g.at[dcn_rp[i]].set(buf, mode="drop")
    for i, d in enumerate(rounds_ici):
        buf = jnp.take(x, ici_si[i], axis=0)
        buf = jax.lax.ppermute(buf, ici_axis, perm=_perm(n_ici, d))
        g = g.at[ici_rp[i]].set(buf, mode="drop")
    return g


def halo_scatter_add_two_tier(
    gz: jax.Array,
    y: jax.Array,
    ici_si: jax.Array, ici_rp: jax.Array,
    dcn_si: jax.Array, dcn_rp: jax.Array,
    rounds_ici: tuple[int, ...],
    rounds_dcn: tuple[tuple[int, int], ...],
    n_dcn: int, n_ici: int,
    dcn_axis: str = "dcn",
    ici_axis: str = "ici",
) -> jax.Array:
    """Two-tier reverse halo exchange (scatter-accumulate to owners):
    inverse hops in reverse order per round, DCN rounds first."""
    for i, (dd, di) in enumerate(rounds_dcn):
        buf = gz.at[dcn_rp[i]].get(mode="fill", fill_value=0)
        if di != 0:
            buf = jax.lax.ppermute(buf, ici_axis, perm=_perm(n_ici, (-di) % n_ici))
        buf = jax.lax.ppermute(buf, dcn_axis, perm=_perm(n_dcn, (-dd) % n_dcn))
        y = y.at[dcn_si[i]].add(buf, mode="promise_in_bounds")
    for i, d in enumerate(rounds_ici):
        buf = gz.at[ici_rp[i]].get(mode="fill", fill_value=0)
        buf = jax.lax.ppermute(buf, ici_axis, perm=_perm(n_ici, (-d) % n_ici))
        y = y.at[ici_si[i]].add(buf, mode="promise_in_bounds")
    return y


def halo_scatter_add_ds(
    gzh: jax.Array,        # (nghost_pad,) ghost-slot contributions, hi
    gzl: jax.Array,        # lo plane
    acc_h: jax.Array,      # (nlocal_pad,) owned DS accumulator, hi
    acc_l: jax.Array,
    send_idx: jax.Array,
    recv_pos: jax.Array,
    rounds: tuple[int, ...],
    n_devices: int,
    axis_name: str = "shards",
) -> tuple[jax.Array, jax.Array]:
    """ERROR-FREE double-single reverse halo: the DS analogue of
    ``halo_scatter_add``. Exactness argument: within one round each device
    receives from exactly ONE peer, whose ghost list is duplicate-free, so
    the round's owned-row indices are unique — the per-round scatter is a
    placement, not an accumulation (padding slots add literal zeros). The
    only additions are the per-round dense ``ds_add`` merges, which are
    error-free transformations (spmv_tpu.ds). This is what lets the
    symmetric double-single formats keep f64-class accuracy on BOUNDARY
    rows (a plain hi/lo scatter-add would round the hi sums at f32)."""
    from spmv_tpu.ds import ds_add

    for i, d in enumerate(rounds):
        bh = gzh.at[recv_pos[i]].get(mode="fill", fill_value=0)
        bl = gzl.at[recv_pos[i]].get(mode="fill", fill_value=0)
        perm = _perm(n_devices, (-d) % n_devices)
        bh = jax.lax.ppermute(bh, axis_name, perm=perm)
        bl = jax.lax.ppermute(bl, axis_name, perm=perm)
        rh = jnp.zeros_like(acc_h).at[send_idx[i]].add(
            bh, mode="promise_in_bounds")
        rl = jnp.zeros_like(acc_l).at[send_idx[i]].add(
            bl, mode="promise_in_bounds")
        acc_h, acc_l = ds_add(acc_h, acc_l, rh, rl)
    return acc_h, acc_l


def halo_scatter_add_two_tier_ds(
    gzh: jax.Array, gzl: jax.Array,
    acc_h: jax.Array, acc_l: jax.Array,
    ici_si: jax.Array, ici_rp: jax.Array,
    dcn_si: jax.Array, dcn_rp: jax.Array,
    rounds_ici: tuple[int, ...],
    rounds_dcn: tuple[tuple[int, int], ...],
    n_dcn: int, n_ici: int,
    dcn_axis: str = "dcn",
    ici_axis: str = "ici",
) -> tuple[jax.Array, jax.Array]:
    """Two-tier ``halo_scatter_add_ds`` — same per-round-unique-indices
    exactness argument (each round receives from exactly one (dcn, ici)
    source pair)."""
    from spmv_tpu.ds import ds_add

    def merge(acc_h, acc_l, si, bh, bl):
        rh = jnp.zeros_like(acc_h).at[si].add(bh, mode="promise_in_bounds")
        rl = jnp.zeros_like(acc_l).at[si].add(bl, mode="promise_in_bounds")
        return ds_add(acc_h, acc_l, rh, rl)

    for i, (dd, di) in enumerate(rounds_dcn):
        bh = gzh.at[dcn_rp[i]].get(mode="fill", fill_value=0)
        bl = gzl.at[dcn_rp[i]].get(mode="fill", fill_value=0)
        if di != 0:
            p = _perm(n_ici, (-di) % n_ici)
            bh = jax.lax.ppermute(bh, ici_axis, perm=p)
            bl = jax.lax.ppermute(bl, ici_axis, perm=p)
        p = _perm(n_dcn, (-dd) % n_dcn)
        bh = jax.lax.ppermute(bh, dcn_axis, perm=p)
        bl = jax.lax.ppermute(bl, dcn_axis, perm=p)
        acc_h, acc_l = merge(acc_h, acc_l, dcn_si[i], bh, bl)
    for i, d in enumerate(rounds_ici):
        bh = gzh.at[ici_rp[i]].get(mode="fill", fill_value=0)
        bl = gzl.at[ici_rp[i]].get(mode="fill", fill_value=0)
        p = _perm(n_ici, (-d) % n_ici)
        bh = jax.lax.ppermute(bh, ici_axis, perm=p)
        bl = jax.lax.ppermute(bl, ici_axis, perm=p)
        acc_h, acc_l = merge(acc_h, acc_l, ici_si[i], bh, bl)
    return acc_h, acc_l
