"""WELL — windowed gather-ELL, the general-sparsity device format.

Layout: A-row r lives at output lane ``r % 128`` of group ``g = r // 128``.
Each group packs its nonzeros into K slots; the invariant is that all 128
entries of one slot read from a single 128-aligned x segment inside the
tile's window. The apply (ops/spmv_well.py) is one gather per stored slot
plus a sum over slots; keeping every tile's columns inside a window of
``wseg`` segments bounds the x footprint each tile touches.

Storage per group g, slot k, lane j:
  values[g, k, j]  — the nonzero of row 128g+j assigned to slot k (0 = pad)
  pos[g, k, j]     — window-relative flat position seg*128 + lane of its
                     column; padding lanes carry the slot's segment with
                     lane 0
  w0[t]            — per tile of ``tile_groups`` groups: first x segment of
                     its window

Slot assignment (host, vectorized): nonzeros of a group are keyed by
(segment, per-row multiplicity); each distinct segment gets max-multiplicity
consecutive slots. K = max over groups. Storage efficiency = nnz/(G*K*128);
conversion reports it and callers gate on it (``well_occupancy``) — RCM
reordering (spmv_tpu.reorder) typically improves it dramatically.

Paired slots: a 128-row group's band of columns usually straddles a
128-aligned segment boundary, so single-segment slots come out
complementary-half-full (rows j < t hit segment s, rows j >= t hit s+1) —
occupancy ~0.54 on banded-random, i.e. ~2x slot inflation. After rank-based
packing, slot pairs whose 128-lane occupancy masks are disjoint are greedily
MERGED (any two segments). A merged slot's two segments are carried by
``pos`` itself at the ENDPOINT lanes: the entry at out-lane 0 always belongs
to leg a and the entry at out-lane 127 to leg b (padding endpoints are
filled accordingly; merges where one leg owns both endpoints are rejected —
they are rare). Every element's own ``pos`` holds its segment, so the
gather needs no leg select. Measured K: 11 -> 8 on the 4M-row
banded-random operator, 9 -> 7 on the RCM'd 129.6k FEM-like operator —
22-27% less storage. Pairing is opt-in (``pair=True``).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from spmv_tpu.formats.csr import CSRHost

LANES = 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class WellMatrix:
    """Device-resident windowed gather-ELL matrix."""

    values: jax.Array   # (K, G, 128) — slot-major so the kernel reduces
                        #   over slots with contiguous static slices
    pos: jax.Array      # (K, G, 128) int32/int16, window-relative
                        #   seg*128+lane (int16 when the window fits)
    w0: jax.Array       # (n_tiles,) int32, window start segment per tile
    nrows: int
    ncols: int
    wseg: int           # window size in 128-wide segments (static)
    tile_groups: int    # groups per tile (static; fixed at conversion)
    nseg: int = 0       # x segments incl. window-overrun padding (static)
    _nnz: int = 0
    # paired slots (module doc): pos endpoint lanes carry the two leg
    # segments (lane 0 -> leg a, lane 127 -> leg b) as free kernel slices
    paired: bool = False  # static: any slot actually carries two segments

    @property
    def ngroups(self) -> int:
        return self.values.shape[1]

    @property
    def k_slots(self) -> int:
        return self.values.shape[0]

    @property
    def nrows_pad(self) -> int:
        return self.ngroups * LANES

    @property
    def ncols_pad(self) -> int:
        """x length the kernel expects (covers every window, incl. zero
        padding past ncols for end-of-matrix windows)."""
        return self.nseg * LANES

    @property
    def n_tiles(self) -> int:
        return self.ngroups // self.tile_groups

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def nnz_stored(self) -> int:
        return int(self._nnz)

    @property
    def ngroups_data(self) -> int:
        """Row groups needed by the matrix's own rows (excludes the
        zero-filled groups _equalize_square_pads appends for pad-free
        solver chaining)."""
        g = _round_up(max(-(-self.nrows // LANES), 1), self.tile_groups)
        return min(g, self.ngroups)

    @property
    def occupancy(self) -> float:
        """Fraction of DATA-group value slots holding real nonzeros —
        the per-row slot-inflation measure `well_occupancy` predicts and
        the conversion gate acts on. Square-pad equalization groups
        (zero-filled, see _equalize_square_pads) are excluded; true
        storage incl. equalization is format_size_bytes()."""
        return self._nnz / max(self.k_slots * self.ngroups_data * LANES, 1)

    def format_size_bytes(self) -> int:
        return (
            self.values.size * self.values.dtype.itemsize
            + self.pos.size * self.pos.dtype.itemsize
            + self.w0.size * self.w0.dtype.itemsize
        )


jax.tree_util.register_dataclass(
    WellMatrix,
    data_fields=["values", "pos", "w0"],
    meta_fields=["nrows", "ncols", "wseg", "tile_groups", "nseg", "_nnz",
                 "paired"],
)


def well_occupancy(a: CSRHost, tile_groups: int = 16) -> float:
    """Predicted storage occupancy of csr_to_well(a) without building the
    arrays — the conversion gate. Uses the native scan when available
    (the numpy dry-run lexsorts nnz-sized keys: ~37 s at 4M rows, vs
    ~0.6 s native — this gate runs inside auto format selection)."""
    k_ = _well_scan_k_native(a, tile_groups)
    if k_ is not None:
        gpad = _round_up(max(-(-a.nrows // LANES), 1), tile_groups)
        return a.nnz / max(gpad * k_ * LANES, 1)
    g_, k_, _, _, _, _ = _pack(a, tile_groups, dry_run=True)
    return a.nnz / max(g_ * k_ * LANES, 1)


def _well_scan_k_native(a: CSRHost, tile_groups: int) -> int | None:
    """K (max slots per group) via the native scan; None -> numpy path."""
    import ctypes

    from spmv_tpu.native.lib import get_lib

    lib = get_lib()
    if lib is None:
        return None
    gpad = _round_up(max(-(-a.nrows // LANES), 1), tile_groups)
    rowptr = np.ascontiguousarray(a.rowptr, dtype=np.int64)
    colind = np.ascontiguousarray(a.colind, dtype=np.int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    w0 = np.zeros(gpad // tile_groups, dtype=np.int32)
    k_c = ctypes.c_int64(0)
    wseg_c = ctypes.c_int64(0)
    nseg_c = ctypes.c_int64(0)
    rc = lib.spmv_well_scan(
        rowptr.ctypes.data_as(i64p), colind.ctypes.data_as(i32p),
        a.nrows, a.ncols, tile_groups, gpad, 4096,
        ctypes.byref(k_c), ctypes.byref(wseg_c), ctypes.byref(nseg_c),
        w0.ctypes.data_as(i32p),
    )
    return int(k_c.value) if rc == 0 else None


def split_window(
    a: CSRHost, tile_groups: int, wseg_cap: int
) -> tuple[CSRHost, CSRHost]:
    """Split a into (near, far): per tile of ``tile_groups`` row groups, the
    ``wseg_cap``-segment window covering the MOST entries keeps them (two-
    pointer over sorted segments); everything outside goes to ``far``. The
    windowed WELL kernel runs ``near``; the (after reordering, small) far
    remainder runs through the XLA ELL path — the multi-pass answer for
    matrices whose columns scatter beyond any single window."""
    lens = a.row_nnz()
    rows = np.repeat(np.arange(a.nrows, dtype=np.int64), lens)
    cols = a.colind.astype(np.int64)
    tile_of = rows // (LANES * tile_groups)
    seg = cols // LANES
    near = np.ones(a.nnz, dtype=bool)
    for t in np.unique(tile_of):
        sel = np.flatnonzero(tile_of == t)
        segs = seg[sel]
        lo, hi = segs.min(), segs.max()
        if hi - lo < wseg_cap:
            continue
        order = np.argsort(segs)
        s_sorted = segs[order]
        # two-pointer max-coverage window of width wseg_cap
        j = np.searchsorted(s_sorted, s_sorted + wseg_cap, side="left")
        counts = j - np.arange(len(s_sorted))
        best = int(np.argmax(counts))
        # 8-align the start so _pack's sublane-aligned w0 stays within cap
        w_lo = (int(s_sorted[best]) // 8) * 8
        keep = (segs >= w_lo) & (segs < w_lo + wseg_cap)
        near[sel[~keep]] = False
    def build(mask):
        return CSRHost.from_coo(rows[mask], cols[mask], a.values[mask],
                                a.nrows, a.ncols, sum_duplicates=False)
    return build(near), build(~near)


def _pair_slots(kg, pre_g, pre_fill, pre_mask, gpad):
    """Greedy complementary-mask pairing of pre-slots (host).

    Per group, first-fit ascending by fill: each unmerged slot grabs the
    first remaining slot whose 128-lane occupancy mask is disjoint. A
    pre-slot owning BOTH endpoint lanes (0 and 127) is excluded — the
    kernel reads the two leg segments from the endpoint lanes, so a merge
    must leave each endpoint to a distinct leg (or padding). Returns
    (new_local, leg, k_new): the merged slot index within its group, which
    leg (0/1) each pre-slot landed on, and the per-group merged slot count.
    Pre-slots are ordered group-major (offset = exclusive cumsum of kg)."""
    n_pre = len(pre_g)
    new_local = np.zeros(n_pre, dtype=np.int64)
    leg = np.zeros(n_pre, dtype=np.int8)
    k_new = np.zeros(gpad, dtype=np.int64)
    base = np.concatenate([[0], np.cumsum(kg)])
    pairable = ~((pre_mask[:, 0] & np.uint64(1)) != 0) | ~(
        (pre_mask[:, 1] >> np.uint64(63)) != 0
    )
    for gg in np.flatnonzero(kg > 1):
        lo, hi = base[gg], base[gg + 1]
        ms = pre_mask[lo:hi]
        ok = pairable[lo:hi]
        idx = np.argsort(pre_fill[lo:hi], kind="stable")
        used = np.zeros(hi - lo, dtype=bool)
        kk = 0
        for ii in range(hi - lo):
            i = idx[ii]
            if used[i]:
                continue
            used[i] = True
            new_local[lo + i] = kk
            if ok[i]:
                cand = (~used) & ok & (
                    ((ms[:, 0] & ms[i, 0]) | (ms[:, 1] & ms[i, 1])) == 0
                )
                j = np.flatnonzero(cand)
                if len(j):
                    used[j[0]] = True
                    new_local[lo + j[0]] = kk
                    leg[lo + j[0]] = 1
            kk += 1
        k_new[gg] = kk
    one = kg == 1
    k_new[one] = 1
    return new_local, leg, k_new


def _pack(a: CSRHost, tile_groups: int, dry_run: bool = False,
          pair: bool = False):
    """Compute the slot packing. Returns (G, K, wseg, w0, nseg_x, scatter)
    where scatter = (g, slot, lane_out, seg_rel, lane_in, vals, sa, sb,
    paired); sa/sb are the (G, K) per-slot leg segments the padding
    endpoint lanes must carry (kernel invariant: lane 0 reads leg a,
    lane 127 reads leg b)."""
    gpad = _round_up(max(-(-a.nrows // LANES), 1), tile_groups)
    n_tiles = gpad // tile_groups

    lens = a.row_nnz()
    rows = np.repeat(np.arange(a.nrows, dtype=np.int64), lens)
    cols = a.colind.astype(np.int64)
    g = rows // LANES
    lane_out = (rows % LANES).astype(np.int64)
    seg_abs = cols // LANES
    lane_in = (cols % LANES).astype(np.int64)

    # per-(g, seg, row) multiplicity m, then per-(g, seg) block offsets
    order = np.lexsort((lane_out, seg_abs, g))
    g_s, seg_s, lo_s, li_s = g[order], seg_abs[order], lane_out[order], lane_in[order]
    vals_s = a.values[order]
    # m: rank within identical (g, seg, row)
    key_new = np.empty(len(g_s), dtype=bool)
    key_new[:1] = True
    key_new[1:] = (
        (g_s[1:] != g_s[:-1]) | (seg_s[1:] != seg_s[:-1]) | (lo_s[1:] != lo_s[:-1])
    )
    grp_id = np.cumsum(key_new) - 1
    first_of_grp = np.flatnonzero(key_new)
    m = np.arange(len(g_s)) - first_of_grp[grp_id]

    # distinct (g, seg) blocks and their slot widths (max multiplicity + 1)
    blk_new = np.empty(len(g_s), dtype=bool)
    blk_new[:1] = True
    blk_new[1:] = (g_s[1:] != g_s[:-1]) | (seg_s[1:] != seg_s[:-1])
    blk_id = np.cumsum(blk_new) - 1
    nblk = int(blk_id[-1]) + 1 if len(g_s) else 0
    blk_g = g_s[blk_new]
    blk_seg = seg_s[blk_new]
    blk_width = np.zeros(nblk, dtype=np.int64)
    np.maximum.at(blk_width, blk_id, m + 1)

    # per-g exclusive cumsum of widths -> block slot offsets; K = max total
    blk_off = np.zeros(nblk, dtype=np.int64)
    kg = np.zeros(gpad, dtype=np.int64)
    if nblk:
        excl = np.concatenate([[0], np.cumsum(blk_width)[:-1]])
        g_first = np.zeros(nblk, dtype=bool)
        g_first[:1] = True
        g_first[1:] = blk_g[1:] != blk_g[:-1]
        gidx = np.cumsum(g_first) - 1  # dense index of this block's g
        blk_off = excl - excl[np.flatnonzero(g_first)][gidx]
        np.add.at(kg, blk_g, blk_width)
    k = max(int(kg.max()) if len(kg) else 1, 1)

    # windows: per tile min/max referenced segment
    nseg_x = max(_round_up(a.ncols, LANES) // LANES, 1)
    w0 = np.zeros(n_tiles, dtype=np.int64)
    wmax = np.zeros(n_tiles, dtype=np.int64)
    if len(g_s):
        tile_of = (g_s // tile_groups).astype(np.int64)
        w0_full = np.full(n_tiles, np.iinfo(np.int64).max)
        np.minimum.at(w0_full, tile_of, seg_s)
        np.maximum.at(wmax, tile_of, seg_s)
        w0 = np.where(w0_full == np.iinfo(np.int64).max, 0, w0_full)
    w0 = (w0 // 8) * 8  # sublane-aligned window DMA starts
    wseg = int(max((wmax - w0).max() + 1 if n_tiles else 1, 1))
    wseg = _round_up(wseg, 8)
    # windows may extend past ncols: x is PADDED so every window DMA stays
    # in-bounds (the padding reads zeros) — clamping w0 down instead would
    # force wider windows for end-of-matrix tiles
    nseg_x = max(nseg_x, int(w0.max()) + wseg if n_tiles else wseg)

    pre_slot = blk_off[blk_id] + m if len(g_s) else np.empty(0, np.int64)
    seg_rel = seg_s - w0[(g_s // tile_groups).astype(np.int64)] if len(g_s) else g_s

    # ---- paired slots: merge complementary half-full slots (module doc) ----
    paired = False
    slot = pre_slot
    sa = np.zeros((gpad, k), dtype=np.int64)
    sb = np.zeros((gpad, k), dtype=np.int64)
    if len(g_s):
        base = np.concatenate([[0], np.cumsum(kg)])
        pre_id = base[g_s] + pre_slot              # global pre-slot id
        n_pre = int(base[-1])
        pre_g = np.repeat(blk_g, blk_width)
        pre_seg_rel = np.repeat(
            blk_seg - w0[(blk_g // tile_groups).astype(np.int64)], blk_width
        )
        # per-pre-slot endpoint-lane ownership (the kernel reads the leg
        # segments from out-lanes 0 and 127)
        pre_mask = np.zeros((n_pre, 2), dtype=np.uint64)
        wrd = (lo_s // 64).astype(np.int64)
        bit = np.uint64(1) << (lo_s % 64).astype(np.uint64)
        np.bitwise_or.at(pre_mask, (pre_id, wrd), bit)
        pre_b0 = (pre_mask[:, 0] & np.uint64(1)) != 0
        pre_b127 = (pre_mask[:, 1] >> np.uint64(63)) != 0
        # per-pre-slot local index within its group (identity = unmerged);
        # pre-slots enumerate in global-id order (blocks sorted by (g, seg),
        # ranks consecutive)
        new_local = np.arange(n_pre) - base[pre_g]
        leg = np.zeros(n_pre, dtype=np.int8)
        if pair:
            pre_fill = np.zeros(n_pre, dtype=np.int64)
            np.add.at(pre_fill, pre_id, 1)
            m_local, m_leg, k_new = _pair_slots(kg, pre_g, pre_fill,
                                                pre_mask, gpad)
            k_merged = max(int(k_new.max()), 1)
            if k_merged < k:
                paired = True
                k = k_merged
                new_local, leg = m_local, m_leg
                slot = new_local[pre_id]
        # per-(g, slot) leg segments + endpoint ownership -> sa/sb:
        # sa is the segment of whichever leg owns lane 0 (either leg when
        # lane 0 is padding, then forced by lane-127's owner); sb is the
        # OTHER leg's segment (pairing rejects one-leg-owns-both-endpoints)
        seg_leg = np.zeros((gpad, k, 2), dtype=np.int64)
        has_leg1 = np.zeros((gpad, k), dtype=bool)
        b0 = np.zeros((gpad, k, 2), dtype=bool)
        b127 = np.zeros((gpad, k, 2), dtype=bool)
        seg_leg[pre_g, new_local, leg] = pre_seg_rel
        has_leg1[pre_g[leg == 1], new_local[leg == 1]] = True
        b0[pre_g, new_local, leg] = pre_b0
        b127[pre_g, new_local, leg] = pre_b127
        seg0 = seg_leg[:, :, 0]
        seg1 = np.where(has_leg1, seg_leg[:, :, 1], seg0)
        sa = np.where(
            b0[:, :, 0], seg0,
            np.where(b0[:, :, 1], seg1,
                     np.where(b127[:, :, 0], seg1, seg0)),
        )
        sb = seg0 + seg1 - sa

    if dry_run:
        return gpad, k, wseg, w0, nseg_x, None
    return gpad, k, wseg, w0, nseg_x, (
        g_s, slot, lo_s, seg_rel, li_s, vals_s, sa, sb, paired,
    )


def _build_arrays(a: CSRHost, tile_groups: int, max_k: int, dtype,
                  pair: bool = False):
    """Shared WELL array builder (host numpy): returns
    (values, pos, w0, wseg, nseg_x, paired)."""
    if not pair:
        nat = _build_arrays_native(a, tile_groups, max_k, dtype)
        if nat is not None:
            return nat
    gpad, k, wseg, w0, nseg_x, scatter = _pack(a, tile_groups, pair=pair)
    if k > max_k:
        raise ValueError(
            f"WELL packing needs K={k} slots > max_k={max_k}; reorder the "
            "matrix (spmv_tpu.reorder.rcm_reorder) or raise max_k"
        )
    g_s, slot, lo_s, seg_rel, li_s, vals_s, sa, sb, paired = scatter

    # int16 positions halve the index traffic (it matches the value traffic
    # at fp32 otherwise); requires the window-relative flat positions to fit
    # and 16-aligned tiles (the i16 sublane tile is (16, 128))
    pos_dtype = (np.int16 if wseg * LANES <= np.iinfo(np.int16).max
                 and tile_groups % 16 == 0 else np.int32)
    values = np.zeros((k, gpad, LANES), dtype=dtype or a.dtype)
    pos = np.zeros((k, gpad, LANES), dtype=pos_dtype)
    # endpoint-lane invariant (module doc): lane 0 must carry leg a's
    # segment and lane 127 leg b's — fill every lane with sa*128, the last
    # lane with sb*128, then let real entries overwrite (their endpoint
    # segments agree by the pairing's ownership rules; padding value 0
    # kills the term either way)
    pos[...] = (sa.T[:, :, None] * LANES).astype(pos_dtype)
    pos[:, :, LANES - 1] = (sb.T * LANES).astype(pos_dtype)
    if len(g_s):
        values[slot, g_s, lo_s] = vals_s
        pos[slot, g_s, lo_s] = (seg_rel * LANES + li_s).astype(pos_dtype)
    return values, pos, w0.astype(np.int32), wseg, nseg_x, paired


def _build_arrays_native(a: CSRHost, tile_groups: int, max_k: int, dtype):
    """Native (C++) CSR->WELL: per-group block tables, no global sort
    (spmv_tpu/native/spmv_host.cpp spmv_well_scan/spmv_well_pack_*) —
    bitwise-identical to the numpy path (regression-tested), ~4x at
    weak-scale sizes where the numpy lexsort over nnz (g, seg, lane) keys
    dominates. Unpaired layout only; returns None (numpy fallback) for
    complex/cross-dtype values, pathological rows (> 4096 distinct
    segments), or a missing toolchain."""
    import ctypes

    from spmv_tpu.native.lib import get_lib

    out_dtype = np.dtype(dtype or a.dtype)
    if out_dtype not in (np.dtype(np.float32), np.dtype(np.float64)):
        return None
    if np.dtype(a.values.dtype) not in (np.dtype(np.float32),
                                        np.dtype(np.float64)):
        return None
    lib = get_lib()
    if lib is None:
        return None
    gpad = _round_up(max(-(-a.nrows // LANES), 1), tile_groups)
    n_tiles = gpad // tile_groups
    rowptr = np.ascontiguousarray(a.rowptr, dtype=np.int64)
    colind = np.ascontiguousarray(a.colind, dtype=np.int32)
    # cast once up front (e.g. f64 host assembly -> f32 device values, the
    # AMG coarse-grid case): elementwise IEEE cast, so the packed planes
    # stay bitwise-identical to the numpy tier's post-pack cast
    values = np.ascontiguousarray(a.values, dtype=out_dtype)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    w0 = np.zeros(n_tiles, dtype=np.int32)
    k_c = ctypes.c_int64(0)
    wseg_c = ctypes.c_int64(0)
    nseg_c = ctypes.c_int64(0)
    rc = lib.spmv_well_scan(
        rowptr.ctypes.data_as(i64p), colind.ctypes.data_as(i32p),
        a.nrows, a.ncols, tile_groups, gpad, 4096,
        ctypes.byref(k_c), ctypes.byref(wseg_c), ctypes.byref(nseg_c),
        w0.ctypes.data_as(i32p),
    )
    if rc != 0:
        return None
    k, wseg, nseg_x = int(k_c.value), int(wseg_c.value), int(nseg_c.value)
    if k > max_k:
        raise ValueError(
            f"WELL packing needs K={k} slots > max_k={max_k}; reorder the "
            "matrix (spmv_tpu.reorder.rcm_reorder) or raise max_k"
        )
    pos_dtype = (np.int16 if wseg * LANES <= np.iinfo(np.int16).max
                 and tile_groups % 16 == 0 else np.int32)
    vals_out = np.zeros((k, gpad, LANES), dtype=out_dtype)
    pos_out = np.zeros((k, gpad, LANES), dtype=pos_dtype)
    pack = getattr(
        lib,
        "spmv_well_pack_"
        + ("f32" if out_dtype == np.float32 else "f64")
        + ("_i16" if pos_dtype == np.int16 else "_i32"),
    )
    vp = ctypes.POINTER(
        ctypes.c_float if out_dtype == np.float32 else ctypes.c_double)
    pp = ctypes.POINTER(
        ctypes.c_int16 if pos_dtype == np.int16 else ctypes.c_int32)
    rc = pack(
        rowptr.ctypes.data_as(i64p), colind.ctypes.data_as(i32p),
        values.ctypes.data_as(vp), a.nrows, tile_groups, gpad, k, wseg,
        w0.ctypes.data_as(i32p), vals_out.ctypes.data_as(vp),
        pos_out.ctypes.data_as(pp),
    )
    if rc != 0:
        return None
    return vals_out, pos_out, w0, wseg, nseg_x, False


def _equalize_square_pads(values, pos, w0, nseg_x: int, tile_groups: int):
    """For SQUARE operators, pad the group axis and x-segment count to a
    COMMON value so nrows_pad == ncols_pad: kernel outputs then chain
    directly into the next apply (solver hot loops, matrix-powers bases)
    with no pad/slice relayout between applies. The relayout is not free —
    the xplane timeline (tools/exp_well_timeline.py) measured the 4M-row
    WELL custom-call at 0.496 ms/apply while the chained loop ran 0.593:
    ~0.10 ms/apply (17%) was the pad between mismatched layouts. Cost of
    the equalization: up to ~wseg extra zero row groups (nseg_x =
    w0.max()+wseg can overhang the group count by up to wseg segments for
    end-of-matrix windows, _pack line ~345) plus tile_groups-1 rounding —
    a few MB and a few idle kernel tiles at bench scale; zero-valued
    slots contribute nothing numerically. `WellMatrix.occupancy` counts
    data groups only, so the gate metric is unaffected."""
    k, g, _ = values.shape
    target = -(-max(g, nseg_x) // tile_groups) * tile_groups
    if target != g:
        padg = target - g
        values = np.pad(values, ((0, 0), (0, padg), (0, 0)))
        pos = np.pad(pos, ((0, 0), (0, padg), (0, 0)))
        w0 = np.concatenate(
            [w0, np.zeros(padg // tile_groups, w0.dtype)])
    return values, pos, w0, target


def _pad_well_to(w: WellMatrix, target_groups: int) -> WellMatrix:
    """Pad an already-built (square-equalized) WellMatrix to a larger
    common group/segment count — used to put the two triangles of the
    symmetric dual-WELL form on one layout. ``target_groups`` must be a
    multiple of ``w.tile_groups`` (the max of two equalized counts is)."""
    if w.ngroups == target_groups and w.nseg == target_groups:
        return w
    assert target_groups % w.tile_groups == 0, (
        f"target_groups={target_groups} must be a multiple of "
        f"tile_groups={w.tile_groups}")
    padg = target_groups - w.ngroups
    return dataclasses.replace(
        w,
        values=jnp.pad(w.values, ((0, 0), (0, padg), (0, 0))),
        pos=jnp.pad(w.pos, ((0, 0), (0, padg), (0, 0))),
        w0=jnp.pad(w.w0, (0, padg // w.tile_groups)),
        nseg=target_groups,
    )


def csr_to_well(
    a: CSRHost,
    tile_groups: int = 16,
    max_k: int = 64,
    dtype=None,
    pair: bool = False,
) -> WellMatrix:
    """Convert host CSR to WELL. ``tile_groups`` (groups per kernel tile) is
    fixed here because ``pos`` is window-relative. Raises when a group needs
    more than ``max_k`` slots (one pathologically dense/scattered row group
    would inflate every group's storage). ``pair=True`` enables the
    paired-slot merge (module doc): ~25% less storage at ~4% more
    wall-clock — for HBM-capacity-bound or occupancy-gated cases."""
    if np.iscomplexobj(a.values) or (dtype is not None
                                     and np.issubdtype(np.dtype(dtype),
                                                       np.complexfloating)):
        raise ValueError(
            "WELL has no complex device kernel; complex operators run on "
            "the ELL/DIA XLA path (local_format='ell' or 'dia'), or split "
            "re/im into two real operators (README 'Complex dtypes')"
        )
    values, pos, w0, wseg, nseg_x, paired = _build_arrays(
        a, tile_groups, max_k, dtype, pair=pair)
    if a.nrows == a.ncols:
        values, pos, w0, nseg_x = _equalize_square_pads(
            values, pos, w0, nseg_x, tile_groups)
    return WellMatrix(
        values=jnp.asarray(values),
        pos=jnp.asarray(pos),
        w0=jnp.asarray(w0),
        nrows=a.nrows,
        ncols=a.ncols,
        wseg=wseg,
        tile_groups=tile_groups,
        nseg=nseg_x,
        _nnz=a.nnz,
        paired=paired,
    )


@dataclasses.dataclass
class SymWellMatrix:
    """Symmetric general-sparsity device format: A = L + D + L^T with the
    strict lower triangle L stored as a WELL operator AND its transpose
    L^T PRE-BUILT as a second WELL operator at conversion time — the
    symmetric apply is two gathers plus a diagonal axpy, with ZERO scatters
    on the hot path. The reference's symmetric mode uses a conflict-map
    two-phase on CPU (reference spmv/openmp/csr_kernels.openmp.cpp:89-168)
    and global-memory atomics on GPU (reference
    spmv/cuda/csr_kernels.cuda.cu:20-47); here the scatter is avoided
    altogether, trading 2x index storage for deterministic gathers.

    Each triangle carries its own compact-COO far remainder (entries
    outside its window split), applied as two tiny scatter-adds — empty
    after RCM reordering for most matrices.
    """

    lower: WellMatrix          # WELL of strict-lower near entries
    upper: WellMatrix          # WELL of (strict lower)^T near entries
    diag: jax.Array            # (nrows_pad,) dense diagonal
    farl: tuple | None         # (rows i32, cols i32, vals) of lower far
    faru: tuple | None         # same for the transposed part
    nrows: int

    @property
    def nrows_pad(self) -> int:
        return self.lower.nrows_pad

    @property
    def nnz_stored(self) -> int:
        nl = self.lower.nnz_stored + self.upper.nnz_stored
        nf = (0 if self.farl is None else self.farl[0].shape[0]) + (
            0 if self.faru is None else self.faru[0].shape[0])
        return nl + nf + int(jnp.size(self.diag))

    def format_size_bytes(self) -> int:
        total = self.lower.format_size_bytes() + self.upper.format_size_bytes()
        total += self.diag.size * self.diag.dtype.itemsize
        for far in (self.farl, self.faru):
            if far is not None:
                total += sum(a.size * a.dtype.itemsize for a in far)
        return total


jax.tree_util.register_dataclass(
    SymWellMatrix,
    data_fields=["lower", "upper", "diag", "farl", "faru"],
    meta_fields=["nrows"],
)


def _far_coo(far: CSRHost, dtype):
    """Compact COO triple for a far remainder (None when empty)."""
    if far.nnz == 0:
        return None
    rows = np.repeat(np.arange(far.nrows, dtype=np.int32), far.row_nnz())
    return (
        jnp.asarray(rows),
        jnp.asarray(far.colind.astype(np.int32)),
        jnp.asarray(far.values.astype(dtype or far.dtype)),
    )


def csr_to_well_sym(
    a: CSRHost,
    tile_groups: int = 16,
    max_k: int = 64,
    dtype=None,
    wseg_cap: int = 512,
) -> SymWellMatrix:
    """Convert a (full) symmetric host CSR to the dual-WELL symmetric
    format. Only the lower triangle of ``a`` is read (entries above the
    diagonal are assumed to mirror it, like the reference's symmetric
    reader, reference spmv/read_petsc.cpp:177-188)."""
    if a.nrows != a.ncols:
        raise ValueError("symmetric storage requires a square matrix")
    lower, diag = a.split_lower_diag()
    upper_full = lower.transpose()
    near_l, far_l = split_window(lower, tile_groups, wseg_cap)
    near_u, far_u = split_window(upper_full, tile_groups, wseg_cap)
    wl = csr_to_well(near_l, tile_groups, max_k, dtype)
    wu = csr_to_well(near_u, tile_groups, max_k, dtype)
    # both triangles at ONE common pad so the sym apply's yl + yu (and the
    # diag axpy) need no relayout (see _equalize_square_pads)
    tgt = max(wl.ngroups, wu.ngroups)
    wl, wu = _pad_well_to(wl, tgt), _pad_well_to(wu, tgt)
    np_pad = max(wl.nrows_pad, wu.nrows_pad)
    dpad = np.zeros(np_pad, dtype=dtype or a.dtype)
    dpad[: len(diag)] = diag
    return SymWellMatrix(
        lower=wl,
        upper=wu,
        diag=jnp.asarray(dpad),
        farl=_far_coo(far_l, dtype),
        faru=_far_coo(far_u, dtype),
        nrows=a.nrows,
    )
