"""WELL (windowed gather-ELL) SpMV and SpMM — the general-sparsity path.

The layout (formats/well.py) stores, per slot k, row group g and lane j,
the value of one nonzero of row ``128*g + j`` and its window-relative
column ``pos``; the window of tile ``g // tile_groups`` starts at segment
``w0``. The product is a plain gather over that layout:

    y[g, j] = sum_k values[k, g, j] * x[w0[g // tile_groups]*128 + pos[k, g, j]]

Paired slots store each element's own segment in ``pos``, so the same
gather covers them; int16 positions widen to int32 before the add.
Padding slots hold value 0 and an in-window position. XLA lowers the
gather to native device loads; the reduction over slots fuses with it.

Plays the role of the reference's general-matrix device kernels
(cuSPARSE cusparseSpMV, reference spmv/cuda/csr_kernels.cuda.cu:106-151).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from spmv_tpu.ds import ds_add, ds_from_f64, ds_mul_f32, ds_to_f64
from spmv_tpu.formats.well import LANES, WellMatrix
from spmv_tpu.ops.spmv_dia import block_to_columns, columns_to_block


def _columns(pos: jax.Array, w0: jax.Array, tile_groups: int) -> jax.Array:
    """(K, G, 128) absolute x index of every stored slot."""
    base = jnp.repeat(w0.astype(jnp.int32), tile_groups) * LANES
    return base[None, :, None] + pos.astype(jnp.int32)


def _from_block_rows(y: jax.Array) -> jax.Array:
    """(G, 128, nrhs) gathered sums -> the (G, nrhs*128) block layout."""
    return columns_to_block(y.reshape(-1, y.shape[-1]))


def well_apply(values, pos, w0, tile_groups: int, x2: jax.Array) -> jax.Array:
    """Local WELL product: x2 (S, 128) lane layout -> y (G, 128)."""
    cols = _columns(pos, w0, tile_groups)
    g = x2.reshape(-1).at[cols].get(mode="promise_in_bounds")
    return jnp.sum(values * g, axis=0)


def well_apply_block(values, pos, w0, tile_groups: int,
                     x2: jax.Array) -> jax.Array:
    """Block product in the (rows, nrhs*128) layout: the matrix and its
    positions are read once for all right-hand sides."""
    cols = _columns(pos, w0, tile_groups)
    g = block_to_columns(x2).at[cols].get(mode="promise_in_bounds")
    return _from_block_rows(jnp.sum(values[..., None] * g, axis=0))


def well_ds_apply(values_hi, values_lo, pos, w0, tile_groups: int,
                  xh2: jax.Array, xl2: jax.Array):
    """Double-single WELL product in the block layout (nrhs >= 1):
    error-free per output row, slots accumulated in order."""
    cols = _columns(pos, w0, tile_groups)
    gh = block_to_columns(xh2).at[cols].get(mode="promise_in_bounds")
    gl = block_to_columns(xl2).at[cols].get(mode="promise_in_bounds")
    ph, plo = ds_mul_f32(values_hi[..., None], values_lo[..., None], gh, gl)
    acc_h, acc_l = ph[0], plo[0]
    for k in range(1, ph.shape[0]):
        acc_h, acc_l = ds_add(acc_h, acc_l, ph[k], plo[k])
    return _from_block_rows(acc_h), _from_block_rows(acc_l)


def well_to_2d(a, x: jax.Array) -> jax.Array:
    """Reshape a flat x into the (ncols_pad/128, 128) lane layout (free
    when already padded; zero-fills otherwise)."""
    npad = a.ncols_pad
    if x.ndim == 2:
        return x
    if x.shape[0] != npad:
        take = min(x.shape[0], npad)
        x = jnp.zeros((npad,), x.dtype).at[:take].set(x[:take])
    return x.reshape(npad // LANES, LANES)


def spmv_well_2d(a: WellMatrix, x2: jax.Array) -> jax.Array:
    """SpMV in lane layout: x2 (ncols_pad/128, 128) -> y (nrows_pad/128,
    128). Output element (g, j) is row 128g + j, the DIA layout, so
    formats compose inside solvers."""
    return well_apply(a.values, a.pos, a.w0, a.tile_groups, x2)


def spmm_well_2d(a: WellMatrix, x2: jax.Array) -> jax.Array:
    """Block SpMM: x2 (ncols_pad/128, nrhs*128) -> y (nrows_pad/128,
    nrhs*128); column r of the block is lane slice [r*128, (r+1)*128)."""
    return well_apply_block(a.values, a.pos, a.w0, a.tile_groups, x2)


def spmv_well(
    a: WellMatrix,
    x: jax.Array,
    alpha=1.0,
    beta=0.0,
    y: jax.Array | None = None,
) -> jax.Array:
    """y_out = alpha * A @ x + beta * y — SubMatrix::mult semantics
    (reference spmv/sub_matrix.h:26-122), matching spmv_ell/spmv_dia.
    Returns a vector of length nrows_pad."""
    ax = spmv_well_2d(a, well_to_2d(a, x)).reshape(a.nrows_pad)
    if y is None:
        return alpha * ax
    n = a.nrows_pad
    yp = y
    if yp.shape[0] != n:
        yp = jnp.zeros((n,), y.dtype).at[: min(y.shape[0], n)].set(y[:n])
    return alpha * ax + beta * yp


# ---------------------------------------------------------------------------
# Double-single (float64-class) WELL: one packing, two f32 value planes.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class WellDsMatrix:
    """WELL matrix in double-single storage (hi/lo f32 value planes)."""

    values_hi: jax.Array  # (K, G, 128)
    values_lo: jax.Array
    pos: jax.Array        # (K, G, 128) int (shared by both planes)
    w0: jax.Array
    nrows: int
    ncols: int
    wseg: int
    tile_groups: int
    nseg: int = 0
    _nnz: int = 0
    paired: bool = False  # paired slots (formats/well.py module doc)

    @property
    def ngroups(self) -> int:
        return self.values_hi.shape[1]

    @property
    def k_slots(self) -> int:
        return self.values_hi.shape[0]

    @property
    def nrows_pad(self) -> int:
        return self.ngroups * LANES

    @property
    def ncols_pad(self) -> int:
        return self.nseg * LANES

    @property
    def n_tiles(self) -> int:
        return self.ngroups // self.tile_groups


jax.tree_util.register_dataclass(
    WellDsMatrix,
    data_fields=["values_hi", "values_lo", "pos", "w0"],
    meta_fields=["nrows", "ncols", "wseg", "tile_groups", "nseg", "_nnz",
                 "paired"],
)


def csr_to_well_ds(a, tile_groups: int = 16, max_k: int = 64,
                   pair: bool = False) -> WellDsMatrix:
    """f64 host CSR -> double-single WELL (one packing, two value planes;
    the split stays in numpy until upload — see csr_to_dia_ds)."""
    from spmv_tpu.formats.well import _build_arrays, _equalize_square_pads

    v64, pos, w0, wseg, nseg_x, paired = _build_arrays(
        a, tile_groups, max_k, np.float64, pair=pair
    )
    if a.nrows == a.ncols:
        # square operators chain pad-free (formats/well._equalize_square_pads)
        v64, pos, w0, nseg_x = _equalize_square_pads(
            v64, pos, w0, nseg_x, tile_groups)
    hi, lo = ds_from_f64(v64)
    return WellDsMatrix(
        values_hi=jnp.asarray(hi),
        values_lo=jnp.asarray(lo),
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


def spmm_well_ds_2d(
    a: WellDsMatrix, xh2: jax.Array, xl2: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """f64-class block SpMM in the (rows, nrhs*128) layout (nrhs = 1 is
    the single-vector lane layout)."""
    return well_ds_apply(a.values_hi, a.values_lo, a.pos, a.w0,
                         a.tile_groups, xh2, xl2)


def spmv_well_ds_2d(
    a: WellDsMatrix, xh2: jax.Array, xl2: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """Double-single general-sparsity SpMV: (hi, lo) pairs in lane layout."""
    return spmm_well_ds_2d(a, xh2, xl2)


def spmv_well_ds(a: WellDsMatrix, x) -> np.ndarray:
    """Convenience: f64 vector in, f64 out (length nrows_pad)."""
    xv = np.zeros(a.ncols_pad, dtype=np.float64)
    n = min(len(x), a.ncols_pad)
    xv[:n] = np.asarray(x, np.float64)[:n]
    hi, lo = ds_from_f64(xv)
    yh, yl = spmv_well_ds_2d(
        a, jnp.asarray(hi.reshape(-1, LANES)), jnp.asarray(lo.reshape(-1, LANES)),
    )
    return ds_to_f64(np.asarray(yh).reshape(-1), np.asarray(yl).reshape(-1))


# ---------------------------------------------------------------------------
# symmetric dual-WELL: L and a pre-built L^T as two gather stacks
# ---------------------------------------------------------------------------


def spmv_well_sym(a, x: jax.Array) -> jax.Array:
    """Symmetric general-sparsity SpMV: y = (L + D + L^T) x with BOTH
    triangles as WELL gathers (formats/well.SymWellMatrix) — no scatter
    on the main term; the far remainders (usually empty after RCM) are
    two compact scatter-adds touching far_nnz elements each.

    ``x`` is flat (>= nrows); returns flat y of length nrows_pad. Replaces
    the reference's conflict-map/atomics symmetric kernels
    (reference spmv/openmp/csr_kernels.openmp.cpp:89-168,
    reference spmv/cuda/csr_kernels.cuda.cu:20-47)."""
    yl = spmv_well(a.lower, x)
    yu = spmv_well(a.upper, x)
    npad = a.lower.nrows_pad
    xp = jnp.zeros((npad,), x.dtype).at[: min(x.shape[0], npad)].set(
        x[:npad]
    ) if x.shape[0] != npad else x
    y = yl + yu + a.diag * xp
    for far in (a.farl, a.faru):
        if far is not None:
            fr, fc, fv = far
            y = y.at[fr].add(fv * jnp.take(x, fc, axis=0),
                             mode="promise_in_bounds")
    return y


def spmv_well_sym_2d(a, x2: jax.Array) -> jax.Array:
    """Lane-layout wrapper for solver chaining: x2 (nrows_pad/128, 128) ->
    y2 same shape (square operator; both triangles share nrows_pad)."""
    y = spmv_well_sym(a, x2.reshape(-1))
    return y.reshape(-1, LANES)


@dataclasses.dataclass
class SymWellDsMatrix:
    """Symmetric general sparsity at f64-class accuracy: the dual-WELL
    formulation (formats/well.SymWellMatrix — L and a pre-built L^T as two
    gather stacks) with double-single (hi/lo f32) value planes everywhere.

    Far remainders are stored as small ELL rectangles (not compact COO):
    the ds accumulation chain must stay error-free per OUTPUT row, which
    slot-wise ELL gathers give and scatter-adds do not."""

    lower: WellDsMatrix
    upper: WellDsMatrix
    diag_hi: jax.Array   # (nrows_pad,)
    diag_lo: jax.Array
    farl: tuple | None   # (colind (R,K) i32, vh (R,K), vl (R,K)) or None
    faru: tuple | None
    nrows: int

    @property
    def nrows_pad(self) -> int:
        return self.lower.nrows_pad


jax.tree_util.register_dataclass(
    SymWellDsMatrix,
    data_fields=["lower", "upper", "diag_hi", "diag_lo", "farl", "faru"],
    meta_fields=["nrows"],
)


def _pad_well_ds_to(w: WellDsMatrix, target_groups: int) -> WellDsMatrix:
    """DS twin of formats/well._pad_well_to: pad both value planes + pos +
    w0 to a larger common group/segment count."""
    if w.ngroups == target_groups and w.nseg == target_groups:
        return w
    assert target_groups % w.tile_groups == 0, (
        f"target_groups={target_groups} must be a multiple of "
        f"tile_groups={w.tile_groups}")
    padg = target_groups - w.ngroups
    return dataclasses.replace(
        w,
        values_hi=jnp.pad(w.values_hi, ((0, 0), (0, padg), (0, 0))),
        values_lo=jnp.pad(w.values_lo, ((0, 0), (0, padg), (0, 0))),
        pos=jnp.pad(w.pos, ((0, 0), (0, padg), (0, 0))),
        w0=jnp.pad(w.w0, (0, padg // w.tile_groups)),
        nseg=target_groups,
    )


def _far_ell_ds(far, nrows_pad):
    """Far-remainder CSR -> (colind, vh, vl) ELL rectangle (None if empty)."""
    if far.nnz == 0:
        return None
    kf = int(far.row_nnz().max())
    ci = np.zeros((nrows_pad, kf), np.int32)
    v64 = np.zeros((nrows_pad, kf), np.float64)
    lens = far.row_nnz()
    rows = np.repeat(np.arange(far.nrows), lens)
    slot = np.arange(far.nnz) - np.repeat(far.rowptr[:-1], lens)
    ci[rows, slot] = far.colind
    v64[rows, slot] = far.values
    vh, vl = ds_from_f64(v64)
    return (jnp.asarray(ci), jnp.asarray(vh), jnp.asarray(vl))


def csr_to_well_sym_ds(
    a,
    tile_groups: int = 16,
    max_k: int = 64,
    wseg_cap: int = 512,
) -> SymWellDsMatrix:
    """f64 symmetric host CSR -> dual-WELL double-single format. Only the
    lower triangle of ``a`` is read (reference symmetric-reader semantics,
    reference spmv/read_petsc.cpp:177-188)."""
    from spmv_tpu.formats.well import split_window

    if a.nrows != a.ncols:
        raise ValueError("symmetric storage requires a square matrix")
    lower, diag = a.split_lower_diag()
    upper_full = lower.transpose()
    near_l, far_l = split_window(lower, tile_groups, wseg_cap)
    near_u, far_u = split_window(upper_full, tile_groups, wseg_cap)
    wl = csr_to_well_ds(near_l, tile_groups, max_k)
    wu = csr_to_well_ds(near_u, tile_groups, max_k)
    # one common layout for both triangles (formats/well._pad_well_to)
    tgt = max(wl.ngroups, wu.ngroups)
    wl, wu = _pad_well_ds_to(wl, tgt), _pad_well_ds_to(wu, tgt)
    npad = max(wl.nrows_pad, wu.nrows_pad)
    d64 = np.zeros(npad, np.float64)
    d64[: len(diag)] = diag
    dh, dl = ds_from_f64(d64)
    return SymWellDsMatrix(
        lower=wl,
        upper=wu,
        diag_hi=jnp.asarray(dh),
        diag_lo=jnp.asarray(dl),
        farl=_far_ell_ds(far_l, npad),
        faru=_far_ell_ds(far_u, npad),
        nrows=a.nrows,
    )


def spmv_well_sym_ds(
    a: SymWellDsMatrix, xh: jax.Array, xl: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """y = (L + D + L^T) x in double-single arithmetic: two DS gathers +
    DS diagonal product + (small) DS far-ELL chains — no scatters,
    error-free per output row. ``(xh, xl)`` flat (>= nrows); returns flat
    (yh, yl) of length nrows_pad."""
    npad = a.nrows_pad

    def padto(v, m):
        if v.shape[0] == m:
            return v
        return jnp.zeros((m,), v.dtype).at[: min(v.shape[0], m)].set(v[:m])

    def leg(w, h, l):
        xh2 = padto(h, w.ncols_pad).reshape(-1, LANES)
        xl2 = padto(l, w.ncols_pad).reshape(-1, LANES)
        yh2, yl2 = spmv_well_ds_2d(w, xh2, xl2)
        return yh2.reshape(-1), yl2.reshape(-1)

    yh, yl = leg(a.lower, xh, xl)
    uh, ul = leg(a.upper, xh, xl)
    yh, yl = ds_add(yh, yl, uh, ul)
    xh_p, xl_p = padto(xh, npad), padto(xl, npad)
    dh, dl = ds_mul_f32(a.diag_hi, a.diag_lo, xh_p, xl_p)
    yh, yl = ds_add(yh, yl, dh, dl)
    for far in (a.farl, a.faru):
        if far is not None:
            ci, vh, vl = far
            gh = jnp.take(xh_p, ci, axis=0)  # padto covers far cols <= npad
            gl = jnp.take(xl_p, ci, axis=0)
            fh = jnp.zeros((npad,), jnp.float32)
            fl = jnp.zeros((npad,), jnp.float32)
            for kk in range(ci.shape[1]):
                ph, plo = ds_mul_f32(vh[:, kk], vl[:, kk],
                                     gh[:, kk], gl[:, kk])
                fh, fl = ds_add(fh, fl, ph, plo)
            yh, yl = ds_add(yh, yl, fh, fl)
    return yh, yl
