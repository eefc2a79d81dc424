"""DIA (diagonal) device format — the stencil/banded fast path.

For banded operators (the reference's benchmark matrices: 1-D 3-point and
2-D 5-point Laplacians, reference demos/CreateA.cpp:52-68), SpMV in DIA form
is a handful of shifted elementwise multiply-adds — no gather at all: one
pass over the diagonal data at memory bandwidth.

data[d, i] = A[i, i + offsets[d]]  (zero where the column falls outside).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from spmv_tpu.formats.csr import CSRHost


@dataclasses.dataclass
class DiaMatrix:
    """Device-resident diagonal-format matrix.

    data:    (nrows_pad // 128, ndiags * 128) — ROW-INTERLEAVED lane layout:
             data[r, d*128 + l] = A[128r + l, 128r + l + offsets[d]].
             Interleaving keeps every row block of all K diagonals in ONE
             contiguous chunk of device memory; a lane slice at
             128-multiples picks one diagonal.
    offsets: static tuple of diagonal offsets (j - i), ascending
    """

    data: jax.Array
    offsets: tuple[int, ...]
    nrows: int
    ncols: int
    symmetric: bool = False  # offsets <= 0 only; A = L + D + L^T implied
    _nnz: int = 0

    @property
    def nrows_pad(self) -> int:
        return self.data.shape[0] * 128

    @property
    def data_flat(self) -> jax.Array:
        """(ndiags, nrows_pad) logical view — for the XLA fallback path and
        host-side inspection. MATERIALIZES a de-interleaved copy; do NOT use
        inside hot loops."""
        r = self.data.shape[0]
        k = self.ndiags
        return (self.data.reshape(r, k, 128)
                .transpose(1, 0, 2)
                .reshape(k, r * 128))

    @property
    def ndiags(self) -> int:
        return len(self.offsets)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def nnz_stored(self) -> int:
        return int(self._nnz)

    def format_size_bytes(self) -> int:
        return self.data.size * self.data.dtype.itemsize


jax.tree_util.register_dataclass(
    DiaMatrix,
    data_fields=["data"],
    meta_fields=["offsets", "nrows", "ncols", "symmetric", "_nnz"],
)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def flat_to_interleaved(flat, k: int):
    """(K, npad) per-diagonal rows -> the (npad/128, K*128) device layout.
    Works on numpy or jax arrays."""
    npad = flat.shape[1]
    return (flat.reshape(k, npad // 128, 128)
            .transpose(1, 0, 2)
            .reshape(npad // 128, k * 128))


def dia_transpose(a: DiaMatrix) -> DiaMatrix:
    """A^T as a DiaMatrix — the diagonal of offset o becomes offset -o with
    the SAME data shifted by o rows: dataT[d', i] = A^T[i, i+o'] = A[i+o', i]
    = data[d, i+o'] for o = -o'. One pass over the matrix data, no new
    kernel; gives the DIA-format path the working transpose product the
    reference declares but never implemented
    (reference spmv/Matrix.cpp:144-148 ``transpmult`` throws).

    Symmetric-stored matrices are self-transpose and returned as-is.
    """
    if a.symmetric:
        return a
    if a.nrows != a.ncols:
        raise ValueError("dia_transpose requires a square matrix")
    flat = a.data_flat  # (K, npad)
    npad = a.nrows_pad
    new_offsets = tuple(-o for o in reversed(a.offsets))
    rows = []
    for o_new in new_offsets:
        row = flat[a.offsets.index(-o_new)]
        if o_new > 0:
            row = jnp.concatenate([row[o_new:], jnp.zeros((o_new,), row.dtype)])
        elif o_new < 0:
            row = jnp.concatenate([jnp.zeros((-o_new,), row.dtype), row[:o_new]])
        rows.append(row)
    data_t = jnp.stack(rows)
    return DiaMatrix(
        data=flat_to_interleaved(data_t, a.ndiags),
        offsets=new_offsets,
        nrows=a.ncols,
        ncols=a.nrows,
        symmetric=False,
        _nnz=a._nnz,
    )


def csr_to_dia_host(
    a: CSRHost,
    row_align: int = 128,
    max_diags: int = 64,
    dtype=None,
    symmetric: bool = False,
) -> tuple[np.ndarray, tuple[int, ...], int]:
    """Host-side DIA build: returns (data (K, nrows_pad) NUMPY in the
    caller-requested dtype — no device round-trip, so f64 stays f64 even
    without x64 —, offsets, stored nnz)."""
    return _csr_to_dia_host(a, row_align, max_diags, dtype, symmetric)


def csr_to_dia(
    a: CSRHost,
    row_align: int = 128,
    max_diags: int = 64,
    dtype=None,
    symmetric: bool = False,
) -> DiaMatrix:
    """Convert host CSR to DIA. Raises if the matrix has more than
    ``max_diags`` distinct diagonals (then it is not band-structured and ELL
    should be used instead). Rows pad to a multiple of 128 (the lane
    layout of ``DiaMatrix.data``).

    With ``symmetric=True`` (input must be structurally+numerically
    symmetric), only diagonals with offset <= 0 are stored — the DIA form of
    the reference's lower-triangle optimization (reference
    spmv/Matrix.cpp:337-349). Unlike the ELL symmetric path, applying it
    needs no scatter at all: the transpose of diagonal o is diagonal -o with
    the same data shifted by -o.
    """
    row_align_eff = max(_round_up(row_align, 128), 128)
    nat = _csr_to_dia_native(a, row_align_eff, max_diags, dtype, symmetric,
                             interleaved=True)
    if nat is not None:
        # native pack wrote the device layout directly (no transpose pass)
        data2d, offsets, nnz = nat
        k = max(len(offsets), 1)
        data = jnp.asarray(data2d.reshape(-1, k * 128))
    else:
        flat, offsets, nnz = _csr_to_dia_host(a, row_align, max_diags, dtype,
                                              symmetric)
        data = jnp.asarray(flat_to_interleaved(flat, flat.shape[0]))
    return DiaMatrix(
        data=data,
        offsets=offsets,
        nrows=a.nrows,
        ncols=a.ncols,
        symmetric=symmetric,
        _nnz=nnz,
    )


def _csr_to_dia_host(a, row_align, max_diags, dtype, symmetric):
    row_align = max(_round_up(row_align, 128), 128)
    out = _csr_to_dia_native(a, row_align, max_diags, dtype, symmetric)
    if out is not None:
        return out
    lens = a.row_nnz()
    # int32 row/offset math (nrows/ncols < 2^31 always holds here): half
    # the memory traffic of the int64 default on these 100M+-element passes
    rows = np.repeat(np.arange(a.nrows, dtype=np.int32), lens)
    offs = a.colind - rows
    vals_all = a.values
    if symmetric:
        keep = offs <= 0
        rows, offs, vals_all = rows[keep], offs[keep], vals_all[keep]
    uniq = np.unique(offs)
    if len(uniq) > max_diags:
        raise ValueError(
            f"matrix has {len(uniq)} distinct diagonals > max_diags={max_diags}; "
            "use ELL format"
        )
    nrows_pad = max(_round_up(a.nrows, row_align), row_align)
    ndiags = max(len(uniq), 1)
    data = np.zeros((ndiags, nrows_pad), dtype=dtype or a.dtype)
    if len(rows):
        dsel = np.searchsorted(uniq, offs)
        # index math in int32 when the flat range fits (ndiags <= 64 keeps
        # even 100M-row matrices well under 2^31 only for small ndiags —
        # check explicitly): halves the traffic of the dominant passes on
        # the single host core
        if ndiags * nrows_pad < 2**31 - 1:
            flat = dsel.astype(np.int32) * np.int32(nrows_pad) + rows
        else:
            flat = dsel * np.int64(nrows_pad) + rows.astype(np.int64)
        # canonical CSR (columns strictly increasing within each row — what
        # from_coo/from_dense/the generators produce, tracked by the
        # `_sorted_unique` construction flag) has no duplicate
        # (row, offset) pairs, so a direct fancy-index ASSIGN into the
        # target dtype suffices and the full-nnz canonicality scan is
        # skipped. Non-canonical inputs take the bincount-accumulate path
        # so duplicate entries still SUM, matching CSR semantics.
        canonical = getattr(a, "_sorted_unique", False)
        if not canonical:
            cols_f = rows + offs
            same_row = rows[1:] == rows[:-1]
            canonical = not bool(np.any((np.diff(cols_f) <= 0) & same_row))
        if canonical:
            data.reshape(-1)[flat] = vals_all.astype(data.dtype, copy=False)
        elif np.iscomplexobj(vals_all):
            # bincount weights must be real: complex values (reference
            # mpi_type traits parity, mpi_utils.h:55-77) split in two.
            acc = np.bincount(
                flat, weights=vals_all.real, minlength=ndiags * nrows_pad
            ) + 1j * np.bincount(
                flat, weights=vals_all.imag, minlength=ndiags * nrows_pad
            )
            data[:] = acc.reshape(ndiags, nrows_pad).astype(data.dtype)
        else:
            acc = np.bincount(
                flat, weights=vals_all, minlength=ndiags * nrows_pad
            )
            data[:] = acc.reshape(ndiags, nrows_pad).astype(data.dtype)
    return data, tuple(int(o) for o in uniq) or (0,), int(len(rows))


def _csr_to_dia_native(a, row_align, max_diags, dtype, symmetric,
                       interleaved=False):
    """Native (C++) CSR->DIA: sort-free offset scan + single-pass LUT pack
    (spmv_tpu/native/spmv_host.cpp spmv_dia_scan/spmv_dia_pack_*). Used when
    the value dtypes are real f32/f64 and in==out; returns None to fall back
    to the numpy path otherwise (complex, cross-dtype, no toolchain).
    ``interleaved=True`` writes the DiaMatrix device layout
    (nrows_pad/128, ndiags*128) directly, skipping the transpose pass;
    ``row_align`` is used as given (callers apply the >1M-row bump)."""
    import ctypes

    from spmv_tpu.native.lib import get_lib

    out_dtype = np.dtype(dtype or a.dtype)
    if out_dtype != a.values.dtype or out_dtype not in (
        np.dtype(np.float32), np.dtype(np.float64)
    ):
        return None
    lib = get_lib()
    if lib is None:
        return None
    rowptr = np.ascontiguousarray(a.rowptr, dtype=np.int64)
    colind = np.ascontiguousarray(a.colind, dtype=np.int32)
    values = np.ascontiguousarray(a.values)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    offsets = np.zeros(max(max_diags, 1), dtype=np.int64)
    nd = ctypes.c_int64(0)
    kept = ctypes.c_int64(0)
    rc = lib.spmv_dia_scan(
        rowptr.ctypes.data_as(i64p), colind.ctypes.data_as(i32p),
        a.nrows, 1 if symmetric else 0, max_diags,
        offsets.ctypes.data_as(i64p), ctypes.byref(nd), ctypes.byref(kept),
    )
    if rc == -4:
        raise ValueError(
            f"matrix has more than max_diags={max_diags} distinct diagonals; "
            "use ELL format"
        )
    if rc != 0:
        return None
    ndiags = max(int(nd.value), 1)
    nrows_pad = max(_round_up(a.nrows, row_align), row_align)
    shape = ((nrows_pad // 128, ndiags * 128) if interleaved
             else (ndiags, nrows_pad))
    data = np.zeros(shape, dtype=out_dtype)
    if kept.value:
        pack = (lib.spmv_dia_pack_f32 if out_dtype == np.float32
                else lib.spmv_dia_pack_f64)
        vp = ctypes.POINTER(
            ctypes.c_float if out_dtype == np.float32 else ctypes.c_double)
        rc = pack(
            rowptr.ctypes.data_as(i64p), colind.ctypes.data_as(i32p),
            values.ctypes.data_as(vp), a.nrows, nrows_pad,
            1 if symmetric else 0, 1 if interleaved else 0,
            offsets.ctypes.data_as(i64p), ndiags,
            data.ctypes.data_as(vp),
        )
        if rc != 0:
            return None
    offs = tuple(int(o) for o in offsets[:int(nd.value)]) or (0,)
    return data, offs, int(kept.value)
