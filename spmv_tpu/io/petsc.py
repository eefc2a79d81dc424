"""PETSc binary matrix/vector I/O.

A rebuild of the reference loader (reference spmv/read_petsc.cpp):
big-endian PETSc binary format, matrix magic 1211216 and vector magic 1211214
(read_petsc.cpp:74-76, :230-303). The reference does manual per-value byte
swaps in C++ (read_petsc.cpp:67-71); here the whole file parses as vectorized
numpy big-endian views — and unlike the reference, a *writer* exists too, so
benchmark fixtures can round-trip.

Row-sliced reads (``row_range``) reproduce the reference's each-rank-reads-
its-slice strategy (read_petsc.cpp:109-124: seek past other ranks' nnz using
the per-row-nnz prefix sum).
"""
from __future__ import annotations

import numpy as np

from spmv_tpu.formats.csr import CSRHost

MAT_CLASSID = 1211216
VEC_CLASSID = 1211214

_I = np.dtype(">i4")
_D = np.dtype(">f8")


def read_petsc_binary_matrix_host(
    path: str, row_range: tuple[int, int] | None = None, native: bool = True
) -> CSRHost:
    """Read a PETSc binary matrix into host CSR (float64).

    With ``row_range=(r0, r1)``, reads only those rows (global column
    indices preserved), seeking directly to their index/value spans.
    Uses the mmap'd C++ parser (spmv_tpu.native) when available; the numpy
    path below is the reference implementation and the fallback.
    """
    if native:
        out = _read_matrix_native(path, row_range)
        if out is not None:
            return out
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=_I, count=4)
        if len(header) != 4 or header[0] != MAT_CLASSID:
            raise ValueError(f"{path}: not a PETSc binary matrix (magic {header[:1]})")
        nrows, ncols, nnz = (int(v) for v in header[1:])
        row_nnz = np.fromfile(f, dtype=_I, count=nrows).astype(np.int64)
        if len(row_nnz) != nrows:
            raise ValueError(f"{path}: truncated nnz-per-row table")
        data_start = f.tell()
        if row_range is None:
            r0, r1 = 0, nrows
        else:
            r0, r1 = row_range
            if not (0 <= r0 <= r1 <= nrows):
                raise ValueError(f"bad row_range {row_range} for {nrows} rows")
        prefix = np.concatenate([[0], np.cumsum(row_nnz)])
        lo, hi = int(prefix[r0]), int(prefix[r1])
        f.seek(data_start + lo * _I.itemsize)
        colind = np.fromfile(f, dtype=_I, count=hi - lo)
        f.seek(data_start + nnz * _I.itemsize + lo * _D.itemsize)
        values = np.fromfile(f, dtype=_D, count=hi - lo)
        if len(colind) != hi - lo or len(values) != hi - lo:
            raise ValueError(f"{path}: truncated matrix payload")
    rowptr = prefix[r0 : r1 + 1] - lo
    return CSRHost(
        rowptr=rowptr,
        colind=colind.astype(np.int32),
        values=values.astype(np.float64),
        ncols=ncols,
    )


def _read_matrix_native(
    path: str, row_range: tuple[int, int] | None
) -> CSRHost | None:
    """mmap'd C++ fast path; returns None when the native lib is missing so
    the caller falls back to numpy. Raises the same ValueErrors as the numpy
    path for malformed files."""
    import ctypes

    from spmv_tpu.native.lib import get_lib

    lib = get_lib()
    if lib is None:
        return None
    nrows = ctypes.c_int64()
    ncols = ctypes.c_int64()
    nnz = ctypes.c_int64()
    rc = lib.spmv_petsc_matrix_header(
        path.encode(), ctypes.byref(nrows), ctypes.byref(ncols), ctypes.byref(nnz)
    )
    if rc == -1:
        raise FileNotFoundError(path)
    if rc == -2:
        raise ValueError(f"{path}: not a PETSc binary matrix")
    if rc != 0:
        raise ValueError(f"{path}: truncated matrix payload")
    r0, r1 = row_range if row_range is not None else (0, nrows.value)
    if not (0 <= r0 <= r1 <= nrows.value):
        raise ValueError(f"bad row_range {row_range} for {nrows.value} rows")
    rowptr = np.zeros(r1 - r0 + 1, dtype=np.int64)
    slice_nnz = ctypes.c_int64()
    i64p = ctypes.POINTER(ctypes.c_int64)
    rc = lib.spmv_petsc_matrix_read_slice(
        path.encode(), r0, r1, rowptr.ctypes.data_as(i64p), None, None,
        ctypes.byref(slice_nnz),
    )
    if rc != 0:
        raise ValueError(f"{path}: matrix read failed (rc={rc})")
    colind = np.empty(slice_nnz.value, dtype=np.int32)
    values = np.empty(slice_nnz.value, dtype=np.float64)
    rc = lib.spmv_petsc_matrix_read_slice(
        path.encode(), r0, r1, rowptr.ctypes.data_as(i64p),
        colind.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(slice_nnz),
    )
    if rc != 0:
        raise ValueError(f"{path}: matrix read failed (rc={rc})")
    return CSRHost(rowptr=rowptr, colind=colind, values=values, ncols=ncols.value)


def read_petsc_binary_vector_host(
    path: str, index_range: tuple[int, int] | None = None
) -> np.ndarray:
    """Read a PETSc binary vector (float64); optionally only [i0, i1)."""
    with open(path, "rb") as f:
        header = np.fromfile(f, dtype=_I, count=2)
        if len(header) != 2 or header[0] != VEC_CLASSID:
            raise ValueError(f"{path}: not a PETSc binary vector (magic {header[:1]})")
        n = int(header[1])
        i0, i1 = index_range if index_range is not None else (0, n)
        if not (0 <= i0 <= i1 <= n):
            raise ValueError(f"bad index_range {index_range} for size {n}")
        f.seek(i0 * _D.itemsize, 1)
        data = np.fromfile(f, dtype=_D, count=i1 - i0)
        if len(data) != i1 - i0:
            raise ValueError(f"{path}: truncated vector payload")
    return data.astype(np.float64)


def write_petsc_binary_matrix(path: str, a: CSRHost) -> None:
    """Write host CSR as a PETSc binary matrix (big-endian, float64)."""
    with open(path, "wb") as f:
        np.array([MAT_CLASSID, a.nrows, a.ncols, a.nnz], dtype=_I).tofile(f)
        a.row_nnz().astype(_I).tofile(f)
        a.colind.astype(_I).tofile(f)
        a.values.astype(_D).tofile(f)


def write_petsc_binary_vector(path: str, x: np.ndarray) -> None:
    with open(path, "wb") as f:
        x = np.asarray(x).ravel()
        np.array([VEC_CLASSID, len(x)], dtype=_I).tofile(f)
        x.astype(_D).tofile(f)
