"""Bandwidth-reduction reordering (reverse Cuthill-McKee) + permutation.

The reference runs arbitrary CSR through vendor kernels (cuSPARSE,
reference spmv/cuda/csr_kernels.cuda.cu:106-151) and never reorders. Here
the compact SpMV formulations are window-local (DIA diagonals, the windowed
gather-ELL layout), so concentrating nonzeros near the diagonal is a
first-class assembly step: RCM here typically shrinks an unstructured
matrix's bandwidth by orders of magnitude, which directly shrinks the
x-windows (and for near-banded matrices unlocks the DIA path).

All host-side. Two tiers with BITWISE-identical outputs (regression-tested
in tests/test_reorder.py): a native C++ pipeline (spmv_tpu.native — counting
passes + tiny per-row sorts, O(nnz); 53 s -> ~5 s at 10M rows / 56M nnz,
the numpy path is global-sort-bound) and a vectorized numpy fallback
(per-BFS-level frontier expansion via repeat/cumsum multi-slice gathers,
no per-node Python loops).
"""
from __future__ import annotations

import ctypes

import numpy as np

from spmv_tpu.formats.csr import CSRHost

_I64P = None  # bound lazily with the lib


def _c64(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _c32(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def bandwidth(a: CSRHost) -> int:
    """max |col - row| over stored entries (0 for diagonal/empty)."""
    if a.nnz == 0:
        return 0
    rows = np.repeat(np.arange(a.nrows, dtype=np.int64), a.row_nnz())
    return int(np.abs(a.colind.astype(np.int64) - rows).max())


def _neighbors_of(
    rowptr: np.ndarray, colind: np.ndarray, frontier: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Concatenated adjacency of all frontier nodes (vectorized multi-slice):
    returns (neighbor cols, index of the frontier parent per neighbor).
    ``rowptr``/``colind`` must be int64 (hoisted conversions: per-level
    astype was ~20% of a 10M-row RCM)."""
    starts = rowptr[frontier]
    cnt = rowptr[frontier + 1] - starts
    total = int(cnt.sum())
    if total == 0:
        return np.empty(0, np.int64), np.empty(0, np.int64)
    shift = np.repeat(starts - np.concatenate([[0], np.cumsum(cnt)[:-1]]), cnt)
    nbr = colind[np.arange(total, dtype=np.int64) + shift]
    parent = np.repeat(np.arange(len(frontier), dtype=np.int64), cnt)
    return nbr, parent


def reverse_cuthill_mckee(a: CSRHost, native: bool = True) -> np.ndarray:
    """RCM ordering of a structurally symmetric square matrix's graph.

    Returns ``order`` such that new row i is old row ``order[i]``. Matrices
    with non-symmetric structure still get a valid permutation (BFS runs on
    the out-edges); symmetrize first (A + A^T pattern) for best bandwidth.
    ``native=False`` forces the numpy tier (same output bitwise).
    """
    if a.nrows != a.ncols:
        raise ValueError("RCM needs a square matrix")
    if native:
        from spmv_tpu.native.lib import get_lib

        lib = get_lib()
        if lib is not None:
            rowptr = np.ascontiguousarray(a.rowptr, dtype=np.int64)
            colind = np.ascontiguousarray(a.colind, dtype=np.int32)
            order = np.empty(a.nrows, dtype=np.int64)
            rc = lib.spmv_rcm_order(_c64(rowptr), _c32(colind),
                                    ctypes.c_int64(a.nrows), _c64(order))
            if rc == 0:
                return order
    n = a.nrows
    rowptr64 = np.ascontiguousarray(a.rowptr, dtype=np.int64)
    colind64 = np.ascontiguousarray(a.colind, dtype=np.int64)
    deg = a.row_nnz().astype(np.int64)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    deg_sorted = np.argsort(deg, kind="stable")  # start nodes: min degree
    ptr = 0
    while pos < n:
        while visited[deg_sorted[ptr]]:
            ptr += 1
        start = deg_sorted[ptr]
        visited[start] = True
        order[pos] = start
        pos += 1
        frontier = np.array([start], dtype=np.int64)
        while True:
            nbr, parent = _neighbors_of(rowptr64, colind64, frontier)
            mask = ~visited[nbr] if len(nbr) else np.empty(0, bool)
            nbr, parent = nbr[mask], parent[mask]
            if len(nbr) == 0:
                break
            # classic CM tie-breaking: group by parent's position in the
            # frontier, then ascending degree; first occurrence wins
            k = np.lexsort((deg[nbr], parent))
            nbr = nbr[k]
            _, first = np.unique(nbr, return_index=True)
            new = nbr[np.sort(first)]
            visited[new] = True
            order[pos : pos + len(new)] = new
            pos += len(new)
            frontier = new
    return order[::-1].copy()  # the "reverse" in RCM


def permute_symmetric(a: CSRHost, order: np.ndarray,
                      native: bool = True) -> CSRHost:
    """B[i, j] = A[order[i], order[j]] — simultaneous row+col permutation
    (preserves symmetry/SPD-ness, so CG on B solves the permuted system).

    Native tier: counting by new row + per-row sorts, no global argsort
    (~20 s -> ~2 s at 10M rows / 56M nnz). numpy fallback: single-key sort
    (row*ncols + col as one int64) instead of from_coo's two-pass lexsort."""
    if native and a.values.dtype in (np.float32, np.float64):
        from spmv_tpu.native.lib import get_lib

        lib = get_lib()
        if lib is not None:
            rowptr = np.ascontiguousarray(a.rowptr, dtype=np.int64)
            colind = np.ascontiguousarray(a.colind, dtype=np.int32)
            values = np.ascontiguousarray(a.values)
            order64 = np.ascontiguousarray(order, dtype=np.int64)
            new_rowptr = np.empty(a.nrows + 1, dtype=np.int64)
            new_colind = np.empty(a.nnz, dtype=np.int32)
            new_values = np.empty(a.nnz, dtype=values.dtype)
            fn = (lib.spmv_permute_csr_f64
                  if values.dtype == np.float64
                  else lib.spmv_permute_csr_f32)
            vp = values.ctypes.data_as(ctypes.POINTER(
                ctypes.c_double if values.dtype == np.float64
                else ctypes.c_float))
            ovp = new_values.ctypes.data_as(ctypes.POINTER(
                ctypes.c_double if values.dtype == np.float64
                else ctypes.c_float))
            rc = fn(_c64(rowptr), _c32(colind), vp,
                    ctypes.c_int64(a.nrows), _c64(order64),
                    _c64(new_rowptr), _c32(new_colind), ovp)
            if rc == 0:
                return CSRHost(new_rowptr, new_colind, new_values, a.ncols)
    inv = np.empty(len(order), dtype=np.int64)
    inv[order] = np.arange(len(order), dtype=np.int64)
    rows = np.repeat(np.arange(a.nrows, dtype=np.int64), a.row_nnz())
    key = inv[rows] * np.int64(a.ncols) + inv[a.colind.astype(np.int64)]
    k = np.argsort(key)  # keys are unique -> stability irrelevant
    ks = key[k]
    new_rows = (ks // a.ncols).astype(np.int64)
    rowptr = np.zeros(a.nrows + 1, dtype=np.int64)
    np.cumsum(np.bincount(new_rows, minlength=a.nrows), out=rowptr[1:])
    return CSRHost(rowptr, (ks % a.ncols).astype(np.int32), a.values[k],
                   a.ncols)


def bandwidth_quantile(a: CSRHost, q: float = 90.0,
                       sample: int = 2_000_000) -> float:
    """q-th percentile of |col - row| over (sampled) entries — the
    window-locality figure the DIA/WELL formats care about (a handful of
    outliers belong in far/hub side terms; the BULK must be near the
    diagonal, which max-bandwidth cannot see)."""
    if a.nnz == 0:
        return 0.0
    if a.nnz > sample:
        idx = np.arange(0, a.nnz, a.nnz // sample, dtype=np.int64)
    else:
        idx = np.arange(a.nnz, dtype=np.int64)
    rows = np.searchsorted(a.rowptr, idx, side="right") - 1
    return float(np.percentile(
        np.abs(a.colind[idx].astype(np.int64) - rows), q))


def rcm_reorder(a: CSRHost, native: bool = True,
                keep_best: bool = False) -> tuple[CSRHost, np.ndarray]:
    """Convenience: symmetrize the pattern, compute RCM on it, and return
    (permuted matrix, order). ``order`` maps new->old; apply to vectors with
    x_new = x_old[order], and undo with y_old = y_new[inverse].

    ``keep_best=True``: compare the bulk window locality
    (``bandwidth_quantile`` p90) before and after and return the IDENTITY
    ordering when RCM made it worse — BFS orderings can DESTROY an
    already-structured matrix whose long-range edges span the graph
    (measured: an 800^2 grid + 5% random edges went from p90 bandwidth
    800 / 1.8% outside a 512-segment window to p90 103854 / 48% outside
    under RCM). The raw RCM stays available with the default."""
    if a.nrows != a.ncols:
        raise ValueError("rcm_reorder needs a square matrix")
    if keep_best:
        b, order = rcm_reorder(a, native=native, keep_best=False)
        if bandwidth_quantile(b) < bandwidth_quantile(a):
            return b, order
        return a, np.arange(a.nrows, dtype=np.int64)
    if native:
        from spmv_tpu.native.lib import get_lib

        lib = get_lib()
        if lib is not None:
            rowptr = np.ascontiguousarray(a.rowptr, dtype=np.int64)
            colind = np.ascontiguousarray(a.colind, dtype=np.int32)
            sym_rowptr = np.empty(a.nrows + 1, dtype=np.int64)
            sym_colind = np.empty(max(2 * a.nnz, 1), dtype=np.int32)
            m = lib.spmv_rcm_symmetrize(
                _c64(rowptr), _c32(colind), ctypes.c_int64(a.nrows),
                ctypes.c_int64(a.nnz), _c64(sym_rowptr), _c32(sym_colind))
            if m >= 0:
                sym = CSRHost(sym_rowptr, sym_colind[:m],
                              np.ones(m, dtype=np.int8), a.ncols)
                order = reverse_cuthill_mckee(sym)
                return permute_symmetric(a, order), order
    rows = np.repeat(np.arange(a.nrows, dtype=np.int64), a.row_nnz())
    cols = a.colind.astype(np.int64)
    # pattern-only symmetrization via ONE sorted-unique pass over packed
    # (row*ncols + col) keys — from_coo's lexsort + duplicate-sum was the
    # 10M-row bottleneck (measured 121 s -> ~25 s; values are irrelevant
    # for the BFS, int8 ones keep the footprint small)
    n64 = np.int64(a.ncols)
    keys = np.concatenate([rows * n64 + cols, cols * n64 + rows])
    keys.sort()  # in-place + boolean dedup ~ 2x np.unique (no extra copy)
    if len(keys):
        keep = np.empty(len(keys), dtype=bool)
        keep[0] = True
        np.not_equal(keys[1:], keys[:-1], out=keep[1:])
        keys = keys[keep]
    sym_rows = (keys // n64).astype(np.int64)
    rowptr = np.zeros(a.nrows + 1, dtype=np.int64)
    np.cumsum(np.bincount(sym_rows, minlength=a.nrows), out=rowptr[1:])
    sym = CSRHost(rowptr, (keys % n64).astype(np.int32),
                  np.ones(len(keys), dtype=np.int8), a.ncols)
    order = reverse_cuthill_mckee(sym, native=native)
    return permute_symmetric(a, order, native=native), order
