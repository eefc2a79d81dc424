"""DIA SpMV/SpMM: y = alpha * A @ x + beta * y for banded matrices.

The stencil path: SpMV over diagonal storage is a static set of shifted
elementwise multiply-adds — no gather, no indices read from memory at all.
Everything stays in the 2-D (rows, 128) lane layout that ``DiaMatrix.data``
and the distributed vectors use, so a shift by ``off`` flat positions is a
shift by ``off // 128`` rows plus a lane rotation of ``off % 128`` built
from two row slices and a lane concatenate. XLA fuses the K shifted
multiply-adds into one loop fusion that streams each diagonal once and
reads x from cache. Compare the reference, which runs even stencil
matrices through general CSR (reference demos/CreateA.cpp +
spmv/csr_kernels.cpp).

Block (multi-RHS) vectors use the (rows, nrhs*128) layout: element
(i, r*128 + j) is flat element i*128 + j of right-hand side r. The same
shift acts on each RHS's 128-lane slice, so one fusion reads the matrix
once for the whole block.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from spmv_tpu.formats.dia import DiaMatrix

LANES = 128


def shift_rows(v3: jax.Array, off: int, rows_out: int) -> jax.Array:
    """w[i, :, j] = flat element ``i*128 + j + off`` of each RHS of
    ``v3`` (rows, nrhs, 128), zero outside ``v3``; ``rows_out`` rows."""
    q, rr = divmod(off, LANES)
    lo = max(0, -q)
    hi = max(0, q + 1 + rows_out - v3.shape[0])
    vp = jnp.pad(v3, ((lo, hi), (0, 0), (0, 0)))
    a = vp[lo + q: lo + q + rows_out]
    if rr == 0:
        return a
    b = vp[lo + q + 1: lo + q + 1 + rows_out]
    return jnp.concatenate([a[..., rr:], b[..., :rr]], axis=-1)


def dia_apply(data: jax.Array, offsets: tuple[int, ...], x3: jax.Array,
              symmetric: bool = False) -> jax.Array:
    """Local DIA product in the lane layout.

    ``data``: (R, K*128) row-interleaved diagonals (``DiaMatrix.data``);
    ``x3``: (Rx, nrhs, 128) with Rx >= R (extra rows hold columns past the
    square part); returns (R, nrhs, 128). ``symmetric`` storage holds
    offsets <= 0 and applies L + D + L^T: the transpose of diagonal ``off``
    is diagonal ``-off`` whose data is the same diagonal shifted by -off.
    """
    rows = data.shape[0]
    acc_dtype = jnp.result_type(data.dtype, x3.dtype)
    out = jnp.zeros((rows,) + x3.shape[1:], acc_dtype)
    for d, off in enumerate(offsets):
        diag = data[:, d * LANES:(d + 1) * LANES][:, None, :]
        out = out + diag * shift_rows(x3, off, rows)
        if symmetric and off < 0:
            # y[i] += A[i-off, i] * x[i-off] = d_off[i-off] * x[i-off]
            out = out + shift_rows(diag * x3[:rows], -off, rows)
    return out


def dia_to_2d(a: DiaMatrix, x: jax.Array) -> jax.Array:
    """Reshape a flat vector into the (nrows_pad/128, 128) lane layout
    (free when len(x) == nrows_pad; zero-fills/truncates otherwise)."""
    npad = a.nrows_pad
    if x.ndim == 2:
        return x
    if x.shape[0] != npad:
        take = min(x.shape[0], npad)
        x = jnp.zeros((npad,), x.dtype).at[:take].set(x[:take])
    return x.reshape(npad // LANES, LANES)


def spmv_dia_2d(a: DiaMatrix, x2: jax.Array) -> jax.Array:
    """SpMV in lane layout: x2 (nrows_pad/128, 128) -> y (nrows_pad/128,
    128). The solver hot path — repeated applies chain with no relayout."""
    return dia_apply(a.data, a.offsets, x2[:, None, :], a.symmetric)[:, 0, :]


def spmv_dia(
    a: DiaMatrix,
    x: jax.Array,
    alpha=1.0,
    beta=0.0,
    y: jax.Array | None = None,
) -> jax.Array:
    """Apply a DIA matrix. x must have length >= a.ncols. Returns length
    a.nrows_pad (rows >= a.nrows zero-padded, as in spmv_ell)."""
    npad = a.nrows_pad
    take = min(x.shape[0], a.ncols)
    nx = max(npad, -(-take // LANES) * LANES)
    xp = jnp.zeros((nx,), x.dtype).at[:take].set(x[:take])
    out = dia_apply(a.data, a.offsets, xp.reshape(-1, 1, LANES),
                    a.symmetric).reshape(npad)
    if y is None:
        return alpha * out
    yp = y if y.shape[0] == npad else jnp.pad(y[:npad], (0, max(0, npad - y.shape[0])))
    return alpha * out + beta * yp


def block_to_columns(x2: jax.Array) -> jax.Array:
    """(rows, nrhs*128) block layout -> (rows*128, nrhs) columns."""
    rows = x2.shape[0]
    return (x2.reshape(rows, -1, LANES)
            .transpose(0, 2, 1)
            .reshape(rows * LANES, -1))


def columns_to_block(y: jax.Array) -> jax.Array:
    """(n, nrhs) columns, n a multiple of 128 -> (n/128, nrhs*128)."""
    n, nrhs = y.shape
    return (y.reshape(n // LANES, LANES, nrhs)
            .transpose(0, 2, 1)
            .reshape(n // LANES, nrhs * LANES))


def spmm_to_layout(a: DiaMatrix, x: jax.Array) -> jax.Array:
    """(n, nrhs) column block -> the (nrows_pad/128, nrhs*128) layout."""
    npad = a.nrows_pad
    n, nrhs = x.shape
    xp = x if n == npad else jnp.zeros((npad, nrhs), x.dtype).at[:n].set(x)
    return columns_to_block(xp)


def spmm_from_layout(y2: jax.Array, nrhs: int) -> jax.Array:
    """Inverse of spmm_to_layout: (rows, nrhs*128) -> (rows*128, nrhs)."""
    return block_to_columns(y2).reshape(-1, nrhs)


def spmm_dia_2d(a: DiaMatrix, x2: jax.Array) -> jax.Array:
    """Block SpMM in the (rows, nrhs*128) layout: the matrix is read once
    for the whole block."""
    rows = x2.shape[0]
    y3 = dia_apply(a.data, a.offsets, x2.reshape(rows, -1, LANES),
                   a.symmetric)
    return y3.reshape(rows, -1)


def spmm_dia(a: DiaMatrix, x: jax.Array) -> jax.Array:
    """Y = A X for X (n, nrhs) with n <= nrows_pad. Returns
    (nrows_pad, nrhs)."""
    nrhs = x.shape[1]
    return spmm_from_layout(spmm_dia_2d(a, spmm_to_layout(a, x)), nrhs)
