"""ELL SpMV: y = alpha * A @ x + beta * y.

General-sparsity path. The gather x[colind] + row-sum formulation replaces
the reference's CSR row loops (reference spmv/csr_kernels.cpp:42-50); the
symmetric variant replaces the atomic/conflict-map transpose scatter
(reference spmv/csr_kernels.openmp.cpp:89-221, spmv/cuda/csr_kernels.cuda.cu:23-47)
with a deterministic XLA scatter-add: determinism makes results bitwise
reproducible across runs (an improvement over the reference, SURVEY.md
section 5).

Semantics follow SubMatrix::mult(alpha, in, beta, out)
(reference spmv/sub_matrix.h:26-122). Outputs are padded to ``a.nrows_pad``;
rows >= a.nrows receive alpha*0 (+ beta*y padding).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from spmv_tpu.formats.ell import EllMatrix


def _pad_to(x: jax.Array, n: int) -> jax.Array:
    if x.shape[0] == n:
        return x
    if x.shape[0] > n:
        return x[:n]
    return jnp.pad(x, (0, n - x.shape[0]))


def spmv_ell(
    a: EllMatrix,
    x: jax.Array,
    alpha=1.0,
    beta=0.0,
    y: jax.Array | None = None,
) -> jax.Array:
    """Apply a (possibly symmetric-stored) ELL matrix.

    x must have length >= a.ncols (a padded ghost tail beyond ncols is fine
    and ignored). Returns a vector of length a.nrows_pad.
    """
    ax = _apply(a, x)
    if y is None:
        return alpha * ax
    return alpha * ax + beta * _pad_to(y, a.nrows_pad)


def _apply(a: EllMatrix, x: jax.Array) -> jax.Array:
    gathered = jnp.take(x, a.colind, axis=0)  # (nrows_pad, K)
    out = jnp.einsum("rk,rk->r", a.values, gathered,
                     precision=jax.lax.Precision.HIGHEST)
    if not a.symmetric:
        return out
    # Symmetric storage: A = L + D + L^T with only L in a.values.
    # D term + transpose term L^T x: scatter v * x[row] into column slots.
    xr = _pad_to(x, a.nrows_pad)
    out = out + a.diagonal * xr
    contrib = a.values * xr[:, None]  # (nrows_pad, K); padded slots are v=0
    out = out.at[a.colind.reshape(-1)].add(
        contrib.reshape(-1), mode="promise_in_bounds"
    )
    return out


def spmv_ell_transpose(a: EllMatrix, x: jax.Array, out_size: int | None = None) -> jax.Array:
    """y = A^T @ x for non-symmetric ELL — the working transpose-mult the
    reference declares but never implemented (reference spmv/Matrix.cpp:144-148).

    Returns a vector of length ``out_size`` (default a.ncols, padded up to a
    multiple of 8).
    """
    if a.symmetric:
        raise ValueError("symmetric-stored matrices are self-transpose; use spmv_ell")
    n = out_size if out_size is not None else -(-a.ncols // 8) * 8
    xr = _pad_to(x, a.nrows_pad)
    contrib = a.values * xr[:, None]
    out = jnp.zeros(n, dtype=jnp.result_type(a.values, x))
    return out.at[a.colind.reshape(-1)].add(
        contrib.reshape(-1), mode="promise_in_bounds"
    )
