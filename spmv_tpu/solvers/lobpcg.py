"""LOBPCG block eigensolver (smallest/largest eigenpairs of symmetric A).

Beyond-reference capability: the reference has no eigensolver at all; this
framework already leans on spectrum information (Chebyshev bounds,
condition estimates — solvers/lanczos.py gives the two EXTREME Ritz values
only). LOBPCG (Knyazev 2001) computes the k smallest (or largest)
eigenpairs simultaneously, which is what mesh-quality analysis, spectral
partitioning, and sharper Chebyshev lower bounds actually need.

Shape — the whole point of choosing LOBPCG over shift-invert Lanczos
here:
- the hot operation is a BLOCK apply A @ X (n, k): on DIA and WELL local
  formats ``DistMatrix.matmat`` reads the matrix ONCE per block;
- everything else is small dense algebra — (3k, 3k) Gram matrices and
  eigendecompositions — replicated, no communication;
- one block apply + two Gram psums per iteration; no inner solves, no
  factorizations, preconditioner optional (e.g.
  ``chebyshev_preconditioner`` on a shifted operator).

Layout-generic: the dense block primitives (column dot, right-combine,
column scale) are injectable, so the same ``lax.while_loop`` serves plain
(n, k) arrays AND the distributed SpMM lane layout (rows, k*128) —
``lane_block_ops()`` provides the adapters; Gram einsums psum under jit.

Basis conditioning is handled the static-shape way (no column dropping,
which would change shapes under jit): the [X W P] Gram is eigendecomposed,
directions below a relative cutoff are zeroed in the whitening map, and
their Ritz values are pushed to +/-inf-side sentinels so Rayleigh-Ritz
never selects them. The first iteration's P = 0 block is exactly such a
masked direction — no special-casing.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
from spmv_tpu.utils.precision import highest_precision


@dataclasses.dataclass
class LOBPCGResult:
    eigenvalues: jax.Array   # (k,) Ritz values, ascending for smallest mode
    X: jax.Array             # (n, k) / lane-layout Ritz vectors, orthonormal
    iterations: jax.Array    # int32
    resid_norms: jax.Array   # (k,) |A x_j - theta_j x_j|
    converged: jax.Array     # bool — all columns below tol


jax.tree_util.register_dataclass(
    LOBPCGResult,
    data_fields=["eigenvalues", "X", "iterations", "resid_norms",
                 "converged"],
    meta_fields=[],
)


# all dense block algebra runs at HIGHEST precision: a reduced-precision
# f32 product (TF32 on GPUs, ~3 decimal digits) corrupts the whitening
# Grams enough to stall convergence. These are small matrices — the extra
# cost is noise next to the block matmat.
_HI = jax.lax.Precision.HIGHEST


def default_block_ops():
    """Dense-layout primitives for (n, k) blocks."""
    block_dot = lambda X, Y: jnp.matmul(X.T, Y, precision=_HI)
    combine = lambda X, C: jnp.matmul(X, C, precision=_HI)
    colscale = lambda X, s: X * s[None, :]
    return block_dot, combine, colscale


def lane_block_ops():
    """Primitives for the distributed SpMM lane layout (rows, k*128):
    element (i, r*128 + j) is flat element i*128 + j of column r (see
    DistMatrix.to_dist_block). The Gram einsum contracts the sharded rows
    axis, so it lowers to a psum under jit — the only communication."""
    def block_dot(X, Y):
        kx, ky = X.shape[1] // 128, Y.shape[1] // 128
        xr = X.reshape(X.shape[0], kx, 128)
        yr = Y.reshape(Y.shape[0], ky, 128)
        return jnp.einsum("arj,asj->rs", xr, yr, precision=_HI)

    def combine(X, C):
        k = X.shape[1] // 128
        xr = X.reshape(X.shape[0], k, 128)
        out = jnp.einsum("arj,rs->asj", xr, C, precision=_HI)
        return out.reshape(X.shape[0], C.shape[1] * 128)

    def colscale(X, s):
        k = X.shape[1] // 128
        xr = X.reshape(X.shape[0], k, 128)
        return (xr * s[None, :, None]).reshape(X.shape)

    return block_dot, combine, colscale


def _whiten_map(G, rtol_rank):
    """Map M with (S M) orthonormal on the well-conditioned subspace of S
    (G = S^T S): eigh-based inverse square root with sub-cutoff directions
    ZEROED (static shape). Returns (M, good) — good marks kept columns."""
    w, V = jnp.linalg.eigh((G + G.T) / 2)
    wmax = jnp.maximum(w[-1], jnp.finfo(G.dtype).tiny)
    good = w > rtol_rank * wmax
    inv = jnp.where(good, 1.0 / jnp.sqrt(jnp.where(good, w, 1.0)), 0.0)
    return V * inv[None, :], good


@highest_precision
def lobpcg(
    matmat: Callable[[jax.Array], jax.Array],
    X0: jax.Array,
    k: int | None = None,
    maxiter: int = 200,
    tol: float = 1e-8,
    preconditioner: Callable[[jax.Array], jax.Array] | None = None,
    largest: bool = False,
    block_ops=None,
) -> LOBPCGResult:
    """Find the ``k`` smallest (``largest=True``: largest) eigenpairs of
    symmetric A, where ``matmat`` applies A to a block.

    ``X0``: initial block — (n, k) in the dense layout, (rows, k*128) in
    the lane layout (pass ``block_ops=lane_block_ops()``); random is fine.
    Padding rows (distributed layout) must be zero, and stay zero under
    ``matmat``, so Gram products are exact — the same contract as
    solvers/cg.py dots.

    ``tol``: converged when every column satisfies
    |A x - theta x| <= tol * max|theta|.
    """
    if block_ops is None:
        block_dot, combine, colscale = default_block_ops()
        if k is None:
            k = X0.shape[1]
    else:
        block_dot, combine, colscale = block_ops
        if k is None:
            raise ValueError(
                "k must be given explicitly with custom block_ops (the "
                "column count is not recoverable from a custom layout)")
    rdtype = jnp.real(jnp.zeros((), dtype=X0.dtype)).dtype
    eps = jnp.finfo(rdtype).eps
    rtol_rank = eps * 100
    sgn = -1.0 if largest else 1.0  # work on sgn*spectrum, ascending select

    def rayleigh_ritz(S, AS):
        """Whiten S, solve the projected problem, return the k best Ritz
        pairs (theta, Cx) in whitened coordinates plus the whitening map.

        Whitening runs TWICE (CholeskyQR2-style): one eigh-based inverse
        square root leaves orthonormality error ~ eps * cond(G), which on
        the near-dependent [X W P] bases LOBPCG produces is enough to push
        Ritz values OUTSIDE the true spectrum (observed: theta below
        lambda_min by 1e-2 on a kappa ~ 1e12 Gram). The second pass acts on
        a Gram that is already ~ I, so its error is ~ eps. Masked (below
        cutoff) directions are exactly-zero columns after pass 1; pass 2's
        eigh keeps that invariant subspace exact, so pass 2's mask is the
        effective one."""
        M1, _good1 = _whiten_map(block_dot(S, S), rtol_rank)
        S1 = combine(S, M1)
        AS1 = combine(AS, M1)
        M2, good = _whiten_map(block_dot(S1, S1), rtol_rank)
        So = combine(S1, M2)
        ASo = combine(AS1, M2)
        T = block_dot(So, ASo)
        T = (T + T.T) / 2
        # sentinel for masked directions: beyond any true Ritz value of
        # the kept subspace, scaled from the data (static-safe)
        big = (jnp.abs(T).sum() + 1.0) * 10.0
        T = jnp.where(good[:, None] & good[None, :], T, 0.0)
        T = T + jnp.diag(jnp.where(good, 0.0, sgn * big))
        w, C = jnp.linalg.eigh(sgn * T)
        theta = sgn * w[:k]
        return theta, C[:, :k], So, ASo

    # --- initial Rayleigh-Ritz on X0 alone ---
    AX0 = matmat(X0)
    theta, Cx, So, ASo = rayleigh_ritz(X0, AX0)
    X = combine(So, Cx)
    AX = combine(ASo, Cx)
    P = jnp.zeros_like(X)
    AP = jnp.zeros_like(X)
    R = AX - colscale(X, theta)
    resid = jnp.sqrt(jnp.maximum(jnp.diag(block_dot(R, R)).real, 0.0))

    def scale(th):
        return jnp.maximum(jnp.max(jnp.abs(th)), jnp.finfo(rdtype).tiny)

    def cond(c):
        it, _X, _AX, _P, _AP, th, rs = c
        return (it < maxiter) & ~jnp.all(rs <= tol * scale(th))

    tiny = jnp.finfo(rdtype).tiny

    def colnorms(Y):
        return jnp.sqrt(jnp.maximum(jnp.diag(block_dot(Y, Y)).real, 0.0))

    def body(c):
        it, X, AX, P, AP, th, _rs = c
        R = AX - colscale(X, th)
        W = preconditioner(R) if preconditioner is not None else R
        # normalize the W and P blocks: their columns shrink as the pairs
        # converge (|W| ~ |r|), and an UNnormalized tiny column falls under
        # the whitening rank cutoff and gets masked — which silently floors
        # the achievable residual at ~sqrt(cutoff). Column scaling leaves
        # the spans (and hence the Ritz problem) unchanged.
        W = colscale(W, 1.0 / jnp.maximum(colnorms(W), tiny))
        pn = colnorms(P)
        pscale = jnp.where(pn > tiny, 1.0 / jnp.maximum(pn, tiny), 0.0)
        P = colscale(P, pscale)
        AP = colscale(AP, pscale)
        S = jnp.concatenate([X, W, P], axis=1)
        AW = matmat(W)
        AS = jnp.concatenate([AX, AW, AP], axis=1)
        th_new, Cx, So, ASo = rayleigh_ritz(S, AS)
        Xn = combine(So, Cx)
        AXn = combine(ASo, Cx)
        # the implicit-difference directions: the W+P part of the new X
        Cp = Cx.at[:k, :].set(0.0)
        Pn = combine(So, Cp)
        APn = combine(ASo, Cp)
        Rn = AXn - colscale(Xn, th_new)
        rs = jnp.sqrt(jnp.maximum(jnp.diag(block_dot(Rn, Rn)).real, 0.0))
        return (it + 1, Xn, AXn, Pn, APn, th_new, rs)

    it, X, _AX, _P, _AP, theta, resid = jax.lax.while_loop(
        cond, body, (jnp.int32(0), X, AX, P, AP, theta, resid))
    return LOBPCGResult(
        eigenvalues=theta,
        X=X,
        iterations=it,
        resid_norms=resid,
        converged=jnp.all(resid <= tol * scale(theta)),
    )
