"""svds — leading singular triplets of a (rectangular) sparse operator via
Golub-Kahan-Lanczos bidiagonalization.

Completes the spectral toolbox: ``lanczos_extreme`` (SPD eigenvalues),
``arnoldi_ritz`` (nonsymmetric eigenvalues) — and now singular values, the
quantity that actually governs the RECTANGULAR operators this library
assembles (restriction/prolongation, least-squares systems): ``lsqr``'s
convergence is set by sigma_max/sigma_min, operator norms are sigma_max,
and numerical-rank questions are singular-value questions. The reference
has no spectral machinery at all.

Architecture split, same as solvers/arnoldi.py:
- The FACTORIZATION (all matvec/rmatvec applies + CGS2 full
  reorthogonalization of BOTH bases — PROPACK-style, the part that touches
  the operator) is pure JAX under ``lax.scan``: batched-matmul
  reorthogonalization, jittable, runs distributed when the operator does
  (matvec from a ``DistMatrix``, rmatvec from its cached ``transposed()``).
- The EXTRACTION (SVD of the tiny (m+1, m) bidiagonal B) is HOST numpy —
  microseconds of work; shipping it through XLA buys nothing.

Math: m steps of Golub-Kahan starting from u_1 = b0/|b0| give

    A V_m = U_{m+1} B_m,      A^T U_{m+1} = V_m B_m^T + alpha_{m+1} v_{m+1} e_{m+1}^T

with B_m (m+1, m) lower bidiagonal. For a singular triplet
(s, p, q) of B_m, the Ritz triplet is (s, u = U_{m+1} p, v = V_m q) and

    A v - s u = 0                       (exact in the Krylov frame)
    |A^T u - s v| = alpha_{m+1} |p_{m+1}|   (the residual certificate)

so each returned triplet carries a computable error bound at the cost of
ONE extra rmatvec — the exact analogue of the Arnoldi/Lanczos
|h_{m+1,m} y_m| certificates. EXTREME singular values converge first;
interior estimates are approximations only.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from spmv_tpu.utils.precision import highest_precision


@highest_precision
def gk_factorization(
    matvec: Callable[[jax.Array], jax.Array],
    rmatvec: Callable[[jax.Array], jax.Array],
    b0: jax.Array,
    m: int = 48,
):
    """m-step Golub-Kahan bidiagonalization with full CGS2
    reorthogonalization of both bases. Returns
    ``(alpha, beta, alpha_cert, U, V)``:
    alpha (m,) diagonal of B, beta (m,) subdiagonal of B,
    alpha_cert the trailing alpha_{m+1} residual scale,
    U (m+1, row_size) and V (m, col_size) the flat orthonormal bases.

    ``b0`` is a row-space vector (same side as ``lsqr``'s b), nonzero and
    zero on any padding rows. Jittable; the applies run distributed when
    ``matvec``/``rmatvec`` do. On breakdown at step j (invariant singular
    subspace found) the remaining alpha/beta entries are exact zeros."""
    rdtype = jnp.finfo(b0.dtype).dtype
    cdtype = b0.dtype
    tiny = jnp.asarray(jnp.finfo(b0.dtype).tiny, rdtype)
    # breakdown threshold relative to the running operator scale; 64*eps
    # absorbs the eps*sqrt(n) reorthogonalization noise floor (a singular
    # value below 64*eps*sigma_max is numerically indistinguishable from 0)
    releps = jnp.asarray(jnp.finfo(b0.dtype).eps, rdtype) * 64
    ushape = b0.shape
    nu = b0.size

    beta1 = jnp.sqrt(jnp.vdot(b0, b0).real.astype(rdtype))
    u0 = (b0 / jnp.maximum(beta1, tiny).astype(cdtype)).reshape(nu)

    # probe the column side for shape/size (traced shape only; XLA DCEs
    # the extra apply if it is redundant with step 0's)
    v_probe = rmatvec(u0.reshape(ushape))
    vshape = v_probe.shape
    nv = v_probe.size

    U0 = jnp.zeros((m + 1, nu), cdtype).at[0].set(u0)
    V0 = jnp.zeros((m, nv), cdtype)

    def orth(basis, w, mask):
        # CGS2 against the masked prefix of a basis
        for _ in range(2):
            proj = (basis.conj() @ w) * mask.astype(w.dtype)
            w = w - proj @ basis
        return w

    def step(carry, j):
        # amax = running max(alpha, beta): the OPERATOR scale. Breakdown
        # tests must be relative to it, not to local vector norms — on an
        # exactly rank-deficient operator the post-reorth residual is
        # rounding noise ~ eps*sigma_max*sqrt(n), invisible at local scale.
        U, V, live, amax = carry
        uj = jax.lax.dynamic_index_in_dim(U, j, axis=0, keepdims=False)
        # --- v-step: alpha_j v_j = orth(A^T u_j  vs  V[:j]) ---
        w = rmatvec(uj.reshape(ushape)).reshape(nv)
        w = orth(V, w, (jnp.arange(m) < j).astype(rdtype))
        alpha = jnp.sqrt((w.conj() @ w).real.astype(rdtype))
        brk_a = alpha <= jnp.maximum(releps * amax, tiny * 4)
        live_v = live & ~brk_a
        vj = jnp.where(live_v, w / jnp.maximum(alpha, tiny).astype(cdtype),
                       jnp.zeros_like(w))
        V = V.at[j].set(vj)
        amax = jnp.maximum(amax, jnp.where(live_v, alpha, amax))
        # --- u-step: beta_{j+1} u_{j+1} = orth(A v_j  vs  U[:j+1]) ---
        p = matvec(vj.reshape(vshape)).reshape(nu)
        p = orth(U, p, (jnp.arange(m + 1) <= j).astype(rdtype))
        beta = jnp.sqrt((p.conj() @ p).real.astype(rdtype))
        brk_b = beta <= jnp.maximum(releps * amax, tiny * 4)
        live_u = live_v & ~brk_b
        U = U.at[j + 1].set(
            jnp.where(live_u, p / jnp.maximum(beta, tiny).astype(cdtype),
                      jnp.zeros_like(p)))
        amax = jnp.maximum(amax, jnp.where(live_u, beta, amax))
        # dead process emits exact zeros so host extraction truncates
        a_out = jnp.where(live_v, alpha, jnp.zeros_like(alpha))
        b_out = jnp.where(live_u, beta, jnp.zeros_like(beta))
        return (U, V, live_u, amax), (a_out, b_out)

    (U, V, live, _amax), (alpha, beta) = jax.lax.scan(
        step, (U0, V0, jnp.asarray(True), jnp.zeros((), rdtype)),
        jnp.arange(m))

    # --- certificate: alpha_{m+1} = |orth(A^T u_{m+1}  vs  V)| ---
    um = U[m]
    w = rmatvec(um.reshape(ushape)).reshape(nv)
    w = orth(V, w, jnp.ones((m,), rdtype))
    alpha_cert = jnp.where(
        live, jnp.sqrt((w.conj() @ w).real.astype(rdtype)),
        jnp.zeros((), rdtype))
    return alpha, beta, alpha_cert, U, V


@dataclasses.dataclass
class SVDSResult:
    s: np.ndarray            # (k,) singular-value estimates, descending
    u: jax.Array | None      # (k, *row_shape) left Ritz vectors
    v: jax.Array | None      # (k, *col_shape) right Ritz vectors
    residuals: np.ndarray    # (k,) |A^T u_i - s_i v_i| certificates
    steps: int               # bidiagonalization steps actually informative


@highest_precision
def svds(
    matvec: Callable[[jax.Array], jax.Array],
    rmatvec: Callable[[jax.Array], jax.Array],
    b0: jax.Array,
    k: int = 6,
    m: int = 48,
    compute_vectors: bool = True,
) -> SVDSResult:
    """Estimate the ``k`` LARGEST singular triplets of the operator behind
    ``matvec``/``rmatvec`` from an m-step Golub-Kahan run started at the
    row-space vector ``b0``.

    For a ``DistMatrix`` pass ``A.as_linear_operator()`` and
    ``At = A.transposed(); At.as_linear_operator()`` — the applies then run
    on the mesh with A's own halo plans, and ``b0 = A.to_dist(b, side="row")``.

    Each triplet carries the residual certificate
    |A^T u_i - s_i v_i| = alpha_{m+1} |p_i[m]| (module docstring);
    |A v_i - s_i u_i| is zero in the Krylov frame by construction. Extreme
    singular values converge first — raise ``m`` until the certificates of
    the k you need are small. Smallest singular values converge much more
    slowly; for those run svds on a shifted normal-equations operator or
    use ``lsqr``'s regularized solves. Host-side — call OUTSIDE jit."""
    alpha, beta, alpha_cert, U, V = jax.jit(
        lambda b: gk_factorization(matvec, rmatvec, b, m))(b0)
    alpha = np.asarray(alpha, dtype=np.float64)
    beta = np.asarray(beta, dtype=np.float64)
    cert = float(alpha_cert)

    # informative prefix: stop at the first exact-zero alpha (no new right
    # vector) — B then has t informative columns; a zero beta[t-1] just
    # means the LEFT space closed (B effectively (t, t)) and cert = 0.
    nz = np.nonzero(alpha == 0.0)[0]
    t = int(nz[0]) if len(nz) else m
    if t == 0:
        raise ValueError("gk breakdown at step 0: b0 is zero or A^T b0 = 0")
    B = np.zeros((t + 1, t))
    B[np.arange(t), np.arange(t)] = alpha[:t]
    B[np.arange(1, t + 1), np.arange(t)] = beta[:t]
    P, s, Qt = np.linalg.svd(B, full_matrices=False)   # P (t+1, t), Qt (t, t)
    if t < m:
        cert = 0.0  # breakdown: the block is an exact invariant subspace
    kk = min(k, t)
    # Krylov-frame bound, floored at the rounding level eps*sigma_max —
    # in exact arithmetic |A^T u_i - s_i v_i| EQUALS cert*|p_i[m]|, but a
    # fully converged triplet's true residual bottoms out at working
    # precision, so a raw 1e-28 bound would overstate the accuracy.
    floor = float(jnp.finfo(U.dtype).eps) * (s[0] if len(s) else 0.0)
    resid = np.maximum(cert * np.abs(P[t, :kk]), floor)
    s_out = s[:kk]

    u_out = v_out = None
    if compute_vectors:
        Pk = jnp.asarray(P[:, :kk], dtype=U.dtype)     # (t+1, kk)
        Qk = jnp.asarray(Qt[:kk, :].T, dtype=V.dtype)  # (t, kk)
        vshape = jax.eval_shape(rmatvec, b0).shape     # column-side shape
        u_out = (Pk.T @ U[:t + 1]).reshape((kk,) + tuple(b0.shape))
        v_out = (Qk.T @ V[:t]).reshape((kk,) + tuple(vshape))
    return SVDSResult(s=s_out, u=u_out, v=v_out,
                      residuals=np.asarray(resid), steps=t)
