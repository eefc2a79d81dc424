"""Deflated (recycling) Conjugate Gradient.

For SEQUENCES of solves with the same SPD operator — time stepping, multiple
right-hand sides arriving over time, outer nonlinear iterations — plain CG
re-discovers the extreme eigenmodes from scratch every solve. Deflation
removes a known d-dimensional subspace W (typically approximate bottom
eigenvectors from ``lobpcg``/``lanczos_extreme``, or solutions of earlier
systems) from the iteration: CG then converges at the EFFECTIVE condition
number lambda_max / lambda_{d+1} instead of lambda_max / lambda_1 (Saad,
Yeung, Erhel & Guyomarc'h '00, def-CG).

Algorithm (projected search directions; A-conjugacy to W maintained
explicitly):

    E = W^T A W  (d x d, factorized once)
    x0 <- x0 + W E^-1 W^T r0          Galerkin correction: W^T r0' = 0
    p0 = z0 - W E^-1 (AW)^T z0
    per iteration (on top of PCG):  mu = E^-1 (AW)^T z ;  p = z + beta p - W mu

Shape of the trade: the per-iteration extra work is two tall-skinny
dense matmuls ((n, d) with d ~ 4-32) and a d x d triangular solve, with
zero extra SpMVs and zero extra reductions beyond the (d,)
results of the matmuls (A-symmetry gives W^T A z = (A W)^T z, so the
precomputed AW replaces a second operator apply). Setup costs d matvecs.

All state is device-resident inside one ``lax.while_loop``, same contract
as ``solvers/cg.py`` (whose update order mirrors reference spmv/cg.cpp:55-86);
deflation simply augments the p-update. The reference has neither
preconditioning nor recycling.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from spmv_tpu.solvers.cg import CGResult
from spmv_tpu.utils.precision import highest_precision


@highest_precision
def cg_deflated(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    W: jax.Array,
    x0: jax.Array | None = None,
    kmax: int = 100,
    rtol: float = 1e-10,
    dot: Callable[[jax.Array, jax.Array], jax.Array] | None = None,
    preconditioner: Callable[[jax.Array], jax.Array] | None = None,
) -> CGResult:
    """Solve SPD ``A x = b`` by CG deflated against the basis ``W``.

    ``W``: (d, *b.shape) — d stacked vectors in b's (padded) layout, zero
    on padding rows (the exact layout ``lobpcg``/``svds`` return their
    blocks in). Need not be orthonormal, only linearly independent; a
    relative ridge keeps a rank-deficient W from producing NaNs (the
    redundant directions then simply stop helping).

    Semantics match ``cg`` (true-residual convergence test, optional SPD
    ``preconditioner``, distributed via the injected ``matvec``/``dot``).
    The returned ``CGResult.r``/``p`` continue to be valid Krylov state,
    but resume must go through ``cg_deflated`` again with the same W.
    """
    if dot is None:
        dot = lambda u, v: jnp.vdot(u, v)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    precond = preconditioner if preconditioner is not None else (lambda r: r)
    d = W.shape[0]
    if d == 0:
        raise ValueError("empty deflation basis; call cg() instead")
    vshape = b.shape
    Wf = W.reshape(d, -1)

    # --- setup: AW (d matvecs), E = W^T A W, Cholesky once ---
    AW = jnp.stack([matvec(W[i]).reshape(-1) for i in range(d)])
    E = Wf @ AW.T                       # (d, d) symmetric (A SPD)
    E = 0.5 * (E + E.T)
    # relative ridge: rank-deficient W must degrade gracefully, not NaN
    jitter = jnp.finfo(b.dtype).eps * jnp.maximum(
        jnp.max(jnp.abs(jnp.diagonal(E))), jnp.finfo(b.dtype).tiny)
    L = jnp.linalg.cholesky(E + jitter * jnp.eye(d, dtype=E.dtype))

    def esolve(y):                      # E^-1 y via the cached factor
        return jax.scipy.linalg.cho_solve((L, True), y)

    def wapply(coef):                   # W @ coef in b's layout
        return (coef @ Wf).reshape(vshape)

    def project_p(z, p_prev, beta):
        # p = z + beta p - W E^-1 (AW)^T z   (A-conjugate to W)
        mu = esolve(AW @ z.reshape(-1))
        return z + beta * p_prev - wapply(mu)

    # --- Galerkin correction: make W^T r0 = 0 ---
    r_pre = b - matvec(x0)
    gamma = esolve(Wf @ r_pre.reshape(-1))
    x0 = x0 + wapply(gamma)
    r0 = r_pre - (gamma @ AW).reshape(vshape)
    z0 = precond(r0)
    p0 = project_p(z0, jnp.zeros_like(b), jnp.zeros((), b.dtype))
    rho0 = dot(r0, z0)
    rnorm2_0 = dot(r0, r0)
    # rtol is relative to the PRE-correction residual, so it means the
    # same thing as in an undeflated cg() from the same x0 (the Galerkin
    # step is part of the solver, not of the problem)
    rnorm0 = jnp.sqrt(dot(r_pre, r_pre))
    eps = jnp.asarray(jnp.finfo(b.dtype).tiny, dtype=b.dtype)

    def cond(state):
        k, _x, _r, _p, _rho, rnorm2 = state
        return (k < kmax) & (jnp.sqrt(rnorm2) / jnp.maximum(rnorm0, eps)
                             >= rtol)

    def body(state):
        k, x, r, p, rho, _rnorm2 = state
        ap = matvec(p)
        alpha = rho / dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        # re-apply the Galerkin correction every iteration: gamma = 0 in
        # exact arithmetic (W^T r stays 0 for ANY W), but in fp32 the
        # leaked W-component of r is amplified by the deflated (locally
        # flat) directions and DIVERGES on approximate bases — measured:
        # a 3e-3-perturbed eigenbasis took fp32 def-CG from 146 iters to
        # rel-residual 6.8. Cost: two (d, n) matmuls + one cached d x d
        # triangular solve; no extra matvec, no extra global reduction
        # beyond the matmuls' (d,) outputs.
        gamma = esolve(Wf @ r.reshape(-1))
        x = x + wapply(gamma)
        r = r - (gamma @ AW).reshape(vshape)
        z = precond(r)
        rho_new = dot(r, z)
        beta = rho_new / rho
        p = project_p(z, p, beta)
        rnorm2_new = dot(r, r) if preconditioner is not None else rho_new
        return (k + 1, x, r, p, rho_new, rnorm2_new)

    k, x, r, p, _rho, rnorm2 = jax.lax.while_loop(
        cond, body, (jnp.int32(0), x0, r0, p0, rho0, rnorm2_0))
    rnorm = jnp.sqrt(rnorm2)
    return CGResult(
        x=x, iterations=k, rnorm=rnorm, rnorm0=rnorm0,
        converged=rnorm / jnp.maximum(rnorm0, eps) < rtol, r=r, p=p)
