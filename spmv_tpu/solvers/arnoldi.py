"""Arnoldi Ritz-value estimation for GENERAL (nonsymmetric) operators.

Companion to ``solvers/lanczos.py`` (SPD-only): the nonsymmetric solver
stack (bicgstab/gmres/lsqr, SPAI preconditioning) has no spectrum
diagnostics — yet spectral radius and the rightmost eigenvalue drive
stationary-iteration safety, pseudo-timestep choices, and "is my
preconditioned spectrum clustered?" checks. An m-step Arnoldi process
gives the leading Ritz values for m matvecs.

Architecture split:
- The FACTORIZATION (all the matvecs and the CGS2 orthogonalization — the
  only part that touches the operator) is pure JAX under ``lax.scan``:
  batched-matmul reorthogonalization like solvers/gmres.py, runs on any
  mesh, jittable (``arnoldi_factorization``).
- The EXTRACTION (eigendecomposition of the m x m Hessenberg) is HOST
  numpy: XLA has no nonsymmetric eig lowering on every backend, and an
  m<=128 dense eig is microseconds of host work — shipping it through the compiler buys
  nothing. ``arnoldi_ritz`` wraps both.

Ritz residual bounds are the standard |h_{m+1,m}| * |last eigvec
component| — the same certificate ``lanczos_extreme_with_bounds`` reports
for the symmetric case.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from spmv_tpu.utils.precision import highest_precision


@highest_precision
def arnoldi_factorization(
    matvec: Callable[[jax.Array], jax.Array],
    v0: jax.Array,
    m: int = 48,
):
    """m-step Arnoldi: A V_m = V_{m+1} H. Returns the (m+1, m) Hessenberg
    H as a device array (jittable; the matvecs run distributed when
    ``matvec`` is). ``v0`` must be nonzero and zero on any padding rows.
    On lucky breakdown at step j the remaining columns of H are zero and
    the leading j x j block is exact (invariant subspace found)."""
    rdtype = jnp.finfo(v0.dtype).dtype
    cdtype = v0.dtype
    tiny = jnp.asarray(jnp.finfo(v0.dtype).tiny, rdtype)
    releps = jnp.asarray(jnp.finfo(v0.dtype).eps, rdtype) * 8
    vshape = v0.shape
    n_flat = v0.size

    nrm0 = jnp.sqrt(jnp.vdot(v0, v0).real.astype(rdtype))
    q0 = (v0 / jnp.maximum(nrm0, tiny).astype(cdtype)).reshape(n_flat)
    basis0 = jnp.zeros((m + 1, n_flat), cdtype).at[0].set(q0)
    h0 = jnp.zeros((m + 1, m), cdtype)

    def step(carry, j):
        basis, h, live = carry
        vj = jax.lax.dynamic_index_in_dim(basis, j, axis=0, keepdims=False)
        w = matvec(vj.reshape(vshape)).reshape(n_flat)
        mask = (jnp.arange(m + 1) <= j).astype(rdtype)
        coeffs = jnp.zeros((m + 1,), cdtype)
        for _ in range(2):  # CGS2 — batched dots against the whole basis
            proj = (basis.conj() @ w) * mask.astype(w.dtype)
            w = w - proj @ basis
            coeffs = coeffs + proj
        wnorm = jnp.sqrt((w.conj() @ w).real.astype(rdtype))
        wscale = jnp.sqrt(
            jnp.sum(jnp.abs(coeffs) ** 2).astype(rdtype) + wnorm ** 2)
        brk = wnorm <= jnp.maximum(releps * wscale, tiny * 4)
        # on breakdown write an EXACT zero subdiagonal so host extraction
        # truncates to the invariant block
        hcol = coeffs.at[j + 1].set(
            jnp.where(brk, jnp.zeros((), cdtype), wnorm.astype(cdtype)))
        # after breakdown the process is DEAD: emit zero columns so the
        # Hessenberg stays exactly block-triangular
        hcol = jnp.where(live, hcol, jnp.zeros_like(hcol))
        basis = basis.at[j + 1].set(
            jnp.where(live & ~brk,
                      w / jnp.maximum(wnorm, tiny).astype(cdtype),
                      jnp.zeros_like(w)))
        h = h.at[:, j].set(hcol)
        return (basis, h, live & ~brk), None

    (basis, h, _live), _ = jax.lax.scan(
        step, (basis0, h0, jnp.asarray(True)), jnp.arange(m))
    return h


@dataclasses.dataclass
class ArnoldiRitz:
    values: np.ndarray        # (m,) complex Ritz values
    residuals: np.ndarray     # (m,) |h_{m+1,m} * y_m[i]| error certificates
    spectral_radius: float    # max |theta| (lower bound on rho(A))
    rightmost: complex        # Ritz value of largest real part
    steps: int                # Arnoldi steps actually informative


def arnoldi_ritz(
    matvec: Callable[[jax.Array], jax.Array],
    v0: jax.Array,
    m: int = 48,
) -> ArnoldiRitz:
    """Leading Ritz values of the operator behind ``matvec`` from an m-step
    Arnoldi run started at ``v0``. The factorization runs on device (wrap
    ``matvec`` in a distributed operator for mesh runs); the m x m
    Hessenberg eigendecomposition runs on host (module docstring). EXTREME
    eigenvalues (spectral radius, rightmost) converge first; interior Ritz
    values are approximations only. Host-side — call OUTSIDE jit."""
    h = np.asarray(jax.jit(
        lambda v: arnoldi_factorization(matvec, v, m))(v0))
    # informative prefix: columns up to the first zero subdiagonal
    sub = np.abs(np.diagonal(h, offset=-1))
    nz = np.nonzero(sub == 0.0)[0]
    k = int(nz[0]) + 1 if len(nz) else m
    k = min(k, m)
    hk = h[:k, :k]
    theta, y = np.linalg.eig(hk)
    # residual certificate scale: |h_{k+1,k}| — zero on lucky breakdown,
    # meaning the k x k block is an EXACT invariant-subspace restriction
    beta = sub[k - 1]
    resid = beta * np.abs(y[-1, :])
    order = np.argsort(-np.abs(theta))
    theta, resid = theta[order], resid[order]
    return ArnoldiRitz(
        values=theta,
        residuals=resid,
        spectral_radius=float(np.max(np.abs(theta))) if len(theta) else 0.0,
        rightmost=complex(theta[np.argmax(theta.real)]) if len(theta) else 0j,
        steps=k,
    )
