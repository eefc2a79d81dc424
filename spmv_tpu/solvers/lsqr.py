"""LSQR — least-squares / consistent-system solver for RECTANGULAR operators.

The reference assembles rectangular matrices (restriction/prolongation,
reference demos/restrictmain.cpp:60-91) and declares ``transpmult``
(reference spmv/Matrix.cpp:144-148 — throws), but ships no solver that can
touch a non-square system: its CG requires SPD. LSQR (Paige & Saunders '82)
closes that: it solves

    min_x |A x - b|_2          (or  min |A x - b|^2 + damp^2 |x|^2)

for any A via Golub-Kahan bidiagonalization — analytically equivalent to CG
on the normal equations A^T A x = A^T b but numerically far better, because
A^T A is never formed and its squared condition number never enters the
recurrences directly.

Architecture — same rules as ``cg``:
- ONE pure-JAX ``lax.while_loop``; every scalar device-resident; the
  convergence branch compiles into the loop (zero host round-trips).
- Distribution is injected through ``matvec`` (column-space -> row-space)
  and ``rmatvec`` (row-space -> column-space). For a ``DistMatrix`` use the
  CACHED pre-built transpose: ``At = A.transposed(); rmatvec = At.matvec``
  — one relayout total instead of a per-iteration re-interleave
  (``matvec_transpose`` also works for one-offs).
- Cost per iteration: 1 matvec + 1 rmatvec + 3 global reductions
  (|u|, |v|, |x| — the last feeds the Paige-Saunders stopping rule S1).
- Vectors keep the padded lane layouts of b (row side) and x (col side);
  padding entries must be zero so the default dots are exact — both
  ``build_dist_matrix`` sides guarantee this.

Stopping (Paige-Saunders S1/S2, both on running estimates that cost no
extra applies):
  istop=1:  |r| <= btol |b| + atol |A|_F |x|      (consistent systems)
  istop=2:  |A^T r| <= atol |A|_F |r|             (least-squares solutions)
  istop=0:  kmax reached.
|A|_F is the running Frobenius estimate sqrt(sum alpha^2 + beta^2 + damp^2).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
from spmv_tpu.utils.precision import highest_precision


@dataclasses.dataclass
class LSQRResult:
    x: jax.Array
    iterations: jax.Array  # int32 — completed bidiagonalization steps
    rnorm: jax.Array       # |b - A x|  (damped: includes damp*|x| term)
    arnorm: jax.Array      # |A^T r| estimate
    rnorm0: jax.Array      # initial |b - A x0|
    anorm: jax.Array       # running |A|_F estimate
    converged: jax.Array   # bool — istop in {1, 2}
    istop: jax.Array       # int32 — 0 kmax, 1 residual test, 2 lsq test


jax.tree_util.register_dataclass(
    LSQRResult,
    data_fields=["x", "iterations", "rnorm", "arnorm", "rnorm0", "anorm",
                 "converged", "istop"],
    meta_fields=[],
)


@highest_precision
def lsqr(
    matvec: Callable[[jax.Array], jax.Array],
    rmatvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x0: jax.Array | None = None,
    damp: float = 0.0,
    kmax: int = 100,
    atol: float = 1e-10,
    btol: float = 1e-10,
    dot: Callable[[jax.Array, jax.Array], jax.Array] | None = None,
) -> LSQRResult:
    """Minimize |A x - b| (+ Tikhonov ``damp``) over x.

    ``matvec(x)`` must map column-space vectors to row-space (b-shaped);
    ``rmatvec(y)`` the reverse. ``x0`` warm-starts via the shifted system
    min |A dx - (b - A x0)| (x0 also seeds the damping term's reference
    point, i.e. ``damp`` regularizes |x - x0|, the standard LSQR warm-start
    semantics). Defaults follow the other solvers (kmax=100; tolerances at
    the reference demo's 1e-10, reference demos/cg.cpp:64-65)."""
    if dot is None:
        dot = lambda p, q: jnp.vdot(p, q)
    u0 = b if x0 is None else b - matvec(x0)
    rdtype = jnp.finfo(b.dtype).dtype
    tiny = jnp.asarray(jnp.finfo(b.dtype).tiny, dtype=rdtype)
    dampr = jnp.asarray(damp, dtype=rdtype)

    def norm(q):
        return jnp.sqrt(dot(q, q).real.astype(rdtype))

    beta0 = norm(u0)
    u_init = u0 / jnp.maximum(beta0, tiny).astype(b.dtype)
    v0 = rmatvec(u_init)
    alpha0 = norm(v0)
    v_init = v0 / jnp.maximum(alpha0, tiny).astype(b.dtype)
    if x0 is None:
        x_init = jnp.zeros_like(v_init)
    else:
        x_init = x0
    w_init = v_init

    # carry: k, x, u, v, w, alpha, rhobar, phibar, anorm2, res2, arnorm,
    #        rnorm, istop   (res2 = accumulated damping residual sum psi^2)
    init = (
        jnp.int32(0), x_init, u_init, v_init, w_init,
        alpha0, alpha0, beta0,
        alpha0 ** 2, jnp.zeros((), rdtype), alpha0 * beta0, beta0,
        jnp.int32(0),
    )

    def cond(c):
        k, *_rest, istop = c
        return (k < kmax) & (istop == 0)

    def body(c):
        (k, x, u, v, w, alpha, rhobar, phibar, anorm2, res2, _arn, _rn,
         istop) = c
        # bidiagonalization step: beta u+ = A v - alpha u;
        #                         alpha+ v+ = A^T u+ - beta v
        u = matvec(v) - alpha.astype(b.dtype) * u
        beta = norm(u)
        u = u / jnp.maximum(beta, tiny).astype(b.dtype)
        v_new = rmatvec(u) - beta.astype(b.dtype) * v
        alpha_new = norm(v_new)
        v_new = v_new / jnp.maximum(alpha_new, tiny).astype(b.dtype)

        anorm2 = anorm2 + alpha ** 2 + beta ** 2 + dampr ** 2

        # eliminate the damping term (rotation on the regularized column)
        rhobar1 = jnp.sqrt(rhobar ** 2 + dampr ** 2)
        c1 = rhobar / jnp.maximum(rhobar1, tiny)
        phibar1 = c1 * phibar
        psi = (dampr / jnp.maximum(rhobar1, tiny)) * phibar

        # Givens rotation zeroing beta on the lower bidiagonal
        rho = jnp.sqrt(rhobar1 ** 2 + beta ** 2)
        cs = rhobar1 / jnp.maximum(rho, tiny)
        sn = beta / jnp.maximum(rho, tiny)
        theta = sn * alpha_new
        rhobar_new = -cs * alpha_new
        phi = cs * phibar1
        phibar_new = sn * phibar1

        x = x + (phi / jnp.maximum(rho, tiny)).astype(b.dtype) * w
        w = v_new - (theta / jnp.maximum(rho, tiny)).astype(b.dtype) * w

        # running estimates (exact in exact arithmetic). phibar carries a
        # SIGN through the rotations (c1 = rhobar/rhobar1 flips it whenever
        # rhobar goes negative — the self-consistent bookkeeping); the norm
        # estimates are its magnitude:
        #   |r_damped| = sqrt(phibar^2 + sum_k psi_k^2)
        res2 = res2 + psi ** 2
        rnorm = jnp.sqrt(phibar_new ** 2 + res2)
        arnorm = jnp.abs(phibar_new * alpha_new * cs)
        anorm = jnp.sqrt(anorm2)
        xnorm = norm(x)

        s1 = rnorm <= (btol * beta0 + atol * anorm * xnorm)
        s2 = arnorm <= atol * anorm * jnp.maximum(rnorm, tiny)
        # alpha==0: A^T u+ in span(v) — the least-squares problem is solved
        dead = alpha_new <= tiny * 4
        istop = jnp.where(s1, jnp.int32(1),
                          jnp.where(s2 | dead, jnp.int32(2), jnp.int32(0)))
        return (k + 1, x, u, v_new, w, alpha_new, rhobar_new, phibar_new,
                anorm2, res2, arnorm, rnorm, istop)

    (k, x, _u, _v, _w, _alpha, _rhobar, _phibar, anorm2, _res2, arnorm,
     rnorm, istop) = jax.lax.while_loop(cond, body, init)
    return LSQRResult(
        x=x,
        iterations=k,
        rnorm=rnorm,
        arnorm=arnorm,
        rnorm0=beta0,
        anorm=jnp.sqrt(anorm2),
        converged=istop > 0,
        istop=istop,
    )
