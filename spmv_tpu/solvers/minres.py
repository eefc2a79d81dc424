"""MINRES for symmetric (possibly INDEFINITE) systems.

Beyond-reference capability: the reference's only solver is CG
(reference spmv/cg.cpp:21-98), which requires a positive-definite operator —
yet its own symmetric storage mode (reference spmv/Matrix.cpp:523-529)
happily assembles indefinite matrices (shifted Laplacians, saddle-point
blocks, Helmholtz-like operators), for which CG's rho = r.Ar recurrence
divides by quantities of either sign and diverges. MINRES (Paige &
Saunders 1975) minimizes |b - A x| over the same Krylov space using the
symmetric Lanczos recurrence + Givens rotations, so it converges for ANY
symmetric A — the natural companion to the symmetric storage path.

Shape, matching solvers/cg.py:
- one pure-JAX ``lax.while_loop`` serves every device and mesh; scalars
  stay device-resident (no per-iteration D2H — the reference CUDA CG still
  pays one, reference spmv/cuda/cg.cuda.cu:139-144);
- distribution injected: ``matvec`` carries the halo exchange internally,
  ``dot`` carries the cross-shard psum (MPI_Allreduce parity,
  reference spmv/cg.cpp:49,65,75);
- cost per iteration: 1 matvec + 2 global reductions (v.Av and the
  preconditioned beta) — one FEWER reduction than CG's 3;
- optional SPD ``preconditioner`` (M^-1 apply) gives standard PMINRES:
  the recurrence runs in the M^-1 inner product and the convergence test
  is on the preconditioned residual norm phibar (the quantity MINRES
  minimizes), consistent with SciPy's reference implementation.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
from spmv_tpu.utils.precision import highest_precision


@dataclasses.dataclass
class MINRESResult:
    x: jax.Array
    iterations: jax.Array  # int32 — completed iterations
    rnorm: jax.Array       # final |r| estimate (phibar; exact in exact arith.)
    rnorm0: jax.Array      # initial |r|
    converged: jax.Array   # bool


jax.tree_util.register_dataclass(
    MINRESResult,
    data_fields=["x", "iterations", "rnorm", "rnorm0", "converged"],
    meta_fields=[],
)


@highest_precision
def minres(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x0: jax.Array | None = None,
    kmax: int = 100,
    rtol: float = 1e-10,
    dot: Callable[[jax.Array, jax.Array], jax.Array] | None = None,
    preconditioner: Callable[[jax.Array], jax.Array] | None = None,
) -> MINRESResult:
    """Solve symmetric A x = b to |r|/|r0| < ``rtol`` within ``kmax`` steps.

    A must be symmetric (indefinite is fine); ``preconditioner`` (M^-1
    apply), if given, must be symmetric positive definite. Vectors share
    b's (padded) shape; padding entries of b must be zero so default dots
    are exact — same contract as solvers/cg.py.
    """
    if dot is None:
        dot = lambda u, v: jnp.vdot(u, v)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    precond = preconditioner if preconditioner is not None else (lambda r: r)

    rdtype = jnp.real(jnp.zeros((), dtype=b.dtype)).dtype
    eps = jnp.asarray(jnp.finfo(rdtype).eps, dtype=rdtype)
    tiny = jnp.asarray(jnp.finfo(rdtype).tiny, dtype=rdtype)

    r1 = b - matvec(x0)
    y = precond(r1)
    beta1_sq = dot(r1, y).real.astype(rdtype)
    # beta1_sq < 0 means the preconditioner is not SPD; clamp so the loop
    # degenerates gracefully (phibar=0 -> immediate exit) rather than NaN.
    beta1 = jnp.sqrt(jnp.maximum(beta1_sq, 0.0))
    rnorm0 = beta1

    zeros = jnp.zeros_like(b)

    # Lanczos + Givens carry (Paige & Saunders, the classic 11-scalar form):
    #   r1, r2: last two UNpreconditioned Lanczos residuals; y = M^-1 r2
    #   w, w2:  last two solution-update directions
    #   beta, oldb: current/previous Lanczos off-diagonals
    #   dbar, epsln: pending (un-rotated) entries of the tridiagonal's QR
    #   phibar: residual norm of the least-squares problem so far
    #   cs, sn: the last Givens rotation
    state = (
        jnp.int32(0), x0, r1, r1, y, zeros, zeros,
        beta1, jnp.zeros_like(beta1),                 # beta, oldb
        jnp.zeros_like(beta1), jnp.zeros_like(beta1),  # dbar, epsln
        beta1,                                         # phibar
        -jnp.ones_like(beta1), jnp.zeros_like(beta1),  # cs, sn
    )

    def cond(s):
        k, *_rest = s
        phibar = s[11]
        return (k < kmax) & (phibar / jnp.maximum(rnorm0, tiny) >= rtol)

    def body(s):
        (k, x, r1_, r2_, y_, w, w2, beta, oldb, dbar, epsln, phibar,
         cs, sn) = s
        v = y_ / jnp.maximum(beta, tiny).astype(b.dtype)
        av = matvec(v)
        # three-term Lanczos: subtract the previous directions. The
        # (beta/oldb) r1 term is absent on the first step (oldb=0).
        coef = jnp.where(k > 0, beta / jnp.maximum(oldb, tiny), 0.0)
        av = av - coef.astype(b.dtype) * r1_
        alfa = dot(v, av).real.astype(rdtype)
        av = av - (alfa / jnp.maximum(beta, tiny)).astype(b.dtype) * r2_
        r1n, r2n = r2_, av
        yn = precond(r2n)
        oldb_n = beta
        beta_n = jnp.sqrt(jnp.maximum(dot(r2n, yn).real.astype(rdtype), 0.0))

        # apply the previous rotation, then form + apply the new one
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln_n = sn * beta_n
        dbar_n = -cs * beta_n
        gamma = jnp.maximum(jnp.sqrt(gbar * gbar + beta_n * beta_n), eps)
        cs_n = gbar / gamma
        sn_n = beta_n / gamma
        phi = cs_n * phibar
        phibar_n = sn_n * phibar

        w1 = w2
        w2n = w
        wn = (v - oldeps.astype(b.dtype) * w1
              - delta.astype(b.dtype) * w2n) / gamma.astype(b.dtype)
        xn = x + phi.astype(b.dtype) * wn
        return (k + 1, xn, r1n, r2n, yn, wn, w2n,
                beta_n, oldb_n, dbar_n, epsln_n, phibar_n, cs_n, sn_n)

    out = jax.lax.while_loop(cond, body, state)
    k, x = out[0], out[1]
    phibar = out[11]
    return MINRESResult(
        x=x,
        iterations=k,
        rnorm=phibar,
        rnorm0=rnorm0,
        converged=phibar / jnp.maximum(rnorm0, tiny) < rtol,
    )
