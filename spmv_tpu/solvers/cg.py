"""Unpreconditioned Conjugate Gradient.

One pure-JAX ``lax.while_loop`` implementation replaces the reference's four
per-backend copies (reference spmv/cg.cpp:21-98, spmv/openmp/cg.openmp.cpp,
spmv/sycl/cg.sycl.cpp, spmv/cuda/cg.cuda.cu — all structurally identical).
The update order matches the reference exactly (spmv/cg.cpp:55-86):

    Ap = A p;  alpha = rnorm2 / (p.Ap);  x += alpha p;  r -= alpha Ap;
    converged? |r|/|r0| < rtol;  beta = |r|_new^2/rnorm2;  p = r + beta p

so residual histories are comparable to the reference run for run.

Like the reference CUDA CG (cg.cuda.cu:62-141), every scalar stays device-
resident; unlike it, there is no per-iteration device-to-host copy at all —
the convergence branch lives inside the compiled while_loop.

Distribution is injected, not hard-coded: callers pass ``matvec`` (which does
the halo update + distributed mult internally — the caller-driven-comms idiom
of reference spmv/cg.cpp:59-60) and optionally ``dot`` (which must do the
cross-shard psum, replacing MPI_Allreduce at spmv/cg.cpp:49,65,75).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
from spmv_tpu.utils.precision import highest_precision


@dataclasses.dataclass
class CGResult:
    x: jax.Array
    iterations: jax.Array  # int32 — completed iterations
    rnorm: jax.Array       # final |r|_2
    rnorm0: jax.Array      # initial |r|_2
    converged: jax.Array   # bool
    r: jax.Array | None = None  # final residual vector (Krylov state for
    p: jax.Array | None = None  # warm resume — see ``resume`` below)


jax.tree_util.register_dataclass(
    CGResult,
    data_fields=["x", "iterations", "rnorm", "rnorm0", "converged", "r", "p"],
    meta_fields=[],
)


@highest_precision
def cg(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x0: jax.Array | None = None,
    kmax: int = 100,
    rtol: float = 1e-10,
    dot: Callable[[jax.Array, jax.Array], jax.Array] | None = None,
    preconditioner: Callable[[jax.Array], jax.Array] | None = None,
    resume: tuple | None = None,
) -> CGResult:
    """Solve A x = b to relative residual ``rtol`` within ``kmax`` iterations.

    Defaults mirror the reference demo (kmax=100, rtol=1e-10,
    reference demos/cg.cpp:64-65). All vectors share b's (padded) shape;
    padding entries of b must be zero so default dots are exact.

    ``preconditioner``: optional M^-1 apply (e.g. Jacobi: z = r / diag(A)).
    The reference has no preconditioning; with one, this is standard PCG
    (left-preconditioned, rho = r.z) and the convergence test stays on the
    TRUE residual |r|/|r0| so tolerances mean the same thing either way.

    ``resume``: optional ``(r, p, rnorm0)`` warm-start state — the Krylov
    state a previous ``CGResult`` carries (``res.r``, ``res.p``,
    ``res.rnorm0``). With it (and ``x0`` = the saved solution) the solve
    continues the ORIGINAL Krylov sequence exactly (bitwise, same mesh) as
    if never interrupted; without it a restart rebuilds the Krylov space
    from scratch (checkpoint/resume, spmv_tpu.io.checkpoint).
    """
    if dot is None:
        dot = lambda u, v: jnp.vdot(u, v)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    precond = preconditioner if preconditioner is not None else (lambda r: r)

    if resume is not None:
        r_in, p_in, rnorm0_in = resume
        r0 = r_in
        z0 = p_in       # continue with the saved search direction
        rho0 = dot(r0, precond(r0))
        rnorm2_0 = dot(r0, r0)
        rnorm0 = jnp.asarray(rnorm0_in, dtype=b.dtype)
        k, x, r, _p, _rho, rnorm2 = jax.lax.while_loop(
            lambda s: _cond(s, kmax, rtol, rnorm0),
            lambda s: _body(s, matvec, dot, precond, preconditioner),
            (jnp.int32(0), x0, r0, p_in, rho0, rnorm2_0),
        )
        rnorm = jnp.sqrt(rnorm2)
        eps = jnp.asarray(jnp.finfo(b.dtype).tiny, dtype=b.dtype)
        return CGResult(
            x=x, iterations=k, rnorm=rnorm, rnorm0=rnorm0,
            converged=rnorm / jnp.maximum(rnorm0, eps) < rtol,
            r=r, p=_p,
        )

    # r0 = b - A x0; the reference starts from r = b (x0 = 0, cg.cpp:43-46).
    r0 = b - matvec(x0)
    z0 = precond(r0)
    rho0 = dot(r0, z0)
    rnorm2_0 = dot(r0, r0)
    rnorm0 = jnp.sqrt(rnorm2_0)
    eps = jnp.asarray(jnp.finfo(b.dtype).tiny, dtype=b.dtype)

    k, x, r, _p, _rho, rnorm2 = jax.lax.while_loop(
        lambda s: _cond(s, kmax, rtol, rnorm0),
        lambda s: _body(s, matvec, dot, precond, preconditioner),
        (jnp.int32(0), x0, r0, z0, rho0, rnorm2_0),
    )
    rnorm = jnp.sqrt(rnorm2)
    return CGResult(
        x=x,
        iterations=k,
        rnorm=rnorm,
        rnorm0=rnorm0,
        converged=rnorm / jnp.maximum(rnorm0, eps) < rtol,
        r=r,
        p=_p,
    )


def _cond(state, kmax, rtol, rnorm0):
    k, _x, _r, _p, _rho, rnorm2 = state
    eps = jnp.asarray(jnp.finfo(rnorm0.dtype).tiny, dtype=rnorm0.dtype)
    return (k < kmax) & (jnp.sqrt(rnorm2) / jnp.maximum(rnorm0, eps) >= rtol)


def _body(state, matvec, dot, precond, preconditioner):
    k, x, r, p, rho, _rnorm2 = state
    ap = matvec(p)
    alpha = rho / dot(p, ap)
    x = x + alpha * p
    r = r - alpha * ap
    z = precond(r)
    rho_new = dot(r, z)
    beta = rho_new / rho
    p = z + beta * p
    # unpreconditioned: rho IS |r|^2 — keep the reference's 3 reductions
    # per iteration (cg.cpp:49,65,75); PCG pays one extra for the true
    # residual the convergence test is defined on
    rnorm2_new = dot(r, r) if preconditioner is not None else rho_new
    return (k + 1, x, r, p, rho_new, rnorm2_new)


@highest_precision
def cg_residual_history(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    iters: int,
    x0: jax.Array | None = None,
    dot: Callable[[jax.Array, jax.Array], jax.Array] | None = None,
) -> tuple[jax.Array, jax.Array]:
    """Run exactly ``iters`` CG iterations via ``lax.scan`` and return
    (x, |r| history) — for residual-parity checks against the reference
    algorithm (BASELINE.md numerical-parity row)."""
    if dot is None:
        dot = lambda u, v: jnp.vdot(u, v)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    r0 = b - matvec(x0)
    rnorm2_0 = dot(r0, r0)

    def step(state, _):
        x, r, p, rnorm2 = state
        ap = matvec(p)
        alpha = rnorm2 / dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rnorm2_new = dot(r, r)
        beta = rnorm2_new / rnorm2
        p = r + beta * p
        return (x, r, p, rnorm2_new), jnp.sqrt(rnorm2_new)

    (x, _r, _p, _), hist = jax.lax.scan(
        step, (x0, r0, r0, rnorm2_0), None, length=iters
    )
    return x, hist


@highest_precision
def cg_pipelined(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x0: jax.Array | None = None,
    kmax: int = 100,
    rtol: float = 1e-10,
    dot: Callable[[jax.Array, jax.Array], jax.Array] | None = None,
    preconditioner: Callable[[jax.Array], jax.Array] | None = None,
) -> CGResult:
    """Single-reduction CG (Chronopoulos-Gear recurrence).

    The classic CG needs 3 dependency-separated global reductions per
    iteration (reference spmv/cg.cpp:49,65,75 — three MPI_Allreduce calls);
    at pod scale each psum is a latency hit XLA cannot merge because they
    gate successive updates. This variant keeps s = A p recursively and
    computes BOTH scalars (gamma = r.u, delta = w.u) back to back, so XLA's
    all-reduce combiner fuses them into ONE collective per iteration — the
    standard communication-avoiding trade (identical math in exact
    arithmetic; marginally different rounding, covered by the parity test).
    """
    if dot is None:
        dot = lambda u, v: jnp.vdot(u, v)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    precond = preconditioner if preconditioner is not None else (lambda r: r)

    r0 = b - matvec(x0)
    u0 = precond(r0)
    w0 = matvec(u0)
    gamma0 = dot(r0, u0)
    delta0 = dot(w0, u0)
    rnorm2_0 = dot(r0, r0) if preconditioner is not None else gamma0
    rnorm0 = jnp.sqrt(rnorm2_0)
    eps = jnp.asarray(jnp.finfo(b.dtype).tiny, dtype=b.dtype)
    alpha0 = gamma0 / delta0
    zeros = jnp.zeros_like(b)

    def cond(state):
        k, *_rest, rnorm2 = state
        return (k < kmax) & (jnp.sqrt(rnorm2) / jnp.maximum(rnorm0, eps) >= rtol)

    def body(state):
        k, x, r, u, w, p, s, alpha, beta, gamma, _rn2 = state
        p = u + beta * p
        s = w + beta * s
        x = x + alpha * p
        r = r - alpha * s
        u2 = precond(r)
        w2 = matvec(u2)
        gamma_new = dot(r, u2)
        delta = dot(w2, u2)   # adjacent to gamma_new -> ONE fused reduction
        rnorm2_new = dot(r, r) if preconditioner is not None else gamma_new
        beta_new = gamma_new / gamma
        alpha_new = gamma_new / (delta - beta_new * gamma_new / alpha)
        return (k + 1, x, r, u2, w2, p, s, alpha_new, beta_new, gamma_new,
                rnorm2_new)

    state = (jnp.int32(0), x0, r0, u0, w0, zeros, zeros,
             alpha0, jnp.zeros_like(gamma0), gamma0, rnorm2_0)
    k, x, r, *_rest, rnorm2 = jax.lax.while_loop(cond, body, state)
    rnorm = jnp.sqrt(rnorm2)
    return CGResult(
        x=x,
        iterations=k,
        rnorm=rnorm,
        rnorm0=rnorm0,
        converged=rnorm / jnp.maximum(rnorm0, eps) < rtol,
        r=r,
        p=None,
    )
