"""BiCGStab — Krylov solver for NON-symmetric systems.

Beyond-reference capability: the reference ships only CG
(reference spmv/cg.cpp:21-98), which requires SPD operators, yet its
library builds general non-symmetric matrices (loaders place no symmetry
requirement). BiCGStab (van der Vorst 1992) closes that gap with the same
architecture as ``spmv_tpu.solvers.cg``: one pure-JAX ``lax.while_loop``
for every device/mesh, device-resident scalars, zero per-iteration host
syncs, distribution injected through ``matvec``/``dot`` (global dots over
sharded vectors lower to psum under jit — the MPI_Allreduce analogue).

Two matvecs per iteration; the (t.s, t.t) reduction pair is computed back
to back so XLA fuses it into one collective. Preconditioning is RIGHT
preconditioning (solve A M^-1 (M x) = b): the reported residual is the TRUE
residual of the original system, so ``rtol`` means the same thing with and
without a preconditioner.

Breakdown (rho or omega numerically zero — possible for any BiCG-family
method) exits the loop with ``breakdown=True`` and the best iterate so far;
callers can restart from ``x``.

Checkpoint/resume: restart from a saved solution via ``x0`` (a fresh
shadow residual is the standard BiCGStab restart; unlike CG there is no
exact-sequence state worth carrying).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
from spmv_tpu.utils.precision import highest_precision


@dataclasses.dataclass
class BiCGStabResult:
    x: jax.Array
    iterations: jax.Array  # int32 — completed iterations
    rnorm: jax.Array       # final |r|_2
    rnorm0: jax.Array      # initial |r|_2
    converged: jax.Array   # bool
    breakdown: jax.Array   # bool — rho/omega collapsed; restart from x


jax.tree_util.register_dataclass(
    BiCGStabResult,
    data_fields=["x", "iterations", "rnorm", "rnorm0", "converged",
                 "breakdown"],
    meta_fields=[],
)


@highest_precision
def bicgstab(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x0: jax.Array | None = None,
    kmax: int = 100,
    rtol: float = 1e-10,
    dot: Callable[[jax.Array, jax.Array], jax.Array] | None = None,
    preconditioner: Callable[[jax.Array], jax.Array] | None = None,
) -> BiCGStabResult:
    """Solve (possibly non-symmetric) A x = b to relative TRUE residual
    ``rtol`` within ``kmax`` iterations (each costs two matvecs). Defaults
    mirror ``cg``; all vectors share b's (padded) shape with zero padding
    entries so the default dots are exact."""
    if dot is None:
        dot = lambda u, v: jnp.vdot(u, v)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    precond = preconditioner if preconditioner is not None else (lambda r: r)

    r0 = b - matvec(x0)
    rhat = r0  # fixed shadow residual
    rdtype = jnp.finfo(b.dtype).dtype  # real dtype (norms); scalars stay
    rnorm2_0 = dot(r0, r0).real.astype(rdtype)  # b.dtype (complex-capable)
    rnorm0 = jnp.sqrt(rnorm2_0)
    eps = jnp.asarray(jnp.finfo(b.dtype).tiny, dtype=rdtype)
    tiny = jnp.asarray(jnp.finfo(b.dtype).tiny, dtype=rdtype)
    one = jnp.ones((), b.dtype)
    zeros = jnp.zeros_like(b)

    def cond(state):
        k, _x, _r, _p, _v, _rho, _alpha, _omega, rnorm2, brk = state
        ok = jnp.sqrt(rnorm2) / jnp.maximum(rnorm0, eps) >= rtol
        return (k < kmax) & ok & jnp.logical_not(brk)

    # near-breakdown detection is RELATIVE (advisor r2): rho = <rhat, r> is
    # compared against its natural scale |rhat||r| (likewise denom vs
    # |rhat||v| and ts vs |t||s|), so collapsing angles are caught at
    # ~machine-eps alignment BEFORE the quotients degrade the iterate — an
    # absolute tiny*4 test only fires on exact zeros (denormal scale).
    releps = jnp.asarray(jnp.finfo(b.dtype).eps, dtype=rdtype) * 4

    def body(state):
        k, x0_, r0_, p0_, v0_, rho0_, alpha0_, omega0_, rnorm2_0_, _brk = state
        rho_new = dot(rhat, r0_)
        rnorm_cur = jnp.sqrt(rnorm2_0_)
        brk = jnp.abs(rho_new) <= jnp.maximum(
            releps * rnorm0 * rnorm_cur, tiny * 4)
        beta = (rho_new / _safe(rho0_, tiny)) * (alpha0_ / _safe(omega0_, tiny))
        p = r0_ + beta * (p0_ - omega0_ * v0_)
        phat = precond(p)
        v = matvec(phat)
        denom = dot(rhat, v)
        vnorm2 = dot(v, v).real.astype(rdtype)  # fuses with denom's reduction
        brk = brk | (jnp.abs(denom) <= jnp.maximum(
            releps * rnorm0 * jnp.sqrt(vnorm2), tiny * 4))
        alpha = rho_new / _safe(denom, tiny)
        s = r0_ - alpha * v
        shat = precond(s)
        t = matvec(shat)
        ts = dot(t, s)
        tt = dot(t, t)      # adjacent to ts -> one fused reduction
        ss = dot(s, s).real.astype(rdtype)
        omega = ts / _safe(tt, tiny)
        brk = brk | (jnp.abs(ts) <= jnp.maximum(
            releps * jnp.sqrt(tt.real.astype(rdtype) * ss), tiny * 4))
        x = x0_ + alpha * phat + omega * shat
        r = s - omega * t
        rnorm2 = dot(r, r).real.astype(rnorm2_0.dtype)
        # on breakdown keep the PRE-update iterate (the garbage quotients
        # above must not reach the returned state — "restart from x" in the
        # docstring has to mean the last good x)
        def pick(new, old):
            return jnp.where(brk, old, new)
        return (k + jnp.where(brk, 0, 1).astype(jnp.int32),
                pick(x, x0_), pick(r, r0_), pick(p, p0_), pick(v, v0_),
                pick(rho_new, rho0_), pick(alpha, alpha0_),
                pick(omega, omega0_), pick(rnorm2, rnorm2_0_), brk)

    state = (jnp.int32(0), x0, r0, zeros, zeros, one, one, one,
             rnorm2_0, jnp.asarray(False))
    k, x, _r, _p, _v, _rho, _a, _w, rnorm2, brk = jax.lax.while_loop(
        cond, body, state
    )
    rnorm = jnp.sqrt(rnorm2)
    return BiCGStabResult(
        x=x,
        iterations=k,
        rnorm=rnorm,
        rnorm0=rnorm0,
        converged=rnorm / jnp.maximum(rnorm0, eps) < rtol,
        breakdown=brk,
    )


def _safe(d, tiny):
    """Keep divisions finite on the breakdown path (the flag, not the
    garbage quotient, decides what happens next). Complex-safe: the sign
    clamp uses the real part."""
    return jnp.where(
        jnp.abs(d) <= tiny,
        jnp.where(jnp.real(d) < 0, -tiny, tiny).astype(d.dtype),
        d,
    )
