"""GMRES(m) — restarted GMRES for general (non-symmetric) systems.

Completes the Krylov suite (cg for SPD, bicgstab for non-symmetric
short-recurrence, gmres for robustness without breakdown) — the reference
ships CG only (reference spmv/cg.cpp). Same architecture: pure JAX, one
``lax.while_loop`` over restart cycles with a ``lax.while_loop`` Arnoldi
inside, device-resident scalars, distribution injected through ``matvec``
(sharded global reductions lower to psum under jit).

Design choices:
- Orthogonalization is CLASSICAL Gram-Schmidt done twice (CGS2): the
  projections are batched dots against the whole basis — ONE (m+1, n) @ (n,)
  matmul pass per application instead of modified-GS's j sequential dots —
  matmul-friendly and numerically as strong as MGS when applied twice.
  Masking keeps not-yet-filled basis rows inert.
- The Hessenberg is reduced INCREMENTALLY with Givens rotations (complex-
  capable), so each Arnoldi step has a free running residual estimate
  |g[j+1]| and the inner loop EXITS EARLY — on lucky breakdown and on
  mid-cycle convergence alike. The matvec count therefore tracks the
  iteration count (no masked dead applies finishing the cycle), which
  matters at large restart values. The final least-squares solve is one
  triangular back-substitution on the accumulated R.
- Right preconditioning: the convergence test uses the TRUE residual of the
  original system, so ``rtol`` means the same thing as in ``cg``.
- ``flexible=True`` turns the cycle into FGMRES (Saad '93): the
  preconditioned vectors z_j = M_j^-1 v_j are stored as a SECOND basis and
  the update is built from them directly, so the preconditioner may CHANGE
  between applications — inner Krylov sweeps (``cg``/``chebyshev_adaptive``
  with data-dependent iteration counts), AMG cycles with varying depth, or
  any nonlinear M^-1. Plain right-preconditioned GMRES silently assumes a
  FIXED linear M^-1 and stalls or diverges under a variable one; FGMRES is
  the correct contract at the cost of one extra (m, n) basis in memory.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
from spmv_tpu.utils.precision import highest_precision


@dataclasses.dataclass
class GMRESResult:
    x: jax.Array
    iterations: jax.Array  # int32 — total inner (Arnoldi) steps ~ matvecs
    cycles: jax.Array      # int32 — restart cycles run
    rnorm: jax.Array       # final TRUE |r|_2
    rnorm0: jax.Array
    converged: jax.Array


jax.tree_util.register_dataclass(
    GMRESResult,
    data_fields=["x", "iterations", "cycles", "rnorm", "rnorm0", "converged"],
    meta_fields=[],
)


@highest_precision
def gmres(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    x0: jax.Array | None = None,
    restart: int = 30,
    max_cycles: int = 20,
    rtol: float = 1e-10,
    dot: Callable[[jax.Array, jax.Array], jax.Array] | None = None,
    preconditioner: Callable[[jax.Array], jax.Array] | None = None,
    flexible: bool = False,
) -> GMRESResult:
    """Solve A x = b with restarted GMRES(m), m = ``restart``. Vectors keep
    b's (padded) shape; padding entries of b must be zero. The matvec budget
    is restart * max_cycles (+1 residual per cycle) WORST case — each cycle
    stops as soon as its running residual estimate clears ``rtol`` or the
    Krylov space becomes invariant (lucky breakdown), so a cycle that
    converges at step j costs j matvecs, not m.

    ``flexible=True`` (FGMRES) stores the preconditioned directions
    z_j = M^-1 v_j and forms the update from them, admitting a
    preconditioner that varies between applications (module docstring).
    With a fixed linear preconditioner it computes the same iterates as
    the default right-preconditioned cycle.

    Checkpoint/resume: passing a saved solution as ``x0`` IS the exact warm
    resume — every restart cycle rebuilds the Krylov space from the current
    residual anyway, so a resumed run continues precisely like an
    uninterrupted one at the same cycle boundary (unlike CG, which needs
    its carried r/p state — solvers/cg.py ``resume``)."""
    if dot is None:
        dot = lambda u, v: jnp.vdot(u, v)
    if x0 is None:
        x0 = jnp.zeros_like(b)
    precond = preconditioner if preconditioner is not None else (lambda r: r)
    m = restart
    vshape = b.shape
    n_flat = b.size
    # norms/tolerances in the vector dtype's REAL precision (f32 Hessenberg
    # math would cap each cycle at ~1e-7 even for f64 data); projection
    # coefficients, Givens sines, and the Hessenberg keep the vector dtype
    # itself so COMPLEX systems orthogonalize/rotate correctly
    rdtype = jnp.finfo(b.dtype).dtype
    cdtype = b.dtype
    tiny = jnp.asarray(jnp.finfo(b.dtype).tiny, dtype=rdtype)
    releps = jnp.asarray(jnp.finfo(b.dtype).eps, dtype=rdtype) * 8

    r_init = b - matvec(x0)
    rnorm0 = jnp.sqrt(dot(r_init, r_init).real.astype(rdtype))

    def cycle_body(state):
        x, r, k_total, cycles, _rnorm = state
        beta = jnp.sqrt(dot(r, r).real.astype(rdtype))
        safe_beta = jnp.maximum(beta, tiny)
        v0 = (r / safe_beta.astype(cdtype)).reshape(n_flat)

        basis0 = jnp.zeros((m + 1, n_flat), cdtype).at[0].set(v0)
        # FGMRES: second basis of preconditioned directions z_j = M^-1 v_j
        # (1 dummy row when not flexible so the carry structure is uniform)
        zbasis0 = jnp.zeros((m if flexible else 1, n_flat), cdtype)
        h0 = jnp.zeros((m + 1, m), cdtype)   # Givens-rotated (accumulates R)
        cs0 = jnp.zeros((m,), rdtype)
        sn0 = jnp.zeros((m,), cdtype)
        g0 = jnp.zeros((m + 1,), cdtype).at[0].set(beta.astype(cdtype))

        def arn_cond(carry):
            j, _basis, _zbasis, _h, _cs, _sn, _g, live = carry
            return (j < m) & live

        def arn_body(carry):
            j, basis, zbasis, h, cs, sn, g, live = carry
            vj = jax.lax.dynamic_index_in_dim(
                basis, j, axis=0, keepdims=False
            )
            zj = precond(vj.reshape(vshape)).reshape(n_flat)
            if flexible:
                zbasis = zbasis.at[j].set(zj)
            w = matvec(zj.reshape(vshape)).reshape(n_flat)
            # CGS2: two passes of project-against-all (masked to rows <= j)
            mask = (jnp.arange(m + 1) <= j).astype(rdtype)
            coeffs = jnp.zeros((m + 1,), cdtype)
            for _ in range(2):
                proj = (basis.conj() @ w) * mask
                w = w - (proj.astype(cdtype) @ basis)
                coeffs = coeffs + proj
            wnorm = jnp.sqrt((w.conj() @ w).real.astype(rdtype))
            # lucky breakdown: w vanished RELATIVE to the unprojected
            # |A v_j| ~ ||(coeffs, wnorm)|| — the Krylov space is invariant;
            # this column is still valid (h[j+1,j] = 0), so keep it and stop
            wscale = jnp.sqrt(
                jnp.sum(jnp.abs(coeffs) ** 2).astype(rdtype) + wnorm**2
            )
            brk = wnorm <= jnp.maximum(releps * wscale, tiny * 4)
            wn_safe = jnp.maximum(wnorm, tiny)
            basis = basis.at[j + 1].set(
                jnp.where(brk, jnp.zeros_like(w),
                          w / wn_safe.astype(cdtype))
            )
            hcol = coeffs.at[j + 1].set(wnorm.astype(cdtype))

            # apply the j existing rotations to the new column (masked full
            # sweep — O(m) scalar ops per step, nothing next to a matvec)
            def rot(i, hc):
                a, bb = hc[i], hc[i + 1]
                t = cs[i] * a + sn[i] * bb
                u = -jnp.conj(sn[i]) * a + cs[i] * bb
                hc2 = hc.at[i].set(t).at[i + 1].set(u)
                return jnp.where(i < j, hc2, hc)

            hcol = jax.lax.fori_loop(0, m, rot, hcol)

            # new rotation zeroing hcol[j+1]:  G = [[c, s], [-conj(s), c]],
            # c real;  [a, bb] -> [t * phase(a), 0]
            a = hcol[j]
            bb = hcol[j + 1]
            aabs = jnp.abs(a).astype(rdtype)
            t = jnp.sqrt(aabs**2 + jnp.abs(bb).astype(rdtype) ** 2)
            degenerate = t <= tiny * 4   # dead step: identity rotation
            phase = jnp.where(aabs <= tiny, jnp.ones((), cdtype),
                              a / jnp.maximum(aabs, tiny).astype(cdtype))
            c_new = jnp.where(degenerate, jnp.ones((), rdtype),
                              aabs / jnp.maximum(t, tiny))
            s_new = jnp.where(
                degenerate, jnp.zeros((), cdtype),
                phase * jnp.conj(bb) / jnp.maximum(t, tiny).astype(cdtype),
            )
            hcol = hcol.at[j].set(
                (t.astype(cdtype)) * phase
            ).at[j + 1].set(jnp.zeros((), cdtype))
            h = h.at[:, j].set(hcol)
            cs = cs.at[j].set(c_new)
            sn = sn.at[j].set(s_new)
            gj = g[j]
            g = g.at[j].set(c_new * gj).at[j + 1].set(-jnp.conj(s_new) * gj)

            # free running residual estimate — exit the cycle early once the
            # projected residual clears rtol (or the space went invariant)
            est = jnp.abs(g[j + 1]).astype(rdtype)
            conv = est < rtol * jnp.maximum(rnorm0, tiny)
            return (j + 1, basis, zbasis, h, cs, sn, g,
                    live & jnp.logical_not(brk) & jnp.logical_not(conv))

        steps, basis, zbasis, h, _cs, _sn, g, _live = jax.lax.while_loop(
            arn_cond, arn_body,
            (jnp.int32(0), basis0, zbasis0, h0, cs0, sn0, g0,
             jnp.asarray(True)),
        )

        # back-substitution on the accumulated upper-triangular R = h[:m,:m].
        # Unused columns (early exit) are zero; regularize with identity so
        # the solve stays well-posed, then zero their y entries (g beyond
        # the written range is zero except g[steps] — the residual — whose
        # row hits only the identity diagonal, masked right after).
        col_dead = jnp.arange(m) >= steps
        r_solve = h[:m, :m] + (jnp.eye(m, dtype=rdtype)
                               * col_dead.astype(rdtype)).astype(cdtype)
        y = jax.scipy.linalg.solve_triangular(r_solve, g[:m], lower=False)
        y = jnp.where(col_dead, jnp.zeros((), cdtype), y)
        if flexible:
            # the stored z_j already carry their (possibly distinct) M^-1
            x = x + (y.astype(cdtype) @ zbasis).reshape(vshape)
        else:
            dx = (y.astype(cdtype) @ basis[:m]).reshape(vshape)
            x = x + precond(dx)
        # the TRUE residual doubles as the next cycle's starting residual —
        # carrying it saves one matvec per cycle
        r_new = b - matvec(x)
        rnorm = jnp.sqrt(dot(r_new, r_new).real.astype(rdtype))
        return (x, r_new, k_total + steps, cycles + jnp.int32(1), rnorm)

    def cycle_cond(state):
        _x, _r, _k, cycles, rnorm = state
        return (cycles < max_cycles) & (
            rnorm / jnp.maximum(rnorm0, tiny) >= rtol
        )

    x, _r, k_total, cycles, rnorm = jax.lax.while_loop(
        cycle_cond, cycle_body,
        (x0, r_init, jnp.int32(0), jnp.int32(0), rnorm0),
    )
    return GMRESResult(
        x=x,
        iterations=k_total,
        cycles=cycles,
        rnorm=rnorm,
        rnorm0=rnorm0,
        converged=rnorm / jnp.maximum(rnorm0, tiny) < rtol,
    )
