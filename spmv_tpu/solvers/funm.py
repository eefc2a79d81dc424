"""Matrix-function actions f(A) v for symmetric (SPD) operators via
Lanczos — heat propagators, inverse square roots, and any other spectral
function, WITHOUT ever forming f(A).

Why this belongs in a sparse-solver stack: several production workloads
need the ACTION of a matrix function, not a linear solve —

- ``exp(t A) v``: exponential integrators / heat & diffusion propagation
  (one call replaces many implicit-Euler solves);
- ``A^{-1/2} v``: sampling from N(0, A^{-1}) Gaussian fields (Bayesian
  inverse problems, lattice QCD pseudofermions);
- ``A^{1/2} v``, ``log(A) v``: fractional diffusion, log-determinant
  estimators (Hutchinson tracing f = log).

Method (Saad '92): run m Lanczos steps (``lanczos_factorization``,
CGS2-reorthogonalized, distributed through the injected ``matvec``), then

    f(A) v  ~=  |v| * V_m U f(Theta) U^T e_1

with T_m = U Theta U^T the m x m tridiagonal eigendecomposition. The
whole pipeline is pure JAX and JITTABLE END TO END — symmetric ``eigh``
lowers on every backend, so unlike Arnoldi extraction nothing round-trips to host.
Convergence is superlinear for entire functions (exp) and
smooth-on-spectrum functions: m ~ sqrt(|t| * lambda_max) steps for the
exponential, m ~ sqrt(kappa) log(1/tol) for inverse roots.

Error estimate: the returned ``err_est = |v| * beta_m * |c_m|`` (the next
Lanczos weight times the last Krylov coefficient of f) is the standard
generalized-residual heuristic — exact for f(x) = x, asymptotically tight
for exp, and the practical stopping signal: raise m until it is small.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from spmv_tpu.solvers.lanczos import lanczos_factorization
from spmv_tpu.utils.precision import highest_precision


@highest_precision
def funm_multiply(
    matvec: Callable[[jax.Array], jax.Array],
    v0: jax.Array,
    f: Callable[[jax.Array], jax.Array],
    m: int = 48,
) -> tuple[jax.Array, jax.Array]:
    """Return ``(y, err_est)`` with ``y ~= f(A) v0`` for the symmetric
    operator behind ``matvec``; ``f`` is applied elementwise to the Ritz
    values (device arrays — use ``jnp``). ``v0``: any vector in the
    operator's padded layout, zero on padding rows. Jittable; distributed
    when ``matvec`` is. ``err_est`` is the generalized-residual heuristic
    (module docstring) in the SAME scale as |y|."""
    alphas, betas, basis, nrm0 = lanczos_factorization(matvec, v0, m)
    t = (jnp.diag(alphas)
         + jnp.diag(betas[:-1], 1)
         + jnp.diag(betas[:-1], -1))
    evals, evecs = jnp.linalg.eigh(t)
    ftheta = f(evals)
    c = evecs @ (ftheta * evecs[0, :])           # U f(Theta) U^T e_1, (m,)
    y = (nrm0.astype(v0.dtype)
         * (c.astype(v0.dtype) @ basis[:m])).reshape(v0.shape)
    err_est = nrm0 * betas[-1] * jnp.abs(c[-1])
    return y, err_est


def expm_multiply(
    matvec: Callable[[jax.Array], jax.Array],
    v0: jax.Array,
    t: float = 1.0,
    m: int = 48,
) -> tuple[jax.Array, jax.Array]:
    """``exp(t A) v0`` (scipy.sparse.linalg.expm_multiply semantics: pass
    ``t < 0`` for decay/diffusion with an SPD A). m ~ sqrt(|t| lambda_max)
    + a margin gives full accuracy; check ``err_est``."""
    ts = jnp.asarray(t)
    return funm_multiply(matvec, v0, lambda th: jnp.exp(ts * th), m=m)


def inv_sqrt_multiply(
    matvec: Callable[[jax.Array], jax.Array],
    v0: jax.Array,
    m: int = 48,
) -> tuple[jax.Array, jax.Array]:
    """``A^{-1/2} v0`` for SPD A — e.g. z ~ N(0, I) gives
    ``A^{-1/2} z ~ N(0, A^{-1})``, the whitening/sampling primitive.
    Ritz values are clipped at tiny to keep a not-yet-converged bottom
    from producing inf."""
    def f(th):
        tiny = jnp.asarray(jnp.finfo(th.dtype).tiny, th.dtype)
        return 1.0 / jnp.sqrt(jnp.maximum(th, tiny))
    return funm_multiply(matvec, v0, f, m=m)


def sqrt_multiply(
    matvec: Callable[[jax.Array], jax.Array],
    v0: jax.Array,
    m: int = 48,
) -> tuple[jax.Array, jax.Array]:
    """``A^{1/2} v0`` for symmetric positive SEMI-definite A (fractional
    diffusion, covariance coloring: ``A^{1/2} z ~ N(0, A)``)."""
    def f(th):
        return jnp.sqrt(jnp.maximum(th, 0.0))
    return funm_multiply(matvec, v0, f, m=m)


@highest_precision
def slq_trace(
    matvec: Callable[[jax.Array], jax.Array],
    f: Callable[[jax.Array], jax.Array],
    template: jax.Array,
    key: jax.Array,
    n_probes: int = 16,
    m: int = 32,
) -> tuple[jax.Array, jax.Array]:
    """Stochastic Lanczos quadrature (Ubaru, Chen & Saad '17): estimate
    ``tr(f(A))`` for symmetric A as ``(mean, stderr)`` over ``n_probes``
    Rademacher probes, each quadratured by an m-step Lanczos run:

        z^T f(A) z  ~=  |z|^2 * sum_i U[0,i]^2 f(theta_i)

    (only the tridiagonal is needed — the basis never leaves the scan).
    ``template``: any vector in the operator's padded layout whose ZERO
    entries mark padding — probes are drawn as Rademacher +-1 on the
    nonzero support so the Krylov space never touches padding (pass e.g.
    ``A.to_dist(np.ones(n))`` for a ``DistMatrix``). Probes run
    sequentially under ``lax.map`` (memory stays one basis, not
    ``n_probes`` of them). Jittable end to end; ``stderr`` is the
    standard error of the mean — the Monte-Carlo accuracy handle
    (~ |A|_F-driven; independent of the quadrature error, which m
    controls)."""
    support = (template != 0)
    nf = template.size

    def one_probe(k):
        z = jnp.where(
            support,
            jax.random.rademacher(
                k, template.shape, dtype=template.dtype),
            jnp.zeros_like(template))
        alphas, betas, _basis, nrm0 = lanczos_factorization(matvec, z, m)
        t = (jnp.diag(alphas)
             + jnp.diag(betas[:-1], 1)
             + jnp.diag(betas[:-1], -1))
        evals, evecs = jnp.linalg.eigh(t)
        return nrm0 ** 2 * jnp.sum(evecs[0, :] ** 2 * f(evals))

    samples = jax.lax.map(one_probe, jax.random.split(key, n_probes))
    mean = jnp.mean(samples)
    stderr = jnp.std(samples) / jnp.sqrt(jnp.asarray(float(n_probes)))
    return mean, stderr


def slq_logdet(
    matvec: Callable[[jax.Array], jax.Array],
    template: jax.Array,
    key: jax.Array,
    n_probes: int = 16,
    m: int = 32,
) -> tuple[jax.Array, jax.Array]:
    """``log det A = tr(log A)`` for SPD A via ``slq_trace`` — the
    Gaussian log-likelihood / model-evidence primitive that direct
    factorizations cannot reach at sparse-matrix scale. Ritz values are
    clipped at tiny before the log (an unconverged bottom otherwise
    yields -inf); raise ``m`` until the estimate stabilizes, and read
    ``stderr`` for the Monte-Carlo bar."""
    def f(th):
        tiny = jnp.asarray(jnp.finfo(th.dtype).tiny, th.dtype)
        return jnp.log(jnp.maximum(th, tiny))
    return slq_trace(matvec, f, template, key, n_probes=n_probes, m=m)
