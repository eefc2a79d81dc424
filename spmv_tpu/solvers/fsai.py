"""FSAI — factorized sparse approximate inverse preconditioner for SPD
operators (Kolotilina & Yeremin '93).

``solvers/spai.py`` closed the nonsymmetric-preconditioner gap with an
UNFACTORIZED approximate inverse; M = SPAI(A) is in general not symmetric
even for symmetric A, so it cannot drive PCG/PMINRES/LOBPCG, which require
an SPD M^-1. The classical SPD answer is incomplete Cholesky — but IC(0)'s
apply is two SEQUENTIAL triangular solves, the most parallel-hostile
primitive there is (data-dependent recurrence, no tiling; the reference hides this
on CPU backends only). FSAI is the parallel-native factorized alternative:
compute a sparse LOWER-TRIANGULAR G approximating inv(chol(A)) so that

    M^-1 = G^T G   (SPD by construction whenever diag(G) > 0)

and the apply z = G^T (G r) is two SpMVs riding this library's ELL/DIA/
WELL applies and halo plans — zero new communication machinery, zero
sequential solves, deterministic.

Math (FSAI(0), static pattern = pattern(tril(A))): row i of G minimizes
the Kaporin functional, equivalently solves the tiny SPD system

    A[J_i, J_i] g_i = e_i|_{J_i},      J_i = {j in pattern(A_i*) : j <= i}

followed by the scaling g_i <- g_i / sqrt(g_i[i]) which makes
diag(G A G^T) = 1 exactly. The rows DECOUPLE — like SPAI the setup is one
batched dense solve over all rows, fully vectorized host numpy (the local
problems are row-degree-sized; far too small for a device to matter).

Quality guarantee carried by the theory: for SPD A the local systems are
SPD (principal submatrices), g_i[i] = (e_i^T A[J,J]^{-1} e_i) > 0, so G
exists with positive diagonal and M^-1 is SPD — FSAI cannot break down,
unlike IC(0) which can hit negative pivots. A relative ridge guards
near-singular blocks at fp precision.

The reference has no preconditioning at all (reference spmv/cg.cpp:21-98
is plain CG); this supplies the SPD-side general-sparsity preconditioner
with parallel primitives only, completing the pair {SPAI (general), FSAI (SPD)}.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from spmv_tpu.formats.csr import CSRHost
from spmv_tpu.solvers.spai import _ragged_to_padded


def fsai_setup(a: CSRHost, ridge: float = 1e-12) -> CSRHost:
    """Compute the FSAI(0) factor G (sparse lower triangular, positive
    diagonal, pattern = tril pattern of A incl. the diagonal) such that
    M^-1 = G^T G approximates A^-1 and diag(G A G^T) = 1.

    ``a`` must be square and is ASSUMED symmetric positive definite; only
    its lower triangle is read. ``ridge`` is the relative Tikhonov shift
    on each row's local system (guards structurally singular blocks).

    Pure vectorized numpy — no Python-level per-row loop; same batched
    machinery as ``spai_setup``.
    """
    if a.nrows != a.ncols:
        raise ValueError("FSAI needs a square (SPD) operator")
    n = a.nrows

    # --- J: per-row lower-triangle pattern incl. the diagonal, sorted ---
    rows_all = np.repeat(np.arange(n, dtype=np.int64), a.row_nnz())
    keep = rows_all >= a.colind
    # union with the identity pattern so a structurally-missing diagonal
    # still yields a well-posed local system (value gathered below is then
    # 0 and the ridge takes over)
    pr = np.concatenate([rows_all[keep], np.arange(n, dtype=np.int64)])
    pc = np.concatenate([a.colind[keep].astype(np.int64),
                         np.arange(n, dtype=np.int64)])
    pat = CSRHost.from_coo(pr, pc, np.ones(len(pr)), n, n)  # dedups + sorts
    kc_counts = np.diff(pat.rowptr).astype(np.int64)
    i_of = np.repeat(np.arange(n, dtype=np.int64), kc_counts)
    J_pad, _kc = _ragged_to_padded(i_of, pat.colind.astype(np.int64), n)
    kcmax = J_pad.shape[1]

    # --- gather S[i, r, c] = A[J[i,r], J[i,c]] (sorted-key searchsorted,
    # symmetrized read: fetch (max, min) so only tril(A) need be stored) ---
    a_rows = rows_all
    a_keys = a_rows * n + a.colind.astype(np.int64)
    if len(a_keys) > 1 and np.any(np.diff(a_keys) <= 0):
        srt = np.argsort(a_keys, kind="stable")
        a_keys, a_vals = a_keys[srt], a.values[srt]
    else:
        a_vals = a.values
    r_b = J_pad[:, :, None]                    # (n, kc, 1)
    c_b = J_pad[:, None, :]                    # (n, 1, kc)
    valid = (r_b >= 0) & (c_b >= 0)
    hi = np.maximum(r_b, c_b)
    lo = np.minimum(r_b, c_b)
    q = np.where(valid, hi * n + lo, 0).reshape(-1)
    pos = np.searchsorted(a_keys, q)
    pos = np.minimum(pos, max(len(a_keys) - 1, 0))
    hit = (a_keys[pos] == q) & valid.reshape(-1) if len(a_keys) else \
        np.zeros_like(valid.reshape(-1))
    S = np.where(hit, a_vals[pos] if len(a_vals) else 0.0, 0.0)
    S = S.reshape(n, kcmax, kcmax).astype(np.float64)
    # padded positions: unit diagonal keeps the batched solve non-singular
    pad_c = (J_pad < 0)
    eye = np.eye(kcmax, dtype=bool)[None]
    S[np.broadcast_to(pad_c[:, :, None] & eye, S.shape)] = 0.0
    S += (pad_c[:, :, None] * eye).astype(np.float64)

    # --- rhs: e at the position of i within J_i (its max element) ---
    e = (J_pad == np.arange(n, dtype=np.int64)[:, None]).astype(np.float64)

    # --- relative ridge + one batched solve ---
    diag = np.einsum("bcc->bc", S)
    lam = np.maximum(np.abs(diag).max(axis=1),
                     np.finfo(np.float64).tiny) * ridge
    S = S + lam[:, None, None] * np.eye(kcmax)[None]
    g = np.linalg.solve(S, e[..., None])[..., 0]              # (n, kcmax)

    # --- scale so diag(G A G^T) = 1: g_i /= sqrt(g_i[i]) ---
    d = np.einsum("bc,bc->b", g, e)            # g_i at the diagonal slot
    d = np.maximum(d, np.finfo(np.float64).tiny)
    g = g / np.sqrt(d)[:, None]

    cmask = (J_pad >= 0)
    out_rows = np.repeat(np.arange(n, dtype=np.int64), cmask.sum(axis=1))
    out_cols = J_pad[cmask]
    out_vals = g[cmask].astype(a.values.dtype)
    return CSRHost.from_coo(out_rows, out_cols.astype(np.int64),
                            out_vals, n, n, sum_duplicates=False)


def fsai_preconditioner(A, ridge: float = 1e-12) -> Callable:
    """SPD preconditioner apply ``z = G^T (G r)`` for a ``DistMatrix``:
    two distributed SpMVs on A's own mesh and format settings (G and a
    pre-built G^T operator, one relayout total). Valid wherever an SPD
    M^-1 is required: ``cg``/``cg_pipelined``, ``minres``, ``lobpcg``.
    Needs the assembly-time host matrix (operators from
    ``build_dist_matrix``, outside jit)."""
    from spmv_tpu.parallel.dist_matrix import build_dist_matrix

    host = getattr(A, "_host_csr", None)
    if host is None:
        raise ValueError(
            "fsai_preconditioner needs the assembly-time host matrix that "
            "build_dist_matrix attaches; build G yourself via fsai_setup "
            "for hand-assembled operators")
    # G is triangular, NOT symmetric — never inherit symmetric storage
    kw = dict(getattr(A, "_rebuild_kwargs", {}))
    g_host = fsai_setup(host, ridge=ridge)
    G = build_dist_matrix(g_host, **kw)
    Gt = G.transposed()

    def apply(r):
        return Gt.matvec(G.matvec(r))

    return apply
