#!/usr/bin/env python
"""Benchmark of the library's normal path on one GPU.

    python bench.py            # full size on the GPU, one JSON line
    python bench.py --smoke    # tiny functional dry run on the CPU

Times ``DistMatrix.matvec`` / ``matmat`` and the solvers as a user calls
them: each timing is the median over trials of one jitted chain of K
applies that consumes its carry, ending in ``block_until_ready``. Rates
are stored bytes per second, reported against the card's published HBM
peak (``PEAKS``, keyed by ``device_kind``) and a large copy measured in
the same process. An unknown device kind is an error. ``--smoke`` runs
the same code at tiny sizes on the CPU and reports no rate.

Bytes per apply count the arrays the format reads plus x and y
(``moved_bytes``). Cells: the 2-D Laplacian at 3200^2 = 10.24M rows in DIA storage (vanilla
and symmetric), a 4M-row banded-random operator (WELL and ELL), the DIA
block apply at nrhs=8, CG and AMG-PCG on the Laplacian, and the fem2d /
powerlaw / circuit corpus matrices after RCM.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

F32 = np.float32

# Published peaks by jax device_kind. Source: NVIDIA H100 Tensor Core GPU
# data sheet, H100 SXM: 80 GB HBM3 at 3.35 TB/s (rates at the full 700 W
# power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_gbs": 3350.0,
                              "source": "NVIDIA H100 data sheet (SXM)"},
}


def hbm_peak_gbs(kind: str) -> float:
    """Published HBM bandwidth (GB/s) of a device kind; unknown kinds are
    an error, not a default."""
    if kind not in PEAKS:
        raise KeyError(f"no published peak for device kind {kind!r}; add it "
                       "to bench.PEAKS with its source")
    return PEAKS[kind]["hbm_gbs"]


def card_facts() -> str:
    """`nvidia-smi` name and power limit, read by a child process that
    does not touch JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e!r}"


def seconds_per_apply(step, operand, x, k: int, trials: int = 3) -> float:
    """Median seconds per apply over ``trials`` runs of one jitted chain of
    ``k`` applies, each consuming the previous result (a loop whose body
    ignored its carry would be hoisted and time one apply)."""
    import jax

    loop = jax.jit(lambda a, v: jax.lax.fori_loop(
        0, k, lambda i, u: step(a, u), v))
    jax.block_until_ready(loop(operand, x))  # compile + warm-up
    times = []
    for _ in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready(loop(operand, x))
        times.append(time.perf_counter() - t0)
    return statistics.median(times) / k


def copy_rate_gbs(n_elems: int = 1 << 28, trials: int = 3) -> float:
    """Bytes/s of a large scaled copy (read + write), same timing method."""
    import jax.numpy as jnp

    x = jnp.ones((n_elems // 128, 128), jnp.float32)
    sec = seconds_per_apply(lambda _, u: u * F32(0.999), None, x, 20, trials)
    return 2 * n_elems * 4 / sec / 1e9


def row_abs_max(a) -> float:
    return float(np.bincount(np.repeat(np.arange(a.nrows), a.row_nnz()),
                             weights=np.abs(a.values.astype(np.float64)),
                             minlength=a.nrows).max())


def banded_random(n: int, seed: int = 0):
    """Banded random with holes: a general-sparsity operator whose rows
    spread over ~3k columns (FEM-like), exercising the WELL gather."""
    from spmv_tpu.formats.csr import CSRHost

    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for off in (-1500, -130, -1, 0, 1, 128, 1400):
        i = np.arange(max(0, -off), min(n, n - off))
        i = i[rng.random(len(i)) < 0.85]
        rows.append(i)
        cols.append(i + off)
        vals.append(rng.standard_normal(len(i)))
    return CSRHost.from_coo(np.concatenate(rows), np.concatenate(cols),
                            np.concatenate(vals).astype(F32), n, n)


def moved_bytes(A, nrhs: int = 1) -> int:
    """Bytes one apply must move: the arrays its local format reads, the
    ghost (remote) and hub terms when present, x read and y written."""
    fmt = A.local_format
    names = {"dia": ["local_dia_data"],
             "ell": ["local_colind", "local_values"],
             "well": ["local_well_values", "local_well_pos", "local_well_w0",
                      "far_rows", "far_cols", "far_vals"]}[fmt]
    if A.symmetric and fmt != "dia":  # DIA folds the diagonal in
        names += ["diagonal"] + (["local_wellT_values", "local_wellT_pos",
                                  "local_wellT_w0", "farT_rows", "farT_cols",
                                  "farT_vals"] if fmt == "well" else [])
    if A.plan.nghost_pad > 0 and A.plan.rounds:
        names += ["remote_colind", "remote_values"]
    if A.hub_nnz:
        names += ["hub_rownum", "hub_colind", "hub_values"]
    arrays = [getattr(A, n) for n in names]
    vec = (A.n_devices * (A.row_pad + A.col_pad) * nrhs
           * np.dtype(A.dtype).itemsize)
    return sum(x.nbytes for x in arrays if x is not None) + vec


def apply_cell(a, fmt: str, k: int, trials: int, symmetric: bool = False):
    """(DistMatrix, seconds per matvec, bytes moved per matvec)."""
    from spmv_tpu.parallel.dist_matrix import build_dist_matrix

    A = build_dist_matrix(a, n_devices=1, local_format=fmt, dtype=F32,
                          symmetric=symmetric)
    x = A.to_dist(np.full(a.nrows, 1e-3, F32))
    scale = F32(1.0 / row_abs_max(a))  # keeps the chained applies bounded
    sec = seconds_per_apply(lambda A_, u: A_.matvec(u) * scale, A, x, k,
                            trials)
    return A, sec, moved_bytes(A)


def solver_cells(a, A, smoke: bool, trials: int) -> dict:
    """CG iteration rate, plain CG to rtol, and AMG-PCG set-up + solve on
    the headline operator."""
    import jax

    from spmv_tpu.gen import gaussian_bump
    from spmv_tpu.solvers.amg import amg_setup
    from spmv_tpu.solvers.cg import cg

    b = A.to_dist(gaussian_bump(a.nrows, dtype=F32))
    out = {}

    def timed(fn, *args):
        jax.block_until_ready(fn(*args))  # compile + warm-up
        ts, res = [], None
        for _ in range(trials):
            t0 = time.perf_counter()
            res = jax.block_until_ready(fn(*args))
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts), res

    niter = 5 if smoke else 100
    sec, _ = timed(jax.jit(lambda A_, b_: cg(A_.as_linear_operator(), b_,
                                             kmax=niter, rtol=0.0)), A, b)
    out["cg_iters_per_s"] = niter / sec
    sec, r = timed(jax.jit(lambda A_, b_: cg(
        A_.as_linear_operator(), b_, kmax=60 if smoke else 20_000,
        rtol=1e-6)), A, b)
    out.update(cg_time_to_rtol_s=sec, cg_time_to_rtol_iters=int(r.iterations),
               cg_time_to_rtol_converged=bool(r.converged))
    t0 = time.perf_counter()
    h = amg_setup(a, A, aggregate="interval2d", interval_size=4, cycle=2,
                  local_format="dia")
    out["amg_pcg_setup_s"] = time.perf_counter() - t0
    sec, r = timed(jax.jit(lambda A_, b_, h_: cg(
        A_.as_linear_operator(), b_, kmax=60 if smoke else 200, rtol=1e-6,
        preconditioner=h_.as_preconditioner())), A, b, h)
    out.update(amg_pcg_solve_s=sec, amg_pcg_iters=int(r.iterations),
               amg_pcg_converged=bool(r.converged))
    return out


def corpus_cells(smoke: bool, k: int, trials: int) -> dict:
    """General sparsity through the user workflow (RCM -> auto format),
    against the ELL gather on the same matrix."""
    from spmv_tpu.corpus import circuit_network, fem_p1_2d, powerlaw_laplacian
    from spmv_tpu.reorder import rcm_reorder

    cases = [
        ("fem2d", fem_p1_2d, {"n_nodes": 3000 if smoke else 800_000}),
        ("powerlaw", powerlaw_laplacian, {"n": 3000 if smoke else 500_000}),
        ("circuit", circuit_network, {"nx": 50 if smoke else 800}),
    ]
    out = {}
    for tag, fn, kw in cases:
        a, _ = rcm_reorder(fn(**kw), keep_best=True)
        A, sec, nbytes = apply_cell(a, "auto", k, trials)
        _, sec_ell, _ = apply_cell(a, "ell", k, trials)
        fmt = A.local_format + ("+hub" if A.hub_nnz else "")
        out[tag] = {"n": a.nrows, "nnz": a.nnz, "format": fmt,
                    "ms_per_apply": sec * 1e3,
                    "ell_ms_per_apply": sec_ell * 1e3,
                    "bytes_per_apply": nbytes}
    return out


def _without_times(d):
    """The cell tree with every timing-derived entry removed."""
    if not isinstance(d, dict):
        return d
    return {k: _without_times(v) for k, v in d.items()
            if not re.search(r"ms_per|_s$|per_s|_over_", k)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny shapes on the CPU: a functional dry run")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--no-solvers", action="store_true")
    ap.add_argument("--no-corpus", action="store_true")
    args = ap.parse_args(argv)

    import jax

    if args.smoke:
        jax.config.update("jax_platforms", "cpu")
    dev = jax.devices()[0]
    if not args.smoke:
        from spmv_tpu.utils.runtime import setup_compile_cache

        setup_compile_cache(os.path.dirname(os.path.abspath(__file__)))
        peak = hbm_peak_gbs(dev.device_kind)
        card = card_facts()
        print(f"# {card}", file=sys.stderr)

    from spmv_tpu.gen import create_laplace_2d

    k = 3 if args.smoke else 50
    trials = 1 if args.smoke else args.trials
    nx = 128 if args.smoke else 3200
    a = create_laplace_2d(nx, nx, dtype=F32)
    cells = {}
    A_van, s_van, b_van = apply_cell(a, "dia", k, trials)
    _, s_sym, b_sym = apply_cell(a, "dia", k, trials, symmetric=True)
    cells["lap2d_dia_vanilla"] = {"ms_per_apply": s_van * 1e3,
                                  "bytes_per_apply": b_van}
    cells["lap2d_dia_symmetric"] = {"ms_per_apply": s_sym * 1e3,
                                    "bytes_per_apply": b_sym}

    nrhs = 8
    xb = A_van.to_dist_block(np.full((a.nrows, nrhs), 1e-3, F32))
    s_blk = seconds_per_apply(lambda A_, u: A_.matmat(u) * F32(0.125),
                              A_van, xb, k, trials)
    cells["lap2d_dia_matmat8"] = {"ms_per_block": s_blk * 1e3,
                                  "block_over_8_matvecs": s_blk / (8 * s_van)}

    aw = banded_random(30_000 if args.smoke else 4_000_000)
    Aw, s_w, b_w = apply_cell(aw, "well", k, trials)
    _, s_e, b_e = apply_cell(aw, "ell", k, trials)
    cells["banded_random_4M"] = {"format": Aw.local_format,
                                 "ms_per_apply": s_w * 1e3, "bytes_per_apply": b_w,
                                 "ell_ms_per_apply": s_e * 1e3,
                                 "ell_bytes_per_apply": b_e}
    if not args.no_solvers:
        cells["lap2d_solvers"] = solver_cells(a, A_van, args.smoke, trials)
    if not args.no_corpus:
        cells["corpus"] = corpus_cells(args.smoke, k, trials)

    out = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                      "count": len(jax.devices())},
           "smoke": args.smoke, "k": k, "trials": trials, "cells": cells}
    if args.smoke:
        out["cells"] = _without_times(cells)  # a CPU time is no device metric
    else:
        copy = copy_rate_gbs(trials=trials)
        out["card"] = card  # name and power limit, as nvidia-smi gives them
        out["hbm_peak_gbs"] = peak
        out["hbm_peak_source"] = PEAKS[dev.device_kind]["source"]
        out["copy_gbs"] = copy
        for c in (cells["lap2d_dia_vanilla"], cells["lap2d_dia_symmetric"],
                  cells["banded_random_4M"]):
            gbs = c["bytes_per_apply"] / (c["ms_per_apply"] / 1e3) / 1e9
            c.update(gbs=gbs, share_of_peak=gbs / peak,
                     share_of_copy=gbs / copy)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
