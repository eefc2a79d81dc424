"""Comm/compute overlap precondition — checked on the compiled CPU program.

The framework's replacement for the reference's nonblocking-MPI overlap
(``spmv_overlap``, reference spmv/Matrix.cpp:498-511 + update_finalise,
spmv/L2GMap.cpp:528-561) is structural: the ghost buffer is a separate value
with no dependence on the interior SpMV, so XLA's scheduler is free to keep
the halo collectives in flight while the interior products run.

These tests compile the distributed DIA matvec on a 4-device CPU mesh and
read the optimized HLO: every multiply that reads the local DIA matrix must
be independent of the collective-permutes, while the remote (ghost) products
must depend on them — the second check keeps the first one honest. Whether
the GPU schedule actually brackets the interior work with an async
collective is printed by ``chip_smoke.py --four-cards``.
"""
import jax
import numpy as np
from jax.sharding import Mesh

from spmv_tpu.gen import create_laplace_2d
from spmv_tpu.parallel.dist_matrix import build_dist_matrix
from spmv_tpu.utils.hlo import (
    halo_bracket,
    interior_products_independent,
    parse_hlo,
)


def _compiled_matvec_hlo(symmetric: bool, local_format: str = "dia") -> str:
    mesh = Mesh(np.array(jax.devices()[:4]), ("shards",))
    a = create_laplace_2d(64, 64, dtype=np.float32)
    A = build_dist_matrix(a, mesh=mesh, local_format=local_format,
                          dtype=np.float32, symmetric=symmetric)
    x = A.to_dist(np.ones(a.nrows, np.float32))
    assert A.plan.nghost_pad > 0 and A.plan.rounds
    return jax.jit(lambda A_, x_: A_.matvec(x_)).lower(A, x).compile().as_text()


def _assert_interior_independent(symmetric: bool) -> None:
    hlo = _compiled_matvec_hlo(symmetric)
    products = interior_products_independent(hlo, "local_dia_data")
    assert len(products) >= 3, products  # one per stored diagonal, at least
    assert not any(dep for _, dep in products), products


def test_interior_kernel_independent_of_halo():
    """Dataflow precondition for overlap: no interior DIA product reads a
    collective-permute result, directly or transitively."""
    _assert_interior_independent(False)


def test_interior_kernel_independent_of_halo_symmetric():
    """The same for symmetric storage, whose local block also applies the
    transposed sub-diagonals."""
    _assert_interior_independent(True)


def test_remote_products_depend_on_halo():
    """Sensitivity: the ghost-column products DO read the halo exchange."""
    hlo = _compiled_matvec_hlo(False, local_format="ell")
    products = interior_products_independent(hlo, "remote_values")
    assert products and all(dep for _, dep in products), products


def test_halo_bracket_reports_cpu_collectives_as_sync():
    """The CPU backend runs collective-permutes synchronously, so nothing
    can bracket the interior work there; the query says so instead of
    guessing."""
    hlo = _compiled_matvec_hlo(False)
    br = halo_bracket(hlo, "local_dia_data")
    assert br["n_sync_permutes"] >= 1 and br["n_async_permutes"] == 0
    assert br["bracketed"] is False


def test_parse_hlo_finds_entry_and_fusions():
    hlo = _compiled_matvec_hlo(False)
    entry, comps = parse_hlo(hlo)
    ops = {op for _, op, _, _ in comps[entry]}
    assert "parameter" in ops and "collective-permute" in ops
    assert any(op == "fusion" for op in ops)
