"""spmv_tpu — a distributed sparse linear-algebra framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of LIBSPMV
(Excalibur-SLE/spmv, surveyed in SURVEY.md): distributed sparse matrix-vector
multiplication over row-block partitions, a compiled halo-exchange plan
(the L2GMap equivalent — see ``spmv_tpu.parallel.comm_plan``), communication/
compute overlap, a symmetric lower-triangle storage optimization, a
Conjugate-Gradient solver, and PETSc binary I/O.

Layer map (JAX analogue of reference layers L0-L7, SURVEY.md section 1):

====================  =======================================================
reference (C++/MPI)    spmv_tpu (JAX/XLA)
====================  =======================================================
DeviceExecutor (L0)    JAX device placement (XLA compiles for the device)
csr/coo kernels (L1)   ``spmv_tpu.ops`` XLA applies on ELL/DIA/WELL
CSR/COOMatrix (L2)     ``spmv_tpu.formats`` device formats (host CSR import)
L2GMap (L3)            ``spmv_tpu.parallel.comm_plan.CommPlan``
Matrix (L4)            ``spmv_tpu.parallel.dist_matrix.DistMatrix``
cg (L5)                ``spmv_tpu.solvers.cg``
read_petsc (L6)        ``spmv_tpu.io.petsc``
spmv.h (L7)            this module
====================  =======================================================
"""

from spmv_tpu.formats.csr import CSRHost, csr_matmul
from spmv_tpu.formats.ell import EllMatrix, csr_to_ell
from spmv_tpu.formats.dia import DiaMatrix, csr_to_dia, dia_transpose
from spmv_tpu.gen import (
    create_laplace_1d,
    create_laplace_2d,
    create_laplace_3d,
    gaussian_bump,
)
from spmv_tpu.formats.well import (
    SymWellMatrix,
    csr_to_well_sym,
    WellMatrix,
    csr_to_well,
    split_window,
    well_occupancy,
)
from spmv_tpu.ops.spmv_ell import spmv_ell, spmv_ell_transpose
from spmv_tpu.ds import ds_from_f64, ds_to_f64
from spmv_tpu.ops.spmv_dia_ds import (
    DiaDsMatrix,
    csr_to_dia_ds,
    spmm_dia_ds_2d,
    spmv_dia_ds,
    spmv_dia_ds_2d,
)
from spmv_tpu.ops.spmv_well import (
    spmv_well_sym,
    spmv_well_sym_2d,
    WellDsMatrix,
    csr_to_well_ds,
    spmm_well_2d,
    spmv_well,
    spmv_well_2d,
    spmv_well_ds,
    spmv_well_ds_2d,
    well_to_2d,
)
from spmv_tpu.reorder import (
    bandwidth,
    permute_symmetric,
    rcm_reorder,
    reverse_cuthill_mckee,
)
from spmv_tpu.ops.spmv_dia import (
    dia_to_2d,
    spmm_dia,
    spmm_dia_2d,
    spmv_dia,
    spmv_dia_2d,
)
from spmv_tpu.solvers.bicgstab import BiCGStabResult, bicgstab
from spmv_tpu.solvers.gmres import GMRESResult, gmres
from spmv_tpu.solvers.gmres_sstep import gmres_sstep
from spmv_tpu.solvers.newton_basis import (
    modified_leja,
    newton_basis_ops,
    newton_recurrence_matrix,
    newton_shifts_from_operator,
)
from spmv_tpu.solvers.lsqr import LSQRResult, lsqr
from spmv_tpu.solvers.minres import MINRESResult, minres
from spmv_tpu.solvers.lobpcg import LOBPCGResult, lane_block_ops, lobpcg
from spmv_tpu.solvers.block_cg import (
    BlockCGResult,
    block_cg,
    block_cg_dia,
    block_cg_refined,
    block_cg_refined_dist,
)
from spmv_tpu.solvers.arnoldi import (
    ArnoldiRitz,
    arnoldi_factorization,
    arnoldi_ritz,
)
from spmv_tpu.solvers.lanczos import (
    condition_estimate,
    condition_interval,
    lanczos_extreme,
    lanczos_extreme_with_bounds,
    lanczos_factorization,
)
from spmv_tpu.solvers.funm import (
    expm_multiply,
    funm_multiply,
    inv_sqrt_multiply,
    slq_logdet,
    slq_trace,
    sqrt_multiply,
)
from spmv_tpu.solvers.precond import block_jacobi_preconditioner
from spmv_tpu.solvers.spai import spai_preconditioner, spai_setup
from spmv_tpu.solvers.fsai import fsai_preconditioner, fsai_setup
from spmv_tpu.solvers.svds import SVDSResult, gk_factorization, svds
from spmv_tpu.solvers.deflation import cg_deflated
from spmv_tpu.solvers.amg import (
    AMGHierarchy,
    amg_preconditioner,
    amg_setup,
)
from spmv_tpu.solvers.cg import (
    cg,
    cg_pipelined,
    cg_residual_history,
    CGResult,
)
from spmv_tpu.solvers.cg_sstep import cg_sstep
from spmv_tpu.solvers.chebyshev import (
    chebyshev,
    chebyshev_adaptive,
    chebyshev_bounds,
    chebyshev_iterations_for,
    ChebyshevResult,
)
from spmv_tpu.solvers.refine import RefineResult, cg_refined, cg_refined_dist
from spmv_tpu.io.petsc import (
    read_petsc_binary_matrix_host,
    read_petsc_binary_vector_host,
    write_petsc_binary_matrix,
    write_petsc_binary_vector,
)
from spmv_tpu.io.matrix_market import read_matrix_market, write_matrix_market
from spmv_tpu.interop import from_bcoo, from_scipy, to_bcoo, to_scipy
from spmv_tpu.parallel.comm_plan import (
    CommPlan,
    CommPlan2,
    compile_plan,
    compile_plan_two_tier,
    plan_stats,
)
from spmv_tpu.parallel.dist_matrix import (
    DistMatrix,
    build_dist_matrix,
    build_dist_matrix_from_shards,
)
from spmv_tpu.parallel.partition import owner_ranges, partition_csr
from spmv_tpu.parallel.powers import (
    PowersPlan,
    build_powers_plan,
    chebyshev_powers_basis,
    newton_powers_basis,
    powers_ghost_stats,
)

__version__ = "0.1.0"

__all__ = [
    "CSRHost",
    "csr_matmul",
    "from_scipy",
    "to_scipy",
    "from_bcoo",
    "to_bcoo",
    "EllMatrix",
    "csr_to_ell",
    "DiaMatrix",
    "csr_to_dia",
    "dia_transpose",
    "create_laplace_1d",
    "create_laplace_2d",
    "create_laplace_3d",
    "gaussian_bump",
    "spmv_ell",
    "spmv_ell_transpose",
    "spmv_dia",
    "spmv_dia_2d",
    "dia_to_2d",
    "cg",
    "cg_pipelined",
    "cg_residual_history",
    "cg_sstep",
    "chebyshev",
    "chebyshev_adaptive",
    "chebyshev_bounds",
    "chebyshev_iterations_for",
    "bicgstab",
    "BiCGStabResult",
    "gmres",
    "gmres_sstep",
    "modified_leja",
    "newton_basis_ops",
    "newton_recurrence_matrix",
    "newton_shifts_from_operator",
    "lsqr",
    "LSQRResult",
    "minres",
    "MINRESResult",
    "lobpcg",
    "lane_block_ops",
    "LOBPCGResult",
    "GMRESResult",
    "block_jacobi_preconditioner",
    "spai_preconditioner",
    "fsai_preconditioner",
    "fsai_setup",
    "SVDSResult",
    "gk_factorization",
    "svds",
    "cg_deflated",
    "lanczos_factorization",
    "expm_multiply",
    "funm_multiply",
    "inv_sqrt_multiply",
    "sqrt_multiply",
    "slq_logdet",
    "slq_trace",
    "spai_setup",
    "AMGHierarchy",
    "amg_preconditioner",
    "amg_setup",
    "arnoldi_ritz",
    "arnoldi_factorization",
    "ArnoldiRitz",
    "lanczos_extreme",
    "condition_estimate",
    "condition_interval",
    "lanczos_extreme_with_bounds",
    "spmm_dia",
    "spmm_dia_2d",
    "block_cg",
    "block_cg_dia",
    "block_cg_refined",
    "block_cg_refined_dist",
    "BlockCGResult",
    "CGResult",
    "cg_refined",
    "cg_refined_dist",
    "RefineResult",
    "read_petsc_binary_matrix_host",
    "read_petsc_binary_vector_host",
    "write_petsc_binary_matrix",
    "write_petsc_binary_vector",
    "read_matrix_market",
    "write_matrix_market",
    "CommPlan",
    "CommPlan2",
    "compile_plan",
    "compile_plan_two_tier",
    "plan_stats",
    "DistMatrix",
    "build_dist_matrix",
    "build_dist_matrix_from_shards",
    "owner_ranges",
    "partition_csr",
    "PowersPlan",
    "build_powers_plan",
    "chebyshev_powers_basis",
    "newton_powers_basis",
    "powers_ghost_stats",
    "WellMatrix",
    "csr_to_well",
    "csr_to_well_sym",
    "SymWellMatrix",
    "spmv_well_sym",
    "spmv_well_sym_2d",
    "split_window",
    "well_occupancy",
    "DiaDsMatrix",
    "csr_to_dia_ds",
    "spmv_dia_ds",
    "spmv_dia_ds_2d",
    "spmm_dia_ds_2d",
    "ds_from_f64",
    "ds_to_f64",
    "spmv_well",
    "WellDsMatrix",
    "csr_to_well_ds",
    "spmv_well_ds",
    "spmv_well_ds_2d",
    "spmv_well_2d",
    "spmm_well_2d",
    "well_to_2d",
    "bandwidth",
    "permute_symmetric",
    "rcm_reorder",
    "reverse_cuthill_mckee",
]
