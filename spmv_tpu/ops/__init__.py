"""Compute applies (the reference's L1 kernel layer).

Where the reference has per-backend CSR/COO inner loops
(reference spmv/csr_kernels.cpp, spmv/cuda/csr_kernels.cuda.cu, ...),
spmv_tpu has one format-specialized JAX apply per storage format (DIA,
double-single DIA, WELL, ELL), which XLA compiles for whatever device runs
it — the executor double-dispatch layer dissolves.
"""
