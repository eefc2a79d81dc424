"""Sparse storage formats.

Host-side import format is CSR (``CSRHost``, numpy). Device formats have
static, row-uniform shapes: padded ELLPACK (``EllMatrix``) and windowed
gather-ELL (``WellMatrix``) for general sparsity and DIA/diagonal
(``DiaMatrix``) for banded/stencil operators. The reference's CSR/COO
device formats (reference spmv/csr_matrix.h, spmv/coo_matrix.h) map onto
these; conversion happens at assembly time, mirroring the reference's Eigen->device copy
(reference spmv/csr_matrix.cpp:35-58).
"""
