"""Stage functions of the planar pipeline and the kernels' wrappers.

planar (complex BLAS pieces, blocked Cholesky, triangular solves),
pchol (kernel K1), sytrd_planar (hetrd), latrd (kernel K2), stedc,
unmtr_planar, refine_planar.
"""
