"""paddle.linalg namespace (``paddle_tpu/linalg.py`` counterpart): the
decomposition, solve and factorisation ops of ``ops/linalg.py``."""
from .ops.linalg import (  # noqa: F401
    cholesky, cholesky_solve, cond_number as cond, corrcoef, cov, det, eig,
    eigh, eigvals, eigvalsh, householder_product, inverse as inv, lstsq, lu,
    lu_unpack, matrix_exp, matrix_power, matrix_rank, multi_dot, norm,
    ormqr, pca_lowrank, pinv, qr, slogdet, solve, svd, svdvals,
    triangular_solve, vecdot, vector_norm, matrix_norm,
)

__all__ = [
    "cholesky", "cholesky_solve", "cond", "corrcoef", "cov", "det", "eig",
    "eigh", "eigvals", "eigvalsh", "householder_product", "inv", "lstsq",
    "lu", "lu_unpack", "matrix_exp", "matrix_power", "matrix_rank",
    "multi_dot", "norm", "ormqr", "pca_lowrank", "pinv", "qr", "slogdet",
    "solve", "svd", "svdvals", "triangular_solve", "vecdot", "vector_norm",
    "matrix_norm",
]
