"""The cone of positive semidefinite matrices of order ``dim`` in svec form
(the upper triangle column by column, off-diagonal entries times √2, so that
the Euclidean distance is the Frobenius one), its own dual."""

import numpy as np


def rows(dim: int) -> int:
    return dim * (dim + 1) // 2


def smat(v: np.ndarray, order: int) -> np.ndarray:
    """[..., order, order] symmetric matrices from svec vectors."""
    cols = np.concatenate([np.full(j + 1, j) for j in range(order)])
    rows_ = np.concatenate([np.arange(j + 1) for j in range(order)])
    scale = np.where(rows_ == cols, 1.0, 1.0 / np.sqrt(2.0))
    X = np.zeros(v.shape[:-1] + (order, order))
    X[..., rows_, cols] = v * scale
    X[..., cols, rows_] = v * scale
    return X


def distance_sq(seg: np.ndarray, dim: int, dual: bool) -> np.ndarray:
    w = np.linalg.eigvalsh(smat(seg, dim))
    return np.sum(np.minimum(w, 0.0) ** 2, axis=1)
