"""The nonnegative orthant, its own dual."""

import numpy as np


def rows(dim: int) -> int:
    return dim


def distance_sq(seg: np.ndarray, dim: int, dual: bool) -> np.ndarray:
    return np.sum(np.minimum(seg, 0.0) ** 2, axis=1)
