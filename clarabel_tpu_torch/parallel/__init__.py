"""Batched solves: many problems of one structure in one solve."""

from .batch import BatchSolution, BatchSolver
from .sparse_batch import SparseBatchSolver

__all__ = ["BatchSolver", "BatchSolution", "SparseBatchSolver"]
