"""Batched solves: many problems of one structure in one solve."""

from .batch import BatchSolution, BatchSolver, SparseBatchSolver

__all__ = ["BatchSolver", "BatchSolution", "SparseBatchSolver"]
