"""Batched solves: many problems of one structure in one solve."""

from .batch import BatchSolution, BatchSolver

__all__ = ["BatchSolver", "BatchSolution"]
