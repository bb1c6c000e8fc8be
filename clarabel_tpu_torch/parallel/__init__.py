"""Batched and multi-device solves: many problems of one structure in one
solve, split over the ranks of a device mesh or not, and one problem's
constraint rows sharded over a mesh."""

from . import distributed
from .batch import BatchSolution, BatchSolver
from .sharded import ShardedRowSolver
from .sparse_batch import SparseBatchSolver

__all__ = ["BatchSolver", "BatchSolution", "ShardedRowSolver", "SparseBatchSolver",
           "distributed"]
