"""Solver status taxonomy.

Mirrors the 12 terminal states of the reference solver
(reference: src/solver/core/solver.rs:19-45).  Values are plain ints so
that they can live in int32 device tensors inside the IPM loop.
"""

from __future__ import annotations

import enum


class SolverStatus(enum.IntEnum):
    """Status of the solver at termination."""

    Unsolved = 0
    Solved = 1
    PrimalInfeasible = 2
    DualInfeasible = 3
    AlmostSolved = 4
    AlmostPrimalInfeasible = 5
    AlmostDualInfeasible = 6
    MaxIterations = 7
    MaxTime = 8
    NumericalError = 9
    InsufficientProgress = 10
    CallbackTerminated = 11

    def is_infeasible(self) -> bool:
        """reference: src/solver/core/solver.rs:48-55"""
        return self in (
            SolverStatus.PrimalInfeasible,
            SolverStatus.DualInfeasible,
            SolverStatus.AlmostPrimalInfeasible,
            SolverStatus.AlmostDualInfeasible,
        )

    def is_errored(self) -> bool:
        """reference: src/solver/core/solver.rs:57-63"""
        return self in (SolverStatus.NumericalError, SolverStatus.InsufficientProgress)


# Scaling strategies for linearizing centrality conditions
# (reference: src/solver/core/solver.rs:77-80)
SCALING_PRIMAL_DUAL = 0
SCALING_DUAL = 1
