"""Solver settings.

The port's own copy of ``clarabel_tpu/settings.py``: the same fields,
defaults and ``validate()``, so that ``dataclasses.asdict`` of either
package's settings builds the other's (``convert.settings_from_dict``).

Mirror of the reference settings surface
(reference: src/solver/implementations/default/settings.rs:29-248) as a
frozen, hashable dataclass.  ``validate()`` accepts every method name the JAX
package accepts; the solver then rejects the names this port does not run
yet (``solver.DefaultSolver``).
"""

from __future__ import annotations

import dataclasses
import math


class SettingsError(ValueError):
    """Raised for an invalid settings combination.

    reference: src/solver/core/settings.rs:13-26
    """


@dataclasses.dataclass(frozen=True)
class DefaultSettings:
    """Solver settings with reference-equivalent defaults.

    reference: src/solver/implementations/default/settings.rs:29-248
    """

    # main algorithm settings
    max_iter: int = 200
    time_limit: float = math.inf
    verbose: bool = True
    max_step_fraction: float = 0.99

    # full accuracy settings
    tol_gap_abs: float = 1e-8
    tol_gap_rel: float = 1e-8
    tol_feas: float = 1e-8
    tol_infeas_abs: float = 1e-8
    tol_infeas_rel: float = 1e-8
    tol_ktratio: float = 1e-6

    # reduced accuracy settings ("almost solved")
    reduced_tol_gap_abs: float = 5e-5
    reduced_tol_gap_rel: float = 5e-5
    reduced_tol_feas: float = 1e-4
    reduced_tol_infeas_abs: float = 5e-12
    reduced_tol_infeas_rel: float = 5e-5
    reduced_tol_ktratio: float = 1e-4

    # data equilibration settings
    equilibrate_enable: bool = True
    equilibrate_max_iter: int = 10
    equilibrate_min_scaling: float = 1e-4
    equilibrate_max_scaling: float = 1e4

    # step size settings
    linesearch_backtrack_step: float = 0.8
    min_switch_step_length: float = 1e-1
    min_terminate_step_length: float = 1e-4

    # linear solver settings.  ``direct_solve_method``:
    #   "auto"         — structure-based selection: diagonal-Hs layouts take
    #                    the structured Schur path, large sparse problems the
    #                    multifrontal engine, symmetric f32 TPU layouts with
    #                    n+m <= 1024 the Pallas LDL, everything else LU
    #   "lu" / "schur" / "schur_diag" / "schur_lr" / "pallas" /
    #   "multifrontal" — forced
    #   "qdldl" / "faer" / "dense" — accepted for reference wire compat;
    #                    map to the LU quasidefinite path
    # ``max_threads`` and ``direct_kkt_solver`` are reference wire-compat
    # NO-OPS here: XLA owns device parallelism (there is no thread pool to
    # size), and only direct KKT solvers exist (direct_kkt_solver=False is
    # rejected by validate(), matching the reference).
    max_threads: int = 0
    direct_kkt_solver: bool = True
    direct_solve_method: str = "auto"
    # fill-reducing ordering for the multifrontal symbolic analysis
    # (reference: QDLDLSettings perm / amd ordering, qdldl.rs:31-40,905-922):
    #   "auto"    — nested dissection for large patterns, minimum degree
    #               for small ones, with an automatic ND retry when MD
    #               yields a chain schedule
    #   "nd" / "mmd" / "natural" — forced
    multifrontal_ordering: str = "auto"

    # static regularization parameters
    static_regularization_enable: bool = True
    static_regularization_constant: float = 1e-8
    static_regularization_proportional: float = 2.220446049250313e-16 ** 2

    # dynamic regularization parameters (used by the LDL pivots of the
    # sparse path; the dense LU path relies on static regularization + IR)
    dynamic_regularization_enable: bool = True
    dynamic_regularization_eps: float = 1e-13
    dynamic_regularization_delta: float = 2e-7

    # iterative refinement (for direct solves)
    iterative_refinement_enable: bool = True
    iterative_refinement_reltol: float = 1e-13
    iterative_refinement_abstol: float = 1e-12
    iterative_refinement_max_iter: int = 10
    iterative_refinement_stop_ratio: float = 5.0

    # preprocessing
    presolve_enable: bool = True
    input_sparse_dropzeros: bool = False

    # chordal decomposition
    chordal_decomposition_enable: bool = True
    chordal_decomposition_merge_method: str = "clique_graph"
    chordal_decomposition_compact: bool = True
    chordal_decomposition_complete_dual: bool = True

    @classmethod
    def for_float32(cls, **overrides) -> "DefaultSettings":
        """Defaults retuned for the f32/TPU regime: the reference's 1e-8
        tolerances sit below f32 resolution, so targets move to ~1e-5 with
        the reduced tier at 1e-4/1e-3 and refinement thresholds near the
        f32 floor."""
        base = dict(
            tol_gap_abs=1e-5, tol_gap_rel=1e-5, tol_feas=1e-5,
            tol_infeas_abs=1e-5, tol_infeas_rel=1e-5,
            reduced_tol_gap_abs=1e-4, reduced_tol_gap_rel=1e-4,
            reduced_tol_feas=1e-3,
            iterative_refinement_abstol=1e-6,
            iterative_refinement_reltol=1e-7,
            # regularization floors scaled to f32 machine epsilon
            # (the f64 defaults sit below f32 resolution: a pivot can pass
            # the 1e-13 test yet be pure rounding noise, which blows up the
            # unpivoted LDL on nonsymmetric-cone layouts)
            static_regularization_constant=1e-6,
            dynamic_regularization_eps=1e-9,
            dynamic_regularization_delta=1e-5,
        )
        base.update(overrides)
        return cls(**base)

    def validate(self) -> None:
        """Check settings validity at construction.

        reference: src/solver/implementations/default/settings.rs:281-300
        """
        if self.max_iter < 1:
            raise SettingsError("max_iter must be >= 1")
        if not self.direct_kkt_solver:
            raise SettingsError("only direct KKT solvers are supported")
        if self.direct_solve_method not in (
            "auto", "lu", "schur", "schur_diag", "schur_lr", "pallas",
            "dense", "qdldl", "faer", "multifrontal"
        ):
            raise SettingsError(
                f"unknown direct_solve_method {self.direct_solve_method!r}"
            )
        if self.multifrontal_ordering not in ("auto", "nd", "mmd", "natural"):
            raise SettingsError(
                f"unknown multifrontal_ordering {self.multifrontal_ordering!r}"
            )
        if self.chordal_decomposition_merge_method not in (
            "none",
            "parent_child",
            "clique_graph",
        ):
            raise SettingsError(
                "chordal_decomposition_merge_method must be one of "
                "'none', 'parent_child', 'clique_graph'"
            )
        for name in (
            "max_step_fraction",
            "linesearch_backtrack_step",
        ):
            v = getattr(self, name)
            if not (0.0 < v <= 1.0):
                raise SettingsError(f"{name} must be in (0, 1]")
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, float) and math.isnan(v):
                raise SettingsError(f"{f.name} is NaN")
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                if v < 0:
                    raise SettingsError(f"{f.name} must be nonnegative")

    # settings that may not change between successive solves of the same
    # solver object (they alter problem structure fixed at setup)
    # reference: src/solver/implementations/default/settings.rs:302-335
    _IMMUTABLE = (
        "equilibrate_enable",
        "equilibrate_max_iter",
        "equilibrate_min_scaling",
        "equilibrate_max_scaling",
        "direct_kkt_solver",
        "direct_solve_method",
        "multifrontal_ordering",
        "presolve_enable",
        "input_sparse_dropzeros",
        "chordal_decomposition_enable",
        "chordal_decomposition_merge_method",
        "chordal_decomposition_compact",
        "chordal_decomposition_complete_dual",
    )

    def validate_as_update(self, current: "DefaultSettings") -> None:
        """Check that an updated settings object does not modify
        structure-determining fields.

        reference: src/solver/implementations/default/settings.rs:259-335
        """
        self.validate()
        for name in self._IMMUTABLE:
            if getattr(self, name) != getattr(current, name):
                raise SettingsError(f"setting {name!r} is immutable after setup")
