"""User-facing cone specifications.

Mirrors the reference API cone enum (reference:
src/solver/core/cones/supportedcone.rs:17-52) including the cone-collapsing
preprocessing (:105-161) that merges runs of nonnegative / 1-dimensional
cones and drops empty cones.

Cone specs are immutable, hashable values: together they form the static
"layout" of a solve.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

# cone kind tags.  The order here fixes the internal row-permutation group
# order: [zero | nonnegative | soc | exp | pow | genpow | psd].
ZERO = 0
NONNEGATIVE = 1
SOC = 2
EXP = 3
POW = 4
GENPOW = 5
PSD = 6

_KIND_NAMES = {
    ZERO: "ZeroCone",
    NONNEGATIVE: "NonnegativeCone",
    SOC: "SecondOrderCone",
    EXP: "ExponentialCone",
    POW: "PowerCone",
    GENPOW: "GenPowerCone",
    PSD: "PSDTriangleCone",
}


def _triangular_number(k: int) -> int:
    return (k * (k + 1)) // 2


@dataclasses.dataclass(frozen=True)
class ConeSpec:
    """A single cone in the Cartesian product K.

    ``dim`` is the natural dimension parameter (matching the user argument of
    the reference API constructors); ``nvars`` gives the number of slack
    variables the cone contributes (reference: supportedcone.rs:59-70).
    """

    kind: int
    dim: int = 0
    alpha: Tuple[float, ...] = ()
    dim2: int = 0

    @property
    def nvars(self) -> int:
        if self.kind in (ZERO, NONNEGATIVE, SOC):
            return self.dim
        if self.kind in (EXP, POW):
            return 3
        if self.kind == GENPOW:
            return len(self.alpha) + self.dim2
        if self.kind == PSD:
            return _triangular_number(self.dim)
        raise ValueError(f"unknown cone kind {self.kind}")

    @property
    def degree(self) -> int:
        """Barrier degree (reference: per-cone ``degree`` impls)."""
        if self.kind == ZERO:
            return 0
        if self.kind == NONNEGATIVE:
            return self.dim
        if self.kind == SOC:
            return 1
        if self.kind in (EXP, POW):
            return 3
        if self.kind == GENPOW:
            # reference: src/solver/core/cones/genpowcone.rs:94-96
            return len(self.alpha) + 1
        if self.kind == PSD:
            return self.dim
        raise ValueError(f"unknown cone kind {self.kind}")

    @property
    def is_symmetric(self) -> bool:
        return self.kind in (ZERO, NONNEGATIVE, SOC, PSD)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        name = _KIND_NAMES[self.kind]
        if self.kind == POW:
            return f"{name}({self.alpha[0]})"
        if self.kind == GENPOW:
            return f"{name}({list(self.alpha)}, {self.dim2})"
        if self.kind == EXP:
            return f"{name}()"
        return f"{name}({self.dim})"


# -----------------------------------------------------------------
# constructors mirroring the reference API names
# -----------------------------------------------------------------


def ZeroConeT(dim: int) -> ConeSpec:
    return ConeSpec(ZERO, int(dim))


def NonnegativeConeT(dim: int) -> ConeSpec:
    return ConeSpec(NONNEGATIVE, int(dim))


def SecondOrderConeT(dim: int) -> ConeSpec:
    return ConeSpec(SOC, int(dim))


def ExponentialConeT() -> ConeSpec:
    return ConeSpec(EXP, 3)


def PowerConeT(alpha: float) -> ConeSpec:
    if not (0.0 < alpha < 1.0):
        raise ValueError("PowerConeT exponent must lie in (0, 1)")
    return ConeSpec(POW, 3, alpha=(float(alpha),))


def GenPowerConeT(alpha: Sequence[float], dim2: int) -> ConeSpec:
    alpha = tuple(float(a) for a in alpha)
    if any(a <= 0.0 for a in alpha):
        raise ValueError("GenPowerConeT exponents must be positive")
    if abs(sum(alpha) - 1.0) > 1e-12 * len(alpha):
        raise ValueError("GenPowerConeT exponents must sum to 1")
    return ConeSpec(GENPOW, len(alpha), alpha=alpha, dim2=int(dim2))


def PSDTriangleConeT(dim: int) -> ConeSpec:
    return ConeSpec(PSD, int(dim))


# -----------------------------------------------------------------
# cone collapsing
# -----------------------------------------------------------------


def collapse_cones(cones: Sequence[ConeSpec]) -> Tuple[ConeSpec, ...]:
    """Consolidate the user cone list.

    Runs of nonnegative cones and 1-dimensional SOC/PSD cones (which are all
    the same set {x >= 0}) merge into single nonnegative cones; empty cones
    are dropped.  reference: supportedcone.rs:105-161.
    """

    def collapsible(c: ConeSpec) -> bool:
        return (
            c.kind == NONNEGATIVE
            or (c.kind == SOC and c.dim == 1)
            or (c.kind == PSD and c.dim == 1)
        )

    out = []
    run = 0
    for c in cones:
        if c.nvars == 0:
            continue
        if collapsible(c):
            run += c.nvars
            continue
        if run > 0:
            out.append(NonnegativeConeT(run))
            run = 0
        out.append(c)
    if run > 0:
        out.append(NonnegativeConeT(run))
    return tuple(out)
