"""Host-side presolve: elimination of unbounded nonnegative constraints.

reference: src/solver/implementations/default/presolver.rs — rows of
nonnegative cones whose bound exceeds the infinity threshold are dropped
before the solve and reconstructed afterwards with s = inf, z = 0.

This is host work on NumPy data, done once at setup (it changes problem
shape).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .cones import api
from .cones.api import ConeSpec
from .infbound import get_infinity


@dataclasses.dataclass
class Presolver:
    keep_logical: np.ndarray  # bool[m_full]; False rows are eliminated
    mfull: int
    mreduced: int
    infbound: float

    @property
    def is_reduced(self) -> bool:
        return self.mreduced < self.mfull

    @property
    def count_reduced(self) -> int:
        return self.mfull - self.mreduced


def try_presolve(
    A: np.ndarray, b: np.ndarray, cones: Tuple[ConeSpec, ...], settings
) -> Optional[Presolver]:
    """Build a presolver if any reduction is possible.

    reference: presolver.rs:157-204 (make_reduction_map)
    """
    if not settings.presolve_enable:
        return None

    infbound = get_infinity()
    # contract slightly so we are firmly "less than"
    thresh = (1.0 - np.finfo(np.float64).eps * 10.0) * infbound

    keep = np.ones(b.shape[0], bool)
    idx = 0
    for cone in cones:
        w = cone.nvars
        if cone.kind == api.NONNEGATIVE:
            rows = slice(idx, idx + w)
            keep[rows] = b[rows] <= thresh
        idx += w

    mreduced = int(keep.sum())
    if mreduced == b.shape[0]:
        return None
    return Presolver(keep, b.shape[0], mreduced, infbound)


def apply_presolve(presolver: Presolver, A, b, cones):
    """Reduce (A, b, cones) by the keep mask.  reference: presolver.rs:77-132"""
    keep = presolver.keep_logical
    A_new = A[keep, :]
    b_new = b[keep]

    cones_new = []
    idx = 0
    for cone in cones:
        w = cone.nvars
        if cone.kind == api.NONNEGATIVE:
            nkeep = int(keep[idx : idx + w].sum())
            if nkeep > 0:
                cones_new.append(api.NonnegativeConeT(nkeep))
        else:
            cones_new.append(cone)
        idx += w
    return A_new, b_new, tuple(cones_new)


def reverse_presolve(presolver: Presolver, z_red, s_red):
    """Map the reduced (z, s) back to full size.

    reference: presolver.rs:134-154 — eliminated rows get s = inf, z = 0.
    """
    keep = presolver.keep_logical
    z = np.zeros(presolver.mfull, z_red.dtype)
    s = np.full(presolver.mfull, presolver.infbound, s_red.dtype)
    z[keep] = z_red
    s[keep] = s_red
    return z, s
