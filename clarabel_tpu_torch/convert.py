"""What the JAX package and this port share: settings and cones.

The solver has no weights.  Both packages build their own solvers from the
same problem data (numpy P, q, A, b) and these two descriptions:

- settings as the plain dictionary ``dataclasses.asdict`` makes of either
  package's ``DefaultSettings``;
- cones as ``(kind, dim, params)`` triples, ``params`` holding ``alpha`` and
  ``dim2`` where the cone kind has them.

Nothing here imports the JAX package: :func:`cone_specs` reads any object
with the ``ConeSpec`` attributes.
"""

from __future__ import annotations

import dataclasses

from .cones.api import ConeSpec
from .settings import DefaultSettings


def settings_from_dict(d: dict) -> DefaultSettings:
    """This port's settings from ``dataclasses.asdict`` of a settings
    object; an unknown field raises."""
    names = {f.name for f in dataclasses.fields(DefaultSettings)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"unknown settings fields: {unknown}")
    return DefaultSettings(**d)


def cone_specs(cones) -> list:
    """``[(kind, dim, params), ...]`` of cone specs from either package."""
    out = []
    for c in cones:
        params = {}
        if c.alpha:
            params["alpha"] = tuple(float(a) for a in c.alpha)
        if c.dim2:
            params["dim2"] = int(c.dim2)
        out.append((int(c.kind), int(c.dim), params))
    return out


def cones_from_specs(specs) -> tuple:
    """This port's cone list from ``(kind, dim, params)`` triples."""
    return tuple(
        ConeSpec(
            int(kind), int(dim),
            alpha=tuple(params.get("alpha", ())),
            dim2=int(params.get("dim2", 0)),
        )
        for kind, dim, params in specs
    )
