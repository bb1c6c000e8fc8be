"""Judge returned solutions by the optimality conditions of the conic
program they claim to solve, worked out again from the inputs.

A program  minimize ½xᵀPx + qᵀx  subject to  Ax + s = b,  s ∈ K  is solved
by (x, s, z) when

    Ax + s − b = 0,  s ∈ K,  Px + Aᵀz + q = 0,  z ∈ K*,  and the gap
    between ½xᵀPx + qᵀx and −½xᵀPx − bᵀz is 0.

For each solution this module computes, in float64 from the raw inputs,
the numbers the solver's ``Solved`` status stands for (Clarabel's residual
and gap measures, info.rs), with the distance of s from K and of z from K*
added to the residuals, and the distance of the returned objective from
the one x gives:

- ``res``: the larger of the primal residual
  (‖Ax + s − b‖₂ + dist(s, K)) / max(1, ‖b‖∞ + ‖x‖₂ + ‖s‖₂) and the dual
  residual (‖Px + Aᵀz + q‖₂ + dist(z, K*)) / max(1, ‖q‖∞ + ‖x‖₂ + ‖z‖₂)
- ``gap``: |pobj − dobj| / max(1, min(|pobj|, |dobj|))
- ``obj``: |returned objective − pobj| / max(1, |pobj|)

and ``not_solved``, the count of solutions whose status is not ``Solved``.
"""

import importlib

import numpy as np

NUMBERS = ("not_solved", "res", "gap", "obj")


def cone_module(kind: str):
    """The reference's module of a cone kind: ``reference/cones/<kind>.py``."""
    try:
        return importlib.import_module(f"{__package__}.cones.{kind}")
    except ModuleNotFoundError as exc:
        raise ValueError(f"no reference for cone kind {kind!r}") from exc


def cone_distance(v: np.ndarray, cones, dual: bool) -> np.ndarray:
    """Euclidean distance of each row of ``v`` [L, m] from the product cone
    (or, with ``dual``, from its dual cone); ``cones`` lists ``[kind,
    arguments]`` pairs in row order."""
    sq = np.zeros(v.shape[0])
    row = 0
    for kind, args in cones:
        cone = cone_module(kind)
        size = cone.rows(*args)
        sq += cone.distance_sq(v[:, row:row + size], *args, dual=dual)
        row += size
    if row != v.shape[1]:
        raise ValueError(f"the cones cover {row} rows, the vectors have {v.shape[1]}")
    return np.sqrt(sq)


def _apply(M, v: np.ndarray, transpose: bool = False) -> np.ndarray:
    """M v for each lane: M is [L, r, c] (dense, one per lane) or one matrix
    (dense or scipy sparse) shared by every lane of v [L, ·]."""
    if isinstance(M, np.ndarray) and M.ndim == 3:
        M = np.swapaxes(M, 1, 2) if transpose else M
        return np.einsum("lrc,lc->lr", M, v)
    M = M.T if transpose else M
    return np.asarray(M @ v.T).T


def numbers(inst: dict, out: dict) -> dict:
    """Per-solution numbers of one call: ``inst`` holds P, q, A, b and
    ``cones`` as the generator made them (a batch as [L, ...] arrays),
    ``out`` the returned x, s, z ([L, ·]), ``status`` (L names) and
    ``obj_val`` (L).  Returns {number: [L] array}."""
    x, s, z = (np.atleast_2d(np.asarray(out[k], np.float64)) for k in ("x", "s", "z"))
    q, b = np.atleast_2d(inst["q"]), np.atleast_2d(inst["b"])
    Px = _apply(inst["P"], x)
    r_p = _apply(inst["A"], x) + s - b
    r_d = Px + _apply(inst["A"], z, transpose=True) + q
    xPx = np.sum(x * Px, axis=1)
    pobj = 0.5 * xPx + np.sum(q * x, axis=1)
    dobj = -0.5 * xPx - np.sum(b * z, axis=1)
    nx, ns, nz = (np.linalg.norm(v, axis=1) for v in (x, s, z))
    cones = inst["cones"]
    pres = (np.linalg.norm(r_p, axis=1) + cone_distance(s, cones, dual=False)) / np.maximum(
        1.0, np.max(np.abs(b), axis=1) + nx + ns)
    dres = (np.linalg.norm(r_d, axis=1) + cone_distance(z, cones, dual=True)) / np.maximum(
        1.0, np.max(np.abs(q), axis=1) + nx + nz)
    gap = np.abs(pobj - dobj) / np.maximum(1.0, np.minimum(np.abs(pobj), np.abs(dobj)))
    obj = np.abs(np.asarray(out["obj_val"], np.float64).ravel() - pobj) / np.maximum(1.0, np.abs(pobj))
    not_solved = (np.asarray(out["status"]).ravel() != "Solved").astype(np.float64)
    res = dict(not_solved=not_solved, res=np.maximum(pres, dres), gap=gap, obj=obj)
    # a NaN is no number under any limit
    return {k: np.where(np.isnan(v), np.inf, v) for k, v in res.items()}


def judge(pairs, limits: dict) -> dict:
    """Judge every call: ``pairs`` yields (instance, output) pairs.
    Returns the largest reading of each number over every solution (for
    ``not_solved`` the count), the count of solutions that broke a limit,
    the count judged, and ``correct``."""
    worst = {k: 0.0 for k in NUMBERS}
    judged = failed = 0
    for inst, out in pairs:
        per = numbers(inst, out)
        bad = np.zeros(per["res"].shape[0], bool)
        for k in NUMBERS:
            v = per[k]
            bad |= v > limits[k]
            worst[k] = worst[k] + float(v.sum()) if k == "not_solved" else max(worst[k], float(v.max()))
        judged += bad.size
        failed += int(bad.sum())
    return dict(worst=worst, judged=judged, failed=failed,
                correct=judged > 0 and failed == 0)
