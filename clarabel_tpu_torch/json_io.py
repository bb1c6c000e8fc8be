"""Problem JSON save/load, wire-compatible with the reference format.

The port's copy of ``clarabel_tpu/json_io.py`` (host NumPy and SciPy).
reference: src/solver/implementations/default/json.rs — serializes
(P, q, A, b, cones, settings) with matrices in CSC form and settings
sanitized for infinities.  Files written by the reference solver or by the
JAX package load here directly, and files written here load there.
"""

from __future__ import annotations

import dataclasses
import json
import math

import numpy as np

from .cones import api
from .settings import DefaultSettings

_F64_MAX = np.finfo(np.float64).max


def _csc_to_json(M) -> dict:
    """Dense or scipy-sparse -> CSC json dict.  Sparse inputs are never
    densified (memory stays O(nnz); json.rs:22-96 serializes CSC natively)."""
    import scipy.sparse as sp

    C = sp.csc_matrix(M)
    C.sort_indices()
    return {
        "m": int(M.shape[0]),
        "n": int(M.shape[1]),
        "colptr": C.indptr.tolist(),
        "rowval": C.indices.tolist(),
        "nzval": C.data.tolist(),
    }


def _csc_from_json(d: dict):
    """CSC json dict -> scipy csc_matrix (O(nnz); callers densify only on
    the dense solve path)."""
    import scipy.sparse as sp

    return sp.csc_matrix(
        (d["nzval"], d["rowval"], d["colptr"]), shape=(d["m"], d["n"])
    )


def _cone_to_json(c: api.ConeSpec):
    if c.kind == api.ZERO:
        return {"ZeroConeT": c.dim}
    if c.kind == api.NONNEGATIVE:
        return {"NonnegativeConeT": c.dim}
    if c.kind == api.SOC:
        return {"SecondOrderConeT": c.dim}
    if c.kind == api.EXP:
        return {"ExponentialConeT": []}
    if c.kind == api.POW:
        return {"PowerConeT": c.alpha[0]}
    if c.kind == api.GENPOW:
        return {"GenPowerConeT": [list(c.alpha), c.dim2]}
    if c.kind == api.PSD:
        return {"PSDTriangleConeT": c.dim}
    raise ValueError(f"unknown cone {c}")


def _cone_from_json(d):
    if isinstance(d, str):
        # serde can emit fieldless variants as bare strings
        d = {d: []}
    (name, val), = d.items()
    if name == "ZeroConeT":
        return api.ZeroConeT(val)
    if name == "NonnegativeConeT":
        return api.NonnegativeConeT(val)
    if name == "SecondOrderConeT":
        return api.SecondOrderConeT(val)
    if name == "ExponentialConeT":
        return api.ExponentialConeT()
    if name == "PowerConeT":
        return api.PowerConeT(val)
    if name == "GenPowerConeT":
        return api.GenPowerConeT(val[0], val[1])
    if name == "PSDTriangleConeT":
        return api.PSDTriangleConeT(val)
    raise ValueError(f"unknown cone type {name!r}")


def _settings_to_json(s: DefaultSettings) -> dict:
    out = dataclasses.asdict(s)
    # sanitize infs (json.rs:99-103)
    if out["time_limit"] == math.inf:
        out["time_limit"] = float(_F64_MAX)
    return out


def _settings_from_json(d: dict) -> DefaultSettings:
    known = {f.name for f in dataclasses.fields(DefaultSettings)}
    kwargs = {k: v for k, v in d.items() if k in known}
    if kwargs.get("time_limit", 0) >= float(_F64_MAX):
        kwargs["time_limit"] = math.inf
    return DefaultSettings(**kwargs)


def save_problem(path, P, q, A, b, cones, settings: DefaultSettings):
    import scipy.sparse as sp

    P_triu = sp.triu(P, format="csc") if sp.issparse(P) else np.triu(P)
    data = {
        "P": _csc_to_json(P_triu),
        "q": np.asarray(q, np.float64).tolist(),
        "A": _csc_to_json(A),
        "b": np.asarray(b, np.float64).tolist(),
        "cones": [_cone_to_json(c) for c in cones],
        "settings": _settings_to_json(settings),
    }
    with open(path, "w") as f:
        json.dump(data, f)


def load_problem(path, settings: DefaultSettings | None = None):
    with open(path) as f:
        data = json.load(f)
    P = _csc_from_json(data["P"])
    q = np.asarray(data["q"], np.float64)
    A = _csc_from_json(data["A"])
    b = np.asarray(data["b"], np.float64)
    cones = tuple(_cone_from_json(c) for c in data["cones"])
    if settings is None:
        settings = _settings_from_json(data.get("settings", {}))
    return P, q, A, b, cones, settings
