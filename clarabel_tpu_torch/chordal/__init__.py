"""Chordal decomposition of PSD cones: only the guard is ported.

``clarabel_tpu/chordal/decomp.py:587-596`` decides whether a problem is
decomposed.  This port supports no PSD cones yet, so no problem it accepts
is ever decomposed; a PSD cone that would be raises.
"""

from __future__ import annotations

from ..cones import api


def try_chordal_info(A, b, cones, settings):
    """None when the problem is not decomposed (reference:
    problemdata.rs:352-381)."""
    del A, b
    if not settings.chordal_decomposition_enable:
        return None
    if not any(c.kind == api.PSD and c.dim > 3 for c in cones):
        return None
    raise NotImplementedError(
        "chordal decomposition of PSD cones is not ported (ROADMAP.md Queue 1 item 13)"
    )


__all__ = ["try_chordal_info"]
