"""Chordal decomposition of sparse PSD cones (the port's copy of
``clarabel_tpu/chordal``): host-side NumPy work that rewrites a problem
into small clique cones before the solve and maps the solution back."""

from .decomp import ChordalInfo, try_chordal_info

__all__ = ["ChordalInfo", "try_chordal_info"]
