"""Static cone layout: the host-side description of the composite cone.

The port's copy of ``clarabel_tpu/cones/layout.py``.  Inversion of the
reference's ``CompositeCone`` object
(reference: src/solver/core/cones/compositecone.rs:11-128): instead of a
heterogeneous list of cone objects dispatched per-cone at run time, we compute
a static *layout* on the host once, permute constraint rows so equal cone
kinds are contiguous, and express every cone operation as a vectorized
segment computation over those contiguous groups.  All fields here are plain
Python/NumPy; :meth:`ConeLayout.index_tensors` holds their device copies.

Group order along the permuted slack vector:
    [ zero | nonnegative | soc | exp | pow | genpow | psd ]
"""

from __future__ import annotations

import numpy as np
import torch

from . import api
from .api import ConeSpec

_GROUP_ORDER = (api.ZERO, api.NONNEGATIVE, api.SOC, api.EXP, api.POW, api.GENPOW, api.PSD)


class ConeLayout:
    """Immutable layout of a composite cone over ``m`` constraint rows."""

    def __init__(self, cones):
        self.cones = tuple(cones)
        for c in self.cones:
            if not isinstance(c, ConeSpec):
                raise TypeError(f"expected ConeSpec, got {type(c)}")

        self.m = sum(c.nvars for c in self.cones)
        self.degree = sum(c.degree for c in self.cones)
        self.is_symmetric = all(c.is_symmetric for c in self.cones)
        # reference: GenPowerCone is the only cone that forbids primal-dual
        # scaling (src/solver/core/cones/mod.rs:57, genpowcone.rs)
        self.allows_primal_dual_scaling = all(
            c.kind != api.GENPOW for c in self.cones
        )

        # ---- row permutation grouping cones by kind -----------------
        # perm[i_internal] = i_user ;  b_internal = b_user[perm]
        offsets = np.cumsum([0] + [c.nvars for c in self.cones])
        by_kind = {k: [] for k in _GROUP_ORDER}
        for ci, c in enumerate(self.cones):
            by_kind[c.kind].append(ci)

        perm_blocks = []
        self.group_slices = {}
        pos = 0
        for kind in _GROUP_ORDER:
            width = 0
            for ci in by_kind[kind]:
                c = self.cones[ci]
                perm_blocks.append(np.arange(offsets[ci], offsets[ci] + c.nvars))
                width += c.nvars
            self.group_slices[kind] = slice(pos, pos + width)
            pos += width
        self.perm = (
            np.concatenate(perm_blocks).astype(np.int32)
            if perm_blocks
            else np.zeros(0, np.int32)
        )

        # convenience group views
        self.n_zero = self.group_slices[api.ZERO].stop - self.group_slices[api.ZERO].start
        self.n_nn = self.group_slices[api.NONNEGATIVE].stop - self.group_slices[api.NONNEGATIVE].start

        # ---- SOC segment metadata -----------------------------------
        soc_dims = [c.dim for c in self.cones if c.kind == api.SOC]
        self.soc_dims = tuple(soc_dims)
        self.num_soc = len(soc_dims)
        self.m_soc = sum(soc_dims)
        if self.num_soc:
            self.soc_seg = np.repeat(
                np.arange(self.num_soc, dtype=np.int32), soc_dims
            )
            heads = np.cumsum([0] + soc_dims[:-1]).astype(np.int32)
            self.soc_head_idx = heads  # positions of each cone's t-component
            head_mask = np.zeros(self.m_soc, bool)
            head_mask[heads] = True
            self.soc_head_mask = head_mask
        else:
            self.soc_seg = np.zeros(0, np.int32)
            self.soc_head_idx = np.zeros(0, np.int32)
            self.soc_head_mask = np.zeros(0, bool)

        # ---- counts of the cones this port does not run yet (the KKT
        # backend resolution reads them; the solver rejects the cones)
        self.num_exp = sum(1 for c in self.cones if c.kind == api.EXP)
        self.num_pow = sum(1 for c in self.cones if c.kind == api.POW)
        self.num_genpow = sum(1 for c in self.cones if c.kind == api.GENPOW)
        self.num_psd = sum(1 for c in self.cones if c.kind == api.PSD)

        # per-cone segment ids over the whole (permuted) m-vector, used by
        # equilibration rectification; plus a mask of entries whose cone
        # requires scalar (per-cone-constant) equilibration
        seg_all = np.zeros(self.m, np.int32)
        rect = np.zeros(self.m, bool)
        pos = {k: self.group_slices[k].start for k in _GROUP_ORDER}
        cone_id = 0
        for c in self.cones:
            k, w = c.kind, c.nvars
            seg_all[pos[k] : pos[k] + w] = cone_id
            # reference: NN and Zero cones keep elementwise scaling
            # (nonnegativecone.rs:53-56, zerocone.rs:50-53); all others
            # rectify to the per-cone mean (socone.rs:97-101 etc.)
            if k not in (api.ZERO, api.NONNEGATIVE):
                rect[pos[k] : pos[k] + w] = True
            pos[k] += w
            cone_id += 1
        self.cone_seg = seg_all
        self.rectify_mask = rect
        self.num_cones = len(self.cones)

        self._device_index = {}

    # ----------------------------------------------------------------
    def slice_of(self, kind: int) -> slice:
        return self.group_slices[kind]

    def index_tensors(self, device) -> dict:
        """The SOC segment metadata and the equilibration segments as
        tensors on ``device``, made once per device."""
        key = str(device)
        if key not in self._device_index:
            as_long = lambda a: torch.as_tensor(a, dtype=torch.long, device=device)
            as_bool = lambda a: torch.as_tensor(a, dtype=torch.bool, device=device)
            self._device_index[key] = {
                "soc_seg": as_long(self.soc_seg),
                "soc_head_idx": as_long(self.soc_head_idx),
                "soc_head_mask": as_bool(self.soc_head_mask),
                "cone_seg": as_long(self.cone_seg),
                "rectify_mask": as_bool(self.rectify_mask),
            }
        return self._device_index[key]

    def __hash__(self):
        return hash(self.cones)

    def __eq__(self, other):
        return isinstance(other, ConeLayout) and self.cones == other.cones

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"ConeLayout(m={self.m}, cones={list(self.cones)})"
