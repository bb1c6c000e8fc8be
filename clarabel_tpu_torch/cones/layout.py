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


class PSDBucket:
    """All PSD cones sharing one matrix dimension ``n`` (the JAX package's
    ``PSDBucket``, without the f32 hi/lo scale splits).

    ``svec`` packing follows the reference convention (column-major upper
    triangle with √2-scaled off-diagonals; src/algebra/dense/types.rs), so
    Frobenius inner products equal svec dot products.
    """

    def __init__(self, n: int, offsets):
        self.n = n
        self.tri = (n * (n + 1)) // 2
        self.count = len(offsets)
        # gather index [count, tri] into the PSD group vector
        self.gather = np.asarray(
            [np.arange(o, o + self.tri) for o in offsets], np.int64
        ).reshape(self.count, self.tri)
        # svec position p <-> (row I[p], col J[p]) with I <= J
        I, J = [], []
        for col in range(n):
            for row in range(col + 1):
                I.append(row)
                J.append(col)
        self.I = np.asarray(I, np.int64)
        self.J = np.asarray(J, np.int64)
        self.is_diag = self.I == self.J
        self.diag_pos = np.nonzero(self.is_diag)[0]
        # svec->mat divides the off-diagonal entries by √2
        self.unpack_scale = np.where(self.is_diag, 1.0, 1.0 / np.sqrt(2.0))
        # the svec position of each matrix entry (i, j): the gather that
        # unpacks an svec into its symmetric matrix
        pos = np.zeros((n, n), np.int64)
        pos[self.I, self.J] = np.arange(self.tri)
        pos[self.J, self.I] = np.arange(self.tri)
        self.mat_pos = pos

    def tensors(self, dtype, device) -> dict:
        """The bucket's index and scale arrays as tensors on ``device``
        (scales in ``dtype``)."""
        as_long = lambda a: torch.as_tensor(a, dtype=torch.long, device=device)
        return {
            "gather": as_long(self.gather),
            "I": as_long(self.I),
            "J": as_long(self.J),
            "is_diag": torch.as_tensor(self.is_diag, device=device),
            "diag_pos": as_long(self.diag_pos),
            "mat_pos": as_long(self.mat_pos),
            "mat_scale": torch.as_tensor(self.unpack_scale[self.mat_pos], dtype=dtype,
                                         device=device),
            # the skron's 1/√2 on each diagonal svec position
            "skron_f": torch.as_tensor(np.where(self.is_diag, 1.0 / np.sqrt(2.0), 1.0),
                                       dtype=dtype, device=device),
        }


def _padded_segments(starts, dims):
    """([k, widest] int index, [k, widest] bool mask) of k contiguous
    segments: row i holds ``starts[i] + 0 .. dims[i] - 1``, padded with the
    segment's row 0 and masked off there."""
    widest = max(dims, default=0)
    offs = np.arange(widest)
    dims = np.asarray(dims, np.int64).reshape(-1, 1)
    mask = offs < dims
    idx = np.where(mask, np.asarray(starts, np.int64).reshape(-1, 1) + offs, 0)
    return idx, mask


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

        # ---- 3-dimensional exponential / power cone metadata --------
        self.num_exp = sum(1 for c in self.cones if c.kind == api.EXP)
        pow_alphas = [c.alpha[0] for c in self.cones if c.kind == api.POW]
        self.num_pow = len(pow_alphas)
        self.pow_alpha = np.asarray(pow_alphas, np.float64)

        # ---- generalized power cone segment metadata ----------------
        gp = [c for c in self.cones if c.kind == api.GENPOW]
        self.genpow_cones = tuple(gp)
        self.num_genpow = len(gp)
        self.m_genpow = sum(c.nvars for c in gp)
        if gp:
            # each genpow cone occupies [alpha-part (dim1) | q-part (dim2)],
            # stored consecutively; segments index cones
            segs, part2, alphas = [], [], []
            for gi, c in enumerate(gp):
                d1, d2 = len(c.alpha), c.dim2
                segs.append(np.full(d1 + d2, gi, np.int32))
                part2.append(np.concatenate([np.zeros(d1, bool), np.ones(d2, bool)]))
                alphas.append(np.asarray(c.alpha + (0.0,) * d2, np.float64))
            self.genpow_seg = np.concatenate(segs)
            self.genpow_is_q = np.concatenate(part2)
            self.genpow_alpha = np.concatenate(alphas)
        else:
            self.genpow_seg = np.zeros(0, np.int32)
            self.genpow_is_q = np.zeros(0, bool)
            self.genpow_alpha = np.zeros(0, np.float64)
        # per genpow cone: its barrier degree, and 1/‖α‖² of its primal
        # gradient's Newton start (genpowcone.rs:409-441)
        self.genpow_degree = np.asarray([len(c.alpha) + 1 for c in gp], np.float64)
        self.genpow_psi = np.asarray([1.0 / sum(x * x for x in c.alpha) for c in gp], np.float64)
        gp_dims = [c.nvars for c in gp]
        self.gp_pad_idx, self.gp_pad_mask = _padded_segments(
            np.cumsum([0] + gp_dims[:-1]), gp_dims)

        # ---- PSD triangle cone metadata ------------------------------
        # cones are bucketed by matrix dimension n; each bucket batches all
        # its cones into [..., k, n, n] tensors
        self.psd_dims = tuple(c.dim for c in self.cones if c.kind == api.PSD)
        self.num_psd = len(self.psd_dims)
        self.m_psd = sum(api._triangular_number(d) for d in self.psd_dims)
        self.psd_buckets = []  # list of PSDBucket, by increasing n
        if self.num_psd:
            # svec order within the PSD group follows cone order; bucket
            # cones of equal n together with gather indices into the group
            by_n = {}
            off = 0
            for d in self.psd_dims:
                by_n.setdefault(d, []).append(off)
                off += api._triangular_number(d)
            for n_mat, offs in sorted(by_n.items()):
                self.psd_buckets.append(PSDBucket(n_mat, offs))

        # the cones whose rows equilibration rectifies to their mean
        # (reference: NN and Zero cones keep elementwise scaling,
        # nonnegativecone.rs:53-56, zerocone.rs:50-53; all others rectify to
        # the per-cone mean, socone.rs:97-101 etc.): a mask over the
        # (permuted) m-vector, and each row's index among those cones
        rect = np.zeros(self.m, bool)
        rect_seg = np.zeros(self.m, np.int32)
        rect_starts, rect_dims = [], []
        pos = {k: self.group_slices[k].start for k in _GROUP_ORDER}
        for c in self.cones:
            k, w = c.kind, c.nvars
            if k not in (api.ZERO, api.NONNEGATIVE):
                rect[pos[k] : pos[k] + w] = True
                rect_seg[pos[k] : pos[k] + w] = len(rect_dims)
                rect_starts.append(pos[k])
                rect_dims.append(w)
            pos[k] += w
        self.rectify_mask = rect
        self.rect_seg = rect_seg
        self.rect_dims = tuple(rect_dims)

        # segment sums in a fixed order: each segment's rows gathered into a
        # row of a [segments, widest] index, its pads masked (the SOCs'
        # rows within the SOC group; the rectified cones' within the
        # m-vector)
        self.soc_pad_idx, self.soc_pad_mask = _padded_segments(self.soc_head_idx, soc_dims)
        self.rect_pad_idx, self.rect_pad_mask = _padded_segments(rect_starts, rect_dims)

        self._device_index = {}

    # ----------------------------------------------------------------
    def slice_of(self, kind: int) -> slice:
        return self.group_slices[kind]

    def index_tensors(self, device) -> dict:
        """The SOC, power and generalized power cone metadata and the
        equilibration segments as tensors on ``device``, made once per
        device (the PSD buckets': :meth:`psd_tensors`)."""
        key = str(device)
        if key not in self._device_index:
            as_long = lambda a: torch.as_tensor(a, dtype=torch.long, device=device)
            as_bool = lambda a: torch.as_tensor(a, dtype=torch.bool, device=device)
            as_f64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
            self._device_index[key] = {
                "soc_seg": as_long(self.soc_seg),
                "soc_head_idx": as_long(self.soc_head_idx),
                "soc_head_mask": as_bool(self.soc_head_mask),
                "soc_pad_idx": as_long(self.soc_pad_idx),
                "soc_pad_mask": as_bool(self.soc_pad_mask),
                "rectify_mask": as_bool(self.rectify_mask),
                "rect_seg": as_long(self.rect_seg),
                "rect_pad_idx": as_long(self.rect_pad_idx),
                "rect_pad_mask": as_bool(self.rect_pad_mask),
                "rect_dims": as_long(self.rect_dims),
                "pow_alpha": as_f64(self.pow_alpha),
                "genpow_seg": as_long(self.genpow_seg),
                "genpow_is_q": as_bool(self.genpow_is_q),
                "genpow_alpha": as_f64(self.genpow_alpha),
                "genpow_degree": as_f64(self.genpow_degree),
                "genpow_psi": as_f64(self.genpow_psi),
                "gp_pad_idx": as_long(self.gp_pad_idx),
                "gp_pad_mask": as_bool(self.gp_pad_mask),
            }
        return self._device_index[key]

    def psd_tensors(self, dtype, device) -> list:
        """:meth:`PSDBucket.tensors` of each PSD bucket, made once per dtype
        and device."""
        key = ("psd", str(device), dtype)
        if key not in self._device_index:
            self._device_index[key] = [b.tensors(dtype, device) for b in self.psd_buckets]
        return self._device_index[key]

    def zero_row_mask(self, dtype, device) -> torch.Tensor:
        """1 on the zero-cone (equality) rows, which lead the row order, and
        0 elsewhere: an [m] tensor of ``dtype`` on ``device``, made once per
        dtype and device."""
        key = (str(device), dtype)
        if key not in self._device_index:
            mask = torch.zeros(self.m, dtype=dtype, device=device)
            mask[: self.n_zero] = 1.0
            self._device_index[key] = mask
        return self._device_index[key]

    def __hash__(self):
        return hash(self.cones)

    def __eq__(self, other):
        return isinstance(other, ConeLayout) and self.cones == other.cones

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"ConeLayout(m={self.m}, cones={list(self.cones)})"
