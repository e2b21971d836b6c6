"""Zonal (edge-frame) execution of the TP -> radial scale -> Linear pipeline.

Counterpart of ``hamgnn_tpu/e3/zonal_tp.py``.  The same function as
``packed_tp.plain_apply`` (same parameters, same outputs up to rounding),
restructured around the pipeline's rotation equivariance: with R_e a rotation
taking the edge direction to +z (where this codebase's real spherical
harmonics are zonal, sh_l(z) = sqrt(2l+1) e_{m=0}),

    out(x, sh(r)) = D_out(R_e)^T  out(D_in(R_e) x, sh(z))

and sh(z) is a constant.  In the edge frame a CG contraction with a zonal
operand couples only m1 = +-m3, so each mid column is a static combination of
at most two rotated-x entries instead of a d1-term per-edge contraction.

The module holds the frame construction (``align_to_z``,
``batched_wigner_D``, ``direction_from_sh``, with a one-entry memo so that
the pipelines sharing an edge set build their Wigner-D matrices once), the
static ``ZonalSpec``, the part between the two rotations
(``plain_zonal_core`` and its backward ``plain_zonal_core_backward``, the
plain versions of the Hopper kernels in ``zonal_kernel.py``) and
``zonal_apply``, the plain PyTorch version of the whole engine.

The frame is data: the rotations come from ``sh.detach()``, so ``sh`` never
receives a gradient from this engine, as in the JAX package
(``stop_gradient``).  The rotated x and the rotated output use the plan's
normal (u-major) layouts.
"""

from __future__ import annotations

import contextlib
import functools
from typing import List

import numpy as np
import torch

from ..utils.constants import device_constant
from .packed_tp import PackedTPPlan, get_plan, out_stage, out_stage_backward
from .wigner import PERM_YZX, wigner_3j


# ----------------------------------------------------------------------
# batched Wigner-D from edge directions
# ----------------------------------------------------------------------

def align_to_z(r_hat: torch.Tensor) -> torch.Tensor:
    """(E, 3) unit vectors -> (E, 3, 3) rotations R with R @ r_hat = +z.

    Rodrigues about the axis r x z; the antipodal branch (z < 0) goes
    through the well-conditioned rotation to -z followed by a flip about x.
    A zero vector gives the identity.
    """
    x, y, z = r_hat[:, 0], r_hat[:, 1], r_hat[:, 2]

    def rodrigues(c, sign):
        # axis v = r x (sign * z-hat) = sign * (y, -x, 0);
        # R = I + [v]x + [v]x^2 / (1 + c)
        vx, vy = sign * y, -sign * x
        k = 1.0 / torch.clamp(1.0 + c, min=1e-12)
        rows = [[1.0 - k * vy * vy, k * vx * vy, vy],
                [k * vx * vy, 1.0 - k * vx * vx, -vx],
                [-vy, vx, 1.0 - k * (vx * vx + vy * vy)]]
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    R_pos = rodrigues(z, 1.0)     # r -> +z, conditioned for z >= 0
    R_neg = rodrigues(-z, -1.0)   # r -> -z, conditioned for z < 0
    flip = device_constant("flip_x", lambda: [1.0, -1.0, -1.0], r_hat.dtype,
                           r_hat.device)  # pi about x: -z -> z
    return torch.where((z >= 0.0)[:, None, None], R_pos, flip[None, :, None] * R_neg)


@functools.lru_cache(maxsize=None)
def _recursion_matrix(l: int) -> np.ndarray:
    return wigner_3j(l - 1, 1, l).reshape((2 * l - 1) * 3, 2 * l + 1)


def batched_wigner_D(max_l: int, R: torch.Tensor) -> List[torch.Tensor]:
    """[D_0 .. D_max_l], D_l (E, 2l+1, 2l+1): real Wigner-D matrices in the
    yzx real-SH basis, by the CG recursion of ``wigner.wigner_D``."""
    E = R.shape[0]
    P = device_constant("perm_yzx", lambda: PERM_YZX, R.dtype, R.device)
    D1 = torch.einsum("ij,ejk,lk->eil", P, R, P)
    Ds = [R.new_ones((E, 1, 1)), D1]
    for l in range(2, max_l + 1):
        W = device_constant(("wigner_recursion", l), lambda: _recursion_matrix(l), R.dtype,
                            R.device)
        n = (2 * l - 1) * 3
        big = torch.einsum("eab,ecd->eacbd", Ds[l - 1], D1).reshape(E, n, n)
        Ds.append((2.0 * l + 1.0) * torch.einsum("ma,emn,nb->eab", W, big, W))
    return Ds[: max_l + 1]


def direction_from_sh(sh: torch.Tensor, sh_l1_slice: slice) -> torch.Tensor:
    """Unit edge direction from the l=1 block of ``sh`` (= sqrt(3) (y, z, x)).

    Renormalised; a zero block (a padded edge) gives the zero vector, for
    which ``align_to_z`` returns the identity."""
    blk = sh[:, sh_l1_slice]
    v = torch.stack([blk[:, 2], blk[:, 0], blk[:, 1]], dim=-1)  # (x, y, z)
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return v / torch.clamp(n, min=1e-12)


# ----------------------------------------------------------------------
# static spec
# ----------------------------------------------------------------------

class ZonalSpec:
    """Static edge-frame schedule of a ``PackedTPPlan``.

    Per input chunk g, mid column k (m3-major within an output-irrep group,
    as in the plan's coupling tensor) of multiplicity index u is

        mid[:, k, u] = c1[k] * x_rot[:, u, i1[k]] + c2[k] * x_rot[:, u, i2[k]]

    with static ``chunk_zonal[g] = (i1, c1, i2, c2)`` from the zonal coupling
    sh(z)^T C_g, which has at most two nonzero m1 per column.
    """

    def __init__(self, plan: PackedTPPlan):
        self.plan = plan
        sh_z = np.zeros(plan.irreps_sh.dim)
        ofs = 0
        l1_slice = None
        for mul, ir in plan.irreps_sh:
            if mul != 1:
                raise ValueError("the zonal engine takes sh irreps of multiplicity 1")
            sh_z[ofs + ir.l] = np.sqrt(2 * ir.l + 1)
            if ir.l == 1:
                l1_slice = slice(ofs, ofs + 3)
            ofs += ir.dim
        if l1_slice is None:
            raise ValueError("the zonal engine needs an l=1 block in sh")
        self.sh_l1_slice = l1_slice
        self.max_l_feat = max(
            [(d1 - 1) // 2 for (_s, _m, d1, _C, _g) in plan.per_chunk]
            + [mio.ir.dim // 2 for mio in plan.irreps_out])

        self.chunk_zonal = []
        for (_sl, _mul, _d1, C, _groups) in plan.per_chunk:
            K = C.shape[-1]
            if K == 0:
                self.chunk_zonal.append(None)
                continue
            Wz = np.einsum("s,sik->ik", sh_z, C)  # (d1, K)
            i1, i2 = np.zeros(K, np.int32), np.zeros(K, np.int32)
            c1, c2 = np.zeros(K), np.zeros(K)
            for k in range(K):
                nz = np.nonzero(np.abs(Wz[:, k]) > 1e-12)[0]
                if len(nz) > 2:
                    raise ArithmeticError(
                        f"zonal coupling column {k} has {len(nz)} nonzero m1 (> 2)")
                if len(nz) >= 1:
                    i1[k], c1[k] = nz[0], Wz[nz[0], k]
                if len(nz) == 2:
                    i2[k], c2[k] = nz[1], Wz[nz[1], k]
            self.chunk_zonal.append((i1, c1, i2, c2))
        self._device_tables = {}

    def tables(self, device):
        """Per chunk (i1, c1, i2, c2) as tensors on ``device`` (made outside
        inference mode: the cache also serves autograd)."""
        key = str(device)
        if key not in self._device_tables:
            with torch.inference_mode(False):
                self._device_tables[key] = [
                    None if cz is None else (
                        torch.as_tensor(cz[0], dtype=torch.long, device=device),
                        torch.as_tensor(cz[1], dtype=torch.float32, device=device),
                        torch.as_tensor(cz[2], dtype=torch.long, device=device),
                        torch.as_tensor(cz[3], dtype=torch.float32, device=device))
                    for cz in self.chunk_zonal]
        return self._device_tables[key]


@functools.lru_cache(maxsize=None)
def _zonal_spec_for_key(key) -> ZonalSpec:
    return ZonalSpec(get_plan(*key))


def get_zonal_spec(plan: PackedTPPlan) -> ZonalSpec:
    return _zonal_spec_for_key(plan.key)


# ----------------------------------------------------------------------
# frames: the Wigner-D matrices of an edge set, built once
# ----------------------------------------------------------------------

class _FrameMemo:
    """The last edge set's Wigner-D matrices.

    A model forward runs many pipelines on one ``sh`` tensor.  The memo
    holds that tensor itself (so its identity cannot be reused by another),
    its version counter and the D matrices built from it; the next call
    with the same tensor at the same version reuses them, the recompute of a
    gradient-checkpointed layer included.  Matrices built under
    ``torch.inference_mode`` cannot be saved for a backward, so they serve
    inference-mode calls only.

    An inference tensor has no version counter, so an in-place change of it
    cannot be seen.  Its matrices are therefore reused only inside
    ``one_forward()``, the span of one model forward, which makes ``sh``
    itself and leaves it alone; outside such a span every call on an
    inference tensor builds its own.

    ``builds`` counts the runs of ``batched_wigner_D``.
    """

    def __init__(self):
        self.builds = 0
        self.depth = 0
        self.clear()

    def clear(self):
        self.sh = None
        self.version = None
        self.l1_start = None
        self.Ds = None

    @contextlib.contextmanager
    def one_forward(self):
        self.depth += 1
        try:
            yield
        finally:
            self.depth -= 1
            if self.depth == 0 and self.sh is not None and self.sh.is_inference():
                self.clear()

    def frames(self, sh: torch.Tensor, sh_l1_slice: slice, max_l: int):
        # an inference tensor is held only inside a span, so finding it here
        # means this span's own calls made the entry
        version = None if sh.is_inference() else sh._version
        hit = (self.sh is sh and self.version == version
               and self.l1_start == sh_l1_slice.start and len(self.Ds) > max_l
               and (torch.is_inference_mode_enabled() or not self.Ds[0].is_inference()))
        if not hit:
            with torch.no_grad():
                R = align_to_z(direction_from_sh(sh.detach(), sh_l1_slice))
                Ds = batched_wigner_D(max_l, R)
            self.builds += 1
            if sh.is_inference() and self.depth == 0:
                self.clear()
                return Ds
            self.sh, self.version = sh, version
            self.l1_start, self.Ds = sh_l1_slice.start, Ds
        return self.Ds[: max_l + 1]


FRAME_MEMO = _FrameMemo()


def edge_frames(spec: ZonalSpec, sh: torch.Tensor) -> List[torch.Tensor]:
    """[D_0 .. D_max_l_feat] of the edge directions in ``sh``, without
    gradient, from the memo where ``sh`` is the tensor it holds."""
    return FRAME_MEMO.frames(sh, spec.sh_l1_slice, spec.max_l_feat)


def _rotation_runs(irreps):
    """Consecutive chunks of one irrep dimension as one (width, dim) run:
    they share a Wigner-D matrix, and in the u-major layout a run is one
    (E, total multiplicity, dim) view."""
    runs = []
    for mi in irreps:
        d = mi.ir.dim
        if runs and runs[-1][1] == d:
            runs[-1] = (runs[-1][0] + mi.dim, d)
        else:
            runs.append((mi.dim, d))
    return runs


def _rotate(irreps, x, Ds, pattern):
    """Each run of ``x`` (E, irreps.dim), viewed (E, u, j), contracted with
    its D matrix by ``pattern``.  ``split`` and ``cat`` keep the backward to
    one concatenation (slices would each fill and add a full-width tensor);
    scalars pass through, D_0 being 1."""
    E = x.shape[0]
    runs = _rotation_runs(irreps)
    parts = []
    for piece, (width, d) in zip(x.split([w for w, _d in runs], dim=-1), runs):
        if d > 1:
            piece = torch.einsum(pattern, Ds[(d - 1) // 2],
                                 piece.reshape(E, width // d, d)).reshape(E, width)
        parts.append(piece)
    return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]


def rotate_in(plan: PackedTPPlan, x, Ds):
    """x (E, d_in) -> x_rot: each input chunk (E, mul, d1) times D_l1."""
    return _rotate(plan.irreps_in, x, Ds, "eij,euj->eui")


def rotate_out(plan: PackedTPPlan, out_rot, Ds):
    """out_rot (E, d_out) -> out: each output chunk (E, V, d3) times D_l3^T."""
    return _rotate(plan.irreps_out, out_rot, Ds, "eji,euj->eui")


# ----------------------------------------------------------------------
# the part between the rotations, plain PyTorch
# ----------------------------------------------------------------------

def _zonal_mids(plan: PackedTPPlan, x_rot):
    """Per input chunk its edge-frame mids (E, K * mul), lanes k * mul + u:
    the two-term static combinations of the rotated x."""
    E = x_rot.shape[0]
    ztab = get_zonal_spec(plan).tables(x_rot.device)
    mids = []
    for g, (sl, mul, d1, C, _groups) in enumerate(plan.per_chunk):
        K = C.shape[-1]
        if K == 0:
            mids.append(None)
            continue
        xr = x_rot[:, sl].reshape(E, mul, d1)
        i1, c1, i2, c2 = ztab[g]
        mid = xr[:, :, i1] * c1 + xr[:, :, i2] * c2       # (E, mul, K)
        mids.append(mid.transpose(1, 2).reshape(E, K * mul))
    return mids


def plain_zonal_core(plan: PackedTPPlan, x_rot, weight, flat_w, bf16: bool = False):
    """Edge-frame pipeline between the two rotations, plain PyTorch: the
    two-term static mids of the rotated x, the radial scale and the Wcat
    product.  x_rot (E, d_in), weight (E, n_ch) in packed order or None,
    flat_w (linear_numel,) -> out_rot (E, d_out), all float32, both in the
    plan's u-major layouts.  ``bf16``: the forward of ``HAMGNN_TP_BF16=all``,
    the Wcat product's operands rounded to bfloat16 (the mids are
    elementwise and stay fp32, as in ``pallas_zonal.py``)."""
    mids = _zonal_mids(plan, x_rot)
    if not any(m is not None for m in mids):
        return x_rot.new_zeros((x_rot.shape[0], plan.irreps_out.dim))
    return out_stage(plan, mids, weight, flat_w, bf16)


def plain_zonal_core_backward(plan: PackedTPPlan, x_rot, weight, flat_w, gout_rot,
                              bf16: bool = False):
    """Plain version of the core's backward (the VJP of the JAX package's
    ``_zpipeline``, ``ZonalPallasSpec._bwd_body``): the mids recomputed, the
    two transposed Wcat-stage products (their operands rounded to bfloat16
    with ``bf16``, the backward of ``HAMGNN_TP_BF16=bwd`` or ``all``), dw, and
    dx_rot through the static coefficients.  Returns (dx_rot, dw or None,
    d(flat_w)) for the output gradient ``gout_rot``."""
    with torch.no_grad():
        E = x_rot.shape[0]
        mids = _zonal_mids(plan, x_rot)
        dx = torch.zeros_like(x_rot)
        if not any(m is not None for m in mids):
            return dx, None if weight is None else torch.zeros_like(weight), \
                torch.zeros_like(flat_w)
        dmids, dw, dflat = out_stage_backward(plan, mids, weight, flat_w, gout_rot, bf16)
        ztab = get_zonal_spec(plan).tables(x_rot.device)
        for g, (sl, mul, d1, C, _groups) in enumerate(plan.per_chunk):
            if dmids[g] is None:
                continue
            K = C.shape[-1]
            i1, c1, i2, c2 = ztab[g]
            dm = dmids[g].reshape(E, K, mul).transpose(1, 2)   # (E, mul, K)
            dxr = x_rot.new_zeros((E, mul, d1))
            dxr.index_add_(2, i1, dm * c1)
            dxr.index_add_(2, i2, dm * c2)
            dx[:, sl] = dxr.reshape(E, mul * d1)
    return dx, dw, dflat


class PlainZonalCore(torch.autograd.Function):
    """``plain_zonal_core`` with ``plain_zonal_core_backward`` as its
    backward, each in the precision of a bf16 mode (``HAMGNN_TP_BF16``:
    ``"bwd"`` rounds the backward's products, ``"all"`` the forward's too);
    the CPU form of the zonal kernels under that mode."""

    @staticmethod
    def forward(ctx, x_rot, weight, flat_w, plan, bf16):
        ctx.plan, ctx.bf16 = plan, bf16 in ("bwd", "all")
        ctx.save_for_backward(x_rot, weight, flat_w)
        return plain_zonal_core(plan, x_rot, weight, flat_w, bf16 == "all")

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, gout):
        x_rot, weight, flat_w = ctx.saved_tensors
        dx, dw, dflat = plain_zonal_core_backward(ctx.plan, x_rot, weight, flat_w, gout,
                                                  ctx.bf16)
        return dx, dw, dflat, None, None


def zonal_apply(plan: PackedTPPlan, x, sh, weight, flat_w, bf16: str = ""):
    """Drop-in equivalent of ``plain_apply`` through the edge frame, plain
    PyTorch on any device: rotate the input chunks into the edge frame, run
    ``plain_zonal_core``, rotate the output chunks back.  ``sh`` receives no
    gradient.  ``bf16``: a mode of ``HAMGNN_TP_BF16`` for the core
    (``PlainZonalCore``)."""
    Ds = edge_frames(get_zonal_spec(plan), sh)
    x_rot = rotate_in(plan, x, Ds)
    if bf16:
        out_rot = PlainZonalCore.apply(x_rot, weight, flat_w, plan, bf16)
    else:
        out_rot = plain_zonal_core(plan, x_rot, weight, flat_w)
    return rotate_out(plan, out_rot, Ds)
