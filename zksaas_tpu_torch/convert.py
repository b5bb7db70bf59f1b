"""Carry the dealer's outputs between the JAX package and the port.

The JAX package keeps field elements as (..., K) uint32 arrays of 16-bit
limbs; the port keeps the same values in int32 tensors.  Every limb is
< 2^16, so the conversion is bit-equal both ways.  The functions here take
numpy arrays (or anything np.asarray accepts) and duck-typed dataclass
fields, so this module imports nothing of the JAX package: a test that
holds both can hand the same CRS, shares and masks to both.

  field arrays     to_torch / to_numpy
  point tuples     points_to_torch / points_to_numpy
  PackedProvingKeyShare, PackedQAPShare, FftMask, DegRedMask, MsmMask,
  PpBlind, ProveMasks
                   *_from / *_to_numpy (a dict of the dataclass's fields);
                   fft_masks_from for a list (libsnark_h's 7 masks)

The *_from functions read either a dataclass's attributes or the dicts the
*_to_numpy functions give, so one party's state (the `party(i)` of each
container) can cross a process boundary as numpy and come back.

The *_from functions take the circuit's scalar field spec (BN254, BLS12-381
or BLS12-377 Fr) and check every array's limb count against it: K limbs for
scalars, the curve's base field (16 or 24 limbs) for point coordinates.
Like every entry point of the port, they put their tensors on the card
unless the caller passes device="cpu" (device.resolve_device).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device
from .dist.deg_red import DegRedMask
from .dist.dfft import FftMask
from .dist.dmsm import MsmMask
from .dist.dpp import PpBlind
from .fields.spec import FIELDS
from .groth16.local import curve_family
from .groth16.prove import ProveMasks
from .groth16.proving_key import SHARED, PackedProvingKeyShare
from .groth16.qap import PackedQAPShare
from .ntt.domain import domain


def to_torch(a, device="cuda", nlimbs: int | None = None) -> torch.Tensor:
    """uint32 limb array -> int32 tensor (values < 2^16, so bit-equal);
    with `nlimbs`, the last axis must hold that many limbs."""
    arr = np.asarray(a)
    if arr.dtype != np.uint32:
        raise TypeError(f"expected uint32 limbs, got {arr.dtype}")
    if nlimbs is not None and (arr.ndim == 0 or arr.shape[-1] != nlimbs):
        raise ValueError(f"expected {nlimbs} limbs on the last axis, got shape {arr.shape}")
    if arr.size and int(arr.max()) >> 16:
        raise ValueError("limbs must be < 2^16")
    return torch.from_numpy(arr.astype(np.int32)).to(resolve_device(device))


def to_numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.uint32)


def points_to_torch(P, device="cuda", nlimbs: int | None = None) -> tuple:
    return tuple(to_torch(c, device, nlimbs) for c in P)


def points_to_numpy(P) -> tuple:
    return tuple(to_numpy(c) for c in P)


def _get(src, k):
    return src[k] if isinstance(src, dict) else getattr(src, k)


_CRS_CLEAR = ("a_query0", "b_g1_query0", "b_g2_query0", "delta_g1", "delta_g2",
              "alpha_g1", "beta_g1", "beta_g2")


def _fq_limbs(spec) -> int:
    """Limbs of a point coordinate on the curve whose scalar field is spec."""
    return FIELDS[f"{curve_family(spec)}_fq"].nlimbs


def crs_from(src, spec, device="cuda") -> PackedProvingKeyShare:
    kw = {k: points_to_torch(_get(src, k), device, _fq_limbs(spec)) for k in SHARED}
    kw.update({k: _get(src, k) for k in _CRS_CLEAR})
    return PackedProvingKeyShare(**kw)


def crs_to_numpy(crs: PackedProvingKeyShare) -> dict:
    out = {k: points_to_numpy(getattr(crs, k)) for k in SHARED}
    out.update({k: getattr(crs, k) for k in _CRS_CLEAR})
    return out


def qap_from(src, spec, device="cuda") -> PackedQAPShare:
    """src: a, b, c (n, m/l, K) arrays (or one party's (m/l, K)),
    num_inputs, num_constraints and the domain size: src.dom.n, or m in a
    dict of qap_to_numpy."""
    k = spec.nlimbs
    return PackedQAPShare(
        num_inputs=_get(src, "num_inputs"),
        num_constraints=_get(src, "num_constraints"),
        a=to_torch(_get(src, "a"), device, k),
        b=to_torch(_get(src, "b"), device, k),
        c=to_torch(_get(src, "c"), device, k),
        dom=domain(spec, src["m"] if isinstance(src, dict) else src.dom.n),
    )


def qap_to_numpy(q: PackedQAPShare) -> dict:
    return dict(num_inputs=q.num_inputs, num_constraints=q.num_constraints,
                a=to_numpy(q.a), b=to_numpy(q.b), c=to_numpy(q.c), m=q.dom.n)


def fft_mask_from(src, spec, device="cuda") -> FftMask:
    k = spec.nlimbs
    return FftMask(to_torch(_get(src, "in_mask"), device, k),
                   to_torch(_get(src, "out_mask"), device, k))


def fft_masks_from(srcs, spec, device="cuda") -> list:
    """A list of FftMasks, as libsnark_masks and circom_masks return them."""
    return [fft_mask_from(m, spec, device) for m in srcs]


def degred_mask_from(src, spec, device="cuda") -> DegRedMask:
    k = spec.nlimbs
    return DegRedMask(to_torch(_get(src, "in_mask"), device, k),
                      to_torch(_get(src, "out_mask"), device, k))


def pp_blind_from(src, spec, device="cuda") -> PpBlind:
    k = spec.nlimbs
    return PpBlind(to_torch(_get(src, "num"), device, k), to_torch(_get(src, "den"), device, k))


def msm_mask_from(src, spec, device="cuda") -> MsmMask:
    k = _fq_limbs(spec)
    return MsmMask(points_to_torch(_get(src, "in_mask"), device, k),
                   points_to_torch(_get(src, "out_mask"), device, k))


def prove_masks_from(src, spec, device="cuda") -> ProveMasks:
    return ProveMasks(
        fft_masks=fft_masks_from(_get(src, "fft_masks"), spec, device),
        degred_mask=degred_mask_from(_get(src, "degred_mask"), spec, device),
        g1_msm_masks=[msm_mask_from(m, spec, device) for m in _get(src, "g1_msm_masks")],
        g2_msm_mask=msm_mask_from(_get(src, "g2_msm_mask"), spec, device),
    )


def mask_to_numpy(mask) -> dict:
    """FftMask, DegRedMask, MsmMask or PpBlind -> its fields as numpy."""
    conv = points_to_numpy if isinstance(mask, MsmMask) else to_numpy
    return {f.name: conv(getattr(mask, f.name)) for f in dataclasses.fields(mask)}


def prove_masks_to_numpy(masks: ProveMasks) -> dict:
    return dict(
        fft_masks=[mask_to_numpy(m) for m in masks.fft_masks],
        degred_mask=mask_to_numpy(masks.degred_mask),
        g1_msm_masks=[mask_to_numpy(m) for m in masks.g1_msm_masks],
        g2_msm_mask=mask_to_numpy(masks.g2_msm_mask),
    )
