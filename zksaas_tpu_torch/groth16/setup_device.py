"""Device-accelerated circuit-specific setup.

Port of zksaas_tpu/groth16/setup_device.py.  setup() in local.py computes
every CRS point with host big-int scalar muls, far too slow for the SHA-256
fixture (~200k G1 + ~30k G2 points).  Here the scalars of every query are
derived on the host and the points are produced on the device with the
windowed fixed-base mul (64 point adds each, kernel 2), then det-packed
into CRS shares without leaving the device: ark-groth16's generator uses
FixedBase::msm tables for the same job.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from ..circom.r1cs import R1CS
from ..curves.curve import JCurve
from ..curves.fixed_base import fixed_base_mul
from ..device import resolve_device
from ..ntt.ref import ifft_ref
from ..pss.pss import PackedSharingParams
from .local import Groth16Keys, _domain_size, _lagrange_coeffs_at
from .proving_key import PackedProvingKeyShare


@dataclass
class SetupScalars:
    """All CRS scalars (host ints); points not yet materialized."""

    spec: object
    reduction: str
    alpha: int
    beta: int
    gamma: int
    delta: int
    a_t: list[int]
    b_t: list[int]
    h_scalars: list[int]
    l_scalars: list[int]
    gamma_abc: list[int]
    m: int


def setup_scalars(r1cs: R1CS, rng: random.Random, reduction: str = "circom") -> SetupScalars:
    spec = r1cs.spec
    p = spec.p
    m = _domain_size(r1cs.num_constraints + r1cs.num_instance)
    alpha = rng.randrange(1, p)
    beta = rng.randrange(1, p)
    gamma = rng.randrange(1, p)
    delta = rng.randrange(1, p)
    tau = rng.randrange(1, p)

    u = _lagrange_coeffs_at(spec, m, tau)
    nv = r1cs.num_vars
    a_t = [0] * nv
    b_t = [0] * nv
    c_t = [0] * nv
    for r in range(r1cs.num_constraints):
        for coeff, v in r1cs.a[r]:
            a_t[v] = (a_t[v] + coeff * u[r]) % p
        for coeff, v in r1cs.b[r]:
            b_t[v] = (b_t[v] + coeff * u[r]) % p
        for coeff, v in r1cs.c[r]:
            c_t[v] = (c_t[v] + coeff * u[r]) % p
    for i in range(r1cs.num_instance):
        a_t[i] = (a_t[i] + u[r1cs.num_constraints + i]) % p

    zt = (pow(tau, m, p) - 1) % p
    gamma_inv = pow(gamma, -1, p)
    delta_inv = pow(delta, -1, p)
    gamma_abc = [
        (beta * a_t[i] + alpha * b_t[i] + c_t[i]) * gamma_inv % p
        for i in range(r1cs.num_instance)
    ]
    l_scalars = [
        (beta * a_t[i] + alpha * b_t[i] + c_t[i]) * delta_inv % p
        for i in range(r1cs.num_instance, nv)
    ]
    if reduction == "libsnark":
        h_scalars = [zt * delta_inv % p * pow(tau, i, p) % p for i in range(m - 1)]
    else:
        max_power = m - 1
        scal = [delta_inv * pow(tau, i, p) % p for i in range(2 * max_power + 1)]
        d2 = _domain_size(len(scal))
        scal = scal + [0] * (d2 - len(scal))
        h_scalars = ifft_ref(spec, scal)[1::2]
    return SetupScalars(
        spec=spec,
        reduction=reduction,
        alpha=alpha,
        beta=beta,
        gamma=gamma,
        delta=delta,
        a_t=a_t,
        b_t=b_t,
        h_scalars=h_scalars,
        l_scalars=l_scalars,
        gamma_abc=gamma_abc,
        m=m,
    )


def vk_from_scalars(ss: SetupScalars) -> Groth16Keys:
    """Host materialization of the (small) verifying key plus the clear
    pk elements; the big queries stay device-side (see
    pack_proving_key_device) and are left empty here."""
    from .local import curve_refs

    G1, G2, _ = curve_refs(ss.spec)
    g1 = lambda x: G1.mul(G1.gen, x)
    g2 = lambda x: G2.mul(G2.gen, x)
    return Groth16Keys(
        spec=ss.spec,
        reduction=ss.reduction,
        alpha_g1=g1(ss.alpha),
        beta_g2=g2(ss.beta),
        gamma_g2=g2(ss.gamma),
        delta_g2=g2(ss.delta),
        gamma_abc_g1=[g1(x) for x in ss.gamma_abc],
        beta_g1=g1(ss.beta),
        delta_g1=g1(ss.delta),
        a_query=[g1(ss.a_t[0])],  # only the clear element
        b_g1_query=[g1(ss.b_t[0])],
        b_g2_query=[g2(ss.b_t[0])],
        h_query=[],
        l_query=[],
    )


def _query_shares(pp: PackedSharingParams, curve: JCurve, scalars: list[int], device):
    """scalars -> det-packed party-major point shares (n, nch).

    The dealer knows the discrete logs, so packing commutes with
    exponentiation: det_pack the scalars (a field mat-vec) and then one
    fixed-base mul per share.  Tail chunks are padded with zero scalars
    (infinity points)."""
    l = pp.l
    nch = -(-len(scalars) // l)
    padded = list(scalars) + [0] * (nch * l - len(scalars))
    enc = pp.F.encode(padded, device).reshape(nch, l, pp.F.k)
    share_scalars = pp.det_pack(enc)  # (nch, n, K)
    pts = fixed_base_mul(curve, share_scalars)  # (nch, n) Jacobian
    return tuple(c.transpose(0, 1).contiguous() for c in pts)


def pack_proving_key_device(ss: SetupScalars, vk: Groth16Keys, pp: PackedSharingParams,
                            g1: JCurve, g2: JCurve, device="cuda") -> PackedProvingKeyShare:
    """Full CRS share packing with device point generation."""
    dev = resolve_device(device)
    return PackedProvingKeyShare(
        s=_query_shares(pp, g1, ss.a_t[1:], dev),
        u=_query_shares(pp, g1, ss.h_scalars, dev),
        w=_query_shares(pp, g1, ss.l_scalars, dev),
        h=_query_shares(pp, g1, ss.b_t[1:], dev),
        v=_query_shares(pp, g2, ss.b_t[1:], dev),
        a_query0=vk.a_query[0],
        b_g1_query0=vk.b_g1_query[0],
        b_g2_query0=vk.b_g2_query[0],
        delta_g1=vk.delta_g1,
        delta_g2=vk.delta_g2,
        alpha_g1=vk.alpha_g1,
        beta_g1=vk.beta_g1,
        beta_g2=vk.beta_g2,
    )
