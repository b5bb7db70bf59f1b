"""The port's NTT domains, packed sharing and distributed primitives.

Domain fft/ifft and PSS pack/unpack are held against the JAX package on the
same inputs (numpy-seeded; the pads are made once and handed to both).
d_fft, d_ifft, deg_red and d_msm run over the port's LocalNet(8) at m = 32
and their unpacked results are held against the host oracles (ntt/ref.py,
curves/ref.py), which do not depend on the masks or pads.  Tolerance:
exact equality.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zksaas_tpu.fields import BN254_FR as J_FR
from zksaas_tpu.ntt import domain as jdomain
from zksaas_tpu.pss import pss as jpss
from zksaas_tpu_torch import convert
from zksaas_tpu_torch.comm.net import LocalNet
from zksaas_tpu_torch.curves.curve import curve_g1
from zksaas_tpu_torch.curves.fixed_base import fixed_base_mul
from zksaas_tpu_torch.dist.deg_red import DegRedMask, deg_red
from zksaas_tpu_torch.dist.dfft import FftMask, d_fft, d_ifft
from zksaas_tpu_torch.dist.dmsm import MsmMask, d_msm
from zksaas_tpu_torch.fields.spec import BN254_FR
from zksaas_tpu_torch.ntt.domain import domain
from zksaas_tpu_torch.ntt.ref import fft_ref, ifft_ref
from zksaas_tpu_torch.pss.pss import pss
from zksaas_tpu_torch.utils.pack import rearrange_perm, stride_chunks, unstride_chunks
from zksaas_tpu_torch.utils.rng import generator, split

from test_torch_heap import release_heap  # noqa: F401  (autouse)

torch.set_num_threads(1)

SPEC = BN254_FR
P = SPEC.p
M = 32
DEV = "cpu"


def _ints(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


@pytest.fixture(scope="module")
def pp():
    return pss(SPEC, 2)


@pytest.mark.parametrize("n,offset,inverse", [(8, 5, False), (16, 1, True)])
def test_domain_matches_jax(n, offset, inverse):
    jd, td = jdomain(J_FR, n, offset), domain(SPEC, n, offset)
    x = td.F.encode_np(np.asarray(_ints(3 * n, n + offset), dtype=object).reshape(3, n))
    op = "ifft" if inverse else "fft"
    want = np.asarray(getattr(jd, op)(jnp.asarray(x)))
    np.testing.assert_array_equal(convert.to_numpy(getattr(td, op)(convert.to_torch(x))), want)


@pytest.mark.parametrize("op", ["pack", "det_pack", "unpack", "unpack2", "lagrange_unpack"])
def test_pss_matches_jax(pp, op):
    jp = jpss(J_FR, 2)
    F = pp.F
    if op in ("pack", "det_pack"):
        sec = F.encode_np(np.asarray(_ints(10, 1), dtype=object).reshape(5, 2))
        pads = F.encode_np(np.asarray(_ints(10, 2), dtype=object).reshape(5, 2))
        args = (sec, pads) if op == "pack" else (sec,)
        want = getattr(jp, op)(*map(jnp.asarray, args))
        got = getattr(pp, op)(*map(convert.to_torch, args))
    else:
        sh = F.encode_np(np.asarray(_ints(40, 3), dtype=object).reshape(5, 8))
        if op == "lagrange_unpack":
            keep = (0, 1, 2, 4, 5, 6, 7)
            want = jp.lagrange_unpack(jnp.asarray(sh[:, keep]), keep)
            got = pp.lagrange_unpack(convert.to_torch(sh[:, keep]), keep)
        else:
            want = getattr(jp, op)(jnp.asarray(sh))
            got = getattr(pp, op)(convert.to_torch(sh))
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("op", ["det_pack", "pack"])
def test_point_packing_equals_packing_the_dlogs(pp, op):
    """Packing points in the exponent (JCurve.matvec) gives the same group
    elements as packing their discrete logs and one fixed-base mul per
    share, the two ways the port's dealer packs points."""
    C = curve_g1()
    F = pp.F
    enc = F.encode(_ints(2 * pp.l, 20), DEV).reshape(2, pp.l, F.k)
    pads = F.encode(_ints(2 * pp.t, 22), DEV).reshape(2, pp.t, F.k)
    args = (enc, pads) if op == "pack" else (enc,)
    by_points = getattr(pp, op + "_g")(C, *(fixed_base_mul(C, a) for a in args))  # (2, n)
    by_scalars = fixed_base_mul(C, getattr(pp, op)(*args))  # (2, n)
    assert C.decode(by_points) == C.decode(by_scalars)
    x = F.encode(_ints(M, 21), DEV)
    assert torch.equal(unstride_chunks(stride_chunks(x, pp.l)), x)


def pack_rearranged(pp, vals, rng):
    """Rearrange, stride-chunk, pack (tests.rs:29-39): (n, m/l, K) shares."""
    m = len(vals)
    x = pp.F.encode(vals, DEV)[torch.from_numpy(rearrange_perm(m))]
    shares = pp.pack(stride_chunks(x, pp.l), pp.rand_pads(rng, (m // pp.l,), DEV))
    return shares.transpose(0, 1)


def unpack_natural(pp, shares, parties=None):
    sh = shares.transpose(0, 1)  # (m/l, n, K)
    if parties is None:
        secrets = pp.unpack(sh)
    else:
        secrets = pp.lagrange_unpack(sh[:, list(parties)], tuple(parties))
    return list(pp.F.decode(secrets.reshape(-1, pp.F.k)))


@pytest.mark.parametrize("drop", [(), (5,)], ids=["all", "lossy"])
def test_d_fft_and_d_ifft_match_host_ntt(pp, drop):
    dom = domain(SPEC, M)
    vals = _ints(M, 11)
    k = split(generator(12), 6)
    net = LocalNet(pp.n, drop=drop)
    keep = None if not drop else net.parties
    shares = pack_rearranged(pp, vals, k[0])
    out = d_fft(pp, shares, FftMask.sample(False, 1, dom.group_gen, M, pp, k[1], DEV),
                False, dom, net, k[2])
    assert unpack_natural(pp, out, keep) == fft_ref(SPEC, vals)
    out = d_ifft(pp, shares, FftMask.sample(False, 1, dom.group_gen_inv, M, pp, k[3], DEV),
                 False, dom, 1, net, k[4])
    assert unpack_natural(pp, out, keep) == ifft_ref(SPEC, vals)
    assert net.rounds == 2


def test_coset_chain_recovers_input(pp):
    """d_ifft (rearrange, coset) -> d_fft (rearrange) -> back (tests.rs:223-357)."""
    dom = domain(SPEC, M)
    coset = dom.get_coset(SPEC.generator)
    vals = _ints(M, 13)
    ks = split(generator(14), 9)
    shares = pack_rearranged(pp, vals, ks[0])
    masks = [
        FftMask.sample(True, coset.offset, dom.group_gen_inv, M, pp, ks[1], DEV),
        FftMask.sample(True, 1, coset.group_gen, M, pp, ks[2], DEV),
        FftMask.sample(True, coset.offset_inv, dom.group_gen_inv, M, pp, ks[3], DEV),
        FftMask.sample(False, 1, coset.group_gen, M, pp, ks[4], DEV),
    ]
    net = LocalNet(pp.n)
    p1 = d_ifft(pp, shares, masks[0], True, dom, coset.offset, net, ks[5])
    ce = d_fft(pp, p1, masks[1], True, dom, net, ks[6])
    p2 = d_ifft(pp, ce, masks[2], True, dom, coset.offset_inv, net, ks[7])
    out = d_fft(pp, p2, masks[3], False, dom, net, ks[8])
    assert unpack_natural(pp, out) == vals


@pytest.mark.parametrize("drop", [(), (7,)], ids=["all", "lossy"])
def test_deg_red_matches_host(pp, drop):
    F = pp.F
    num = M // pp.l
    secrets = _ints(num * pp.l, 15)
    k = split(generator(16), 3)
    sh = pp.pack(F.encode(secrets, DEV).reshape(num, pp.l, F.k), pp.rand_pads(k[0], (num,), DEV))
    x_share = F.mul(sh, sh).transpose(0, 1)  # degree doubled, (n, num, K)
    net = LocalNet(pp.n, drop=drop)
    out = deg_red(pp, x_share, DegRedMask.sample(pp, num, k[1], DEV), net, k[2])
    keep = net.parties if drop else None
    assert unpack_natural(pp, out, keep) == [x * x % P for x in secrets]


@pytest.mark.parametrize("drop", [(), (2,)], ids=["all", "lossy"])
def test_d_msm_matches_host_msm(pp, drop):
    """dmsm_test.rs at m = 32; bases are gen * k_i, packed as the dealer
    packs the CRS (det_pack the dlogs, one fixed-base mul per share)."""
    C = curve_g1()
    F = pp.F
    dl = _ints(M, 17)
    scal = _ints(M, 18)
    k = split(generator(19), 2)
    nch = M // pp.l
    base_sh = pp.det_pack(F.encode(dl, DEV).reshape(nch, pp.l, F.k))  # (nch, n, K)
    bases = tuple(c.transpose(0, 1) for c in fixed_base_mul(C, base_sh))  # (n, nch)
    fsh = pp.pack(F.encode(scal, DEV).reshape(nch, pp.l, F.k), pp.rand_pads(k[0], (nch,), DEV))
    net = LocalNet(pp.n, drop=drop)
    out = d_msm(pp, C, bases, fsh.transpose(0, 1), MsmMask.sample(pp, C, k[1], DEV), net)
    secrets = pp.unpack2_g(C, tuple(c[None] for c in out))  # (1, l)
    got = C.decode(secrets)
    want = C.ref.mul(C.ref.gen, sum(a * b for a, b in zip(dl, scal)) % C.order)
    assert got == [want] * pp.l


def test_local_net_counts_rounds_and_elements():
    net = LocalNet(4, drop=(1,))
    x = (torch.zeros(4, 3, 2, dtype=torch.int32), torch.ones(4, 5, dtype=torch.int32))
    seen = net.round(x, lambda xs, parties: (xs, parties))
    assert seen[1] == (0, 2, 3) and seen[0][0].shape == (3, 3, 2)
    assert net.rounds == 1 and net.gathered_elems == 24 + 20
