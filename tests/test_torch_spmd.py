"""The port's SPMD path, held against the JAX package on the CPU.

SpmdNet (comm/net.py) runs every party as a rank of a torch.distributed
gloo group, spawned as processes of their own (the targets live in
tests/test_torch_spmd_worker.py, which imports no JAX); the analog of the
JAX package's 8-device virtual CPU mesh (tests/test_spmd.py).

* The host tables of the sharded fft2 (dist/dfft.py: `_fft2_chunk_mats`,
  `_fft2_mats_enc`, `_sharded_fft_tables`) equal the JAX package's
  exactly, up to the flagship's (m, l, n) = (2^16, 2, 8).
* The cases of tests/test_spmd.py over 8 ranks (n = 8, l = 2, BN254 Fr):
  d_ifft on the king path and on the sharded path, d_fft on the sharded
  path over an a/b/c batch, deg_red on both paths, d_msm.  The shares of
  every rank equal the port's LocalNet shares bit for bit, from the same
  generator seeds; the unpacked values equal the host oracles of the JAX
  package (ifft_ref, fft_ref, C.ref.msm); the counters name the path
  taken.  The fft and deg_red masks are the JAX dealer's, through
  convert.py; d_msm's is the port's MsmMask (the JAX one compiles the G1
  fixed-base and point mat-vec on XLA:CPU, the memory the whole test run is
  short of).
* The whole prove (spmd_prove.prove_spmd, n = 4, l = 1, 4 ranks) on the
  circuit of tests/test_torch_host_net.py: the proof equals the JAX
  local_prove's for the same keys, r and s, and verifies; both sharded
  paths ran; every rank exited 0.

Each of the last two spawns its ranks once.  Tolerance: exact equality.
"""

import datetime
import multiprocessing as mp
import random

import jax
import numpy as np
import torch
import torch.distributed as dist

from zksaas_tpu.circom import ConstraintBuilder as JConstraintBuilder
from zksaas_tpu.curves import curve_g1 as j_curve_g1
from zksaas_tpu.dist import DegRedMask as JDegRedMask
from zksaas_tpu.dist import FftMask as JFftMask
from zksaas_tpu.dist import dfft as jdfft
from zksaas_tpu.fields import BN254_FR as J_FR
from zksaas_tpu.groth16 import local as jlocal
from zksaas_tpu.ntt import domain as jdomain
from zksaas_tpu.ntt import fft_ref as j_fft_ref
from zksaas_tpu.ntt import ifft_ref as j_ifft_ref
from zksaas_tpu.pss import pss as jpss
from zksaas_tpu_torch import convert, spmd_prove
from zksaas_tpu_torch.circom.r1cs import ConstraintBuilder
from zksaas_tpu_torch.comm.net import LocalNet
from zksaas_tpu_torch.curves.curve import curve_g1, curve_g2
from zksaas_tpu_torch.curves.fixed_base import fixed_base_mul
from zksaas_tpu_torch.dist import dfft
from zksaas_tpu_torch.dist.dmsm import MsmMask
from zksaas_tpu_torch.fields.spec import BN254_FR
from zksaas_tpu_torch.groth16.local import Proof, verify
from zksaas_tpu_torch.groth16.prove import ProveMasks, pack_scalar_repeated, pack_witness
from zksaas_tpu_torch.groth16.qap import qap_pack
from zksaas_tpu_torch.groth16.setup_device import (
    pack_proving_key_device,
    setup_scalars,
    vk_from_scalars,
)
from zksaas_tpu_torch.pss.pss import pss
from zksaas_tpu_torch.utils.pack import rearrange_perm, stride_chunks, unstride_chunks
from zksaas_tpu_torch.utils.rng import generator, split

from test_torch_heap import release_heap  # noqa: F401  (autouse)
from test_torch_host_net import _circuit
from test_torch_spmd_worker import run_case, run_rank

torch.set_num_threads(1)
DEV = "cpu"
SPEC = BN254_FR
P = SPEC.p
L = 2
N = 4 * L


def test_sharded_tables_match_jax():
    """The sharded fft2's host tables, both rearranges, from m = 64 to the
    flagship's 2^16, with l = 1 (the prove test's) and l = 4 besides."""
    for m, l, n in ((64, 2, 8), (8, 1, 4), (256, 4, 16), (1 << 16, 2, 8)):
        for rearrange in (False, True):
            got = dfft._sharded_fft_tables(m, l, n, rearrange)
            want = jdfft._sharded_fft_tables(m, l, n, rearrange)
            for g, w, what in zip(got, want, ("gather_idx", "k_of", "recv_perm")):
                np.testing.assert_array_equal(g, w, err_msg=f"{what} m={m} l={l} {rearrange}")
        dom = jdomain(J_FR, m)
        for gen in (dom.group_gen, dom.group_gen_inv):
            assert dfft._fft2_chunk_mats(SPEC, m, l, gen) == jdfft._fft2_chunk_mats(J_FR, m, l, gen)
            if m <= 256:
                np.testing.assert_array_equal(dfft._fft2_mats_enc(SPEC, m, l, gen),
                                              jdfft._fft2_mats_enc(J_FR, m, l, gen))


def _ints(n, rng):
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def _jmask(mask):
    return {k: np.asarray(v) for k, v in (("in_mask", mask.in_mask), ("out_mask", mask.out_mask))}


def _rearranged_shares(pp, vals, seed):
    """Packed shares (n, m/l, K) of vals in the rearranged layout."""
    m = len(vals)
    x = pp.F.encode(vals, DEV)[torch.from_numpy(rearrange_perm(m))]
    sh = pp.pack(stride_chunks(x, pp.l), pp.rand_pads(generator(seed), (m // pp.l,), DEV))
    return convert.to_numpy(sh.transpose(0, 1))


def _unpacked(pp, shares, rearrange=False):
    """(n, ..., m/l, K) shares -> the vector of the unpacked secrets, in
    natural order (undoing the rearranged layout), as Python ints."""
    sec = pp.unpack(torch.from_numpy(shares.astype(np.int32)).movedim(0, -2))  # (..., m/l, l, K)
    if rearrange:
        v = unstride_chunks(sec)
        v = v[..., torch.from_numpy(rearrange_perm(v.shape[-2])), :]
    else:
        v = sec.reshape(sec.shape[:-3] + (-1, pp.F.k))
    return pp.F.decode(v).tolist()


def _cases(pp):
    """The cases of tests/test_spmd.py, with their oracles."""
    jpp = jpss(J_FR, L)
    rng = np.random.default_rng(65)
    keys = iter(jax.random.split(jax.random.PRNGKey(75), 16))
    cases, oracle = {}, {}
    for name, m, rearrange, g in (("ifft_king", 16, False, 1), ("ifft_sharded", 64, False, 5),
                                  ("ifft_sharded_rearranged", 64, True, 1)):
        evals = _ints(m, rng)
        dom = jdomain(J_FR, m)
        jm = JFftMask.sample(rearrange, g, dom.group_gen_inv, m, jpp, next(keys))
        cases[name] = dict(op="ifft", l=L, m=m, rearrange=rearrange, g=g, seed=m + g,
                           shares=_rearranged_shares(pp, evals, 71), mask=_jmask(jm))
        oracle[name] = [c * pow(g, i, P) % P for i, c in enumerate(j_ifft_ref(J_FR, evals))]
    # d_fft over an a/b/c batch: (n, 3, m/l, K), as circom_h sends it
    m = 64
    dom = jdomain(J_FR, m)
    coeffs = [_ints(m, rng) for _ in range(3)]
    jms = [JFftMask.sample(False, 1, dom.group_gen, m, jpp, next(keys)) for _ in range(3)]
    cases["fft_sharded"] = dict(
        op="fft", l=L, m=m, rearrange=False, g=1, seed=72,
        shares=np.stack([_rearranged_shares(pp, c, 73 + i) for i, c in enumerate(coeffs)], 1),
        mask={k: np.stack([_jmask(j)[k] for j in jms], 1) for k in ("in_mask", "out_mask")})
    oracle["fft_sharded"] = [j_fft_ref(J_FR, c) for c in coeffs]
    for name, num in (("deg_red_sharded", N), ("deg_red_king", 1)):
        secrets = _ints(num * L, rng)
        sh = pp.pack(pp.F.encode(secrets, DEV).reshape(num, L, pp.F.k),
                     pp.rand_pads(generator(num), (num,), DEV))
        x = pp.F.mul(sh, sh).transpose(0, 1)  # degree-doubled (n, num, K)
        cases[name] = dict(op="deg_red", l=L, seed=74 + num, shares=convert.to_numpy(x),
                           mask=_jmask(JDegRedMask.sample(jpp, num, next(keys))))
        oracle[name] = [v * v % P for v in secrets]
    # d_msm of 8 G1 points gen * dl_i, packed as the dealer packs the CRS
    C, JC = curve_g1(), j_curve_g1()
    dl, scal = _ints(8, rng), _ints(8, rng)
    nch = 8 // L
    base_sh = pp.det_pack(pp.F.encode(dl, DEV).reshape(nch, L, pp.F.k))
    bases = tuple(convert.to_numpy(c.transpose(0, 1)) for c in fixed_base_mul(C, base_sh))
    fsh = pp.pack(pp.F.encode(scal, DEV).reshape(nch, L, pp.F.k),
                  pp.rand_pads(generator(76), (nch,), DEV))
    mk = MsmMask.sample(pp, C, generator(77), DEV)
    cases["msm"] = dict(op="msm", l=L, seed=78, bases=bases,
                        scalars=convert.to_numpy(fsh.transpose(0, 1)),
                        mask={k: convert.points_to_numpy(getattr(mk, k))
                              for k in ("in_mask", "out_mask")})
    oracle["msm"] = JC.ref.msm([JC.ref.mul(JC.ref.gen, d) for d in dl], scal)
    return cases, oracle


def _spawn_ranks(target, n, payload, timeout=300.0):
    """n ranks of `target(rank, n, port, conn)` on a store held here; each
    gets `payload` and sends back one object.  Returns them in rank order."""
    store = dist.TCPStore("127.0.0.1", 0, n, True, timeout=datetime.timedelta(seconds=timeout),
                          wait_for_workers=False)
    ctx = mp.get_context("spawn")
    pipes = [ctx.Pipe() for _ in range(n)]
    procs = [ctx.Process(target=target, args=(i, n, store.port, pipes[i][1]), daemon=True)
             for i in range(n)]
    try:
        for p in procs:
            p.start()
        for mine, theirs in pipes:
            theirs.close()
            mine.send(payload)
        out = []
        for mine, _ in pipes:
            assert mine.poll(timeout), "a rank sent no result"
            out.append(mine.recv())
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    assert [p.exitcode for p in procs] == [0] * n, "rank exit codes"
    return out


_PATH = {
    "gather": [("all_gather", "gather")],
    "fft": [("all_to_all", "fft"), ("shift", "fft"), ("all_to_all", "fft")],
    "deg_red": [("all_to_all", "deg_red")] * 2,
}


def test_spmd_primitives_match_jax():
    pp = pss(SPEC, L)
    cases, oracle = _cases(pp)
    ranks = _spawn_ranks(run_rank, N, cases)
    C = curve_g1()
    for name, case in cases.items():
        local = run_case(case, LocalNet(N))
        if case["op"] == "msm":
            got = tuple(np.stack([r[name]["share"][i] for r in ranks]) for i in range(3))
            for g, w in zip(got, local):
                np.testing.assert_array_equal(g, w, err_msg=f"{name}: SpmdNet against LocalNet")
            secrets = pp.unpack2_g(C, tuple(torch.from_numpy(c.astype(np.int32))[None]
                                            for c in got))
            assert C.decode(secrets) == [oracle[name]] * L, name
            want_ops = _PATH["gather"] * 3  # one all_gather a coordinate
        else:
            got = np.stack([r[name]["share"] for r in ranks])
            np.testing.assert_array_equal(got, local, err_msg=f"{name}: SpmdNet against LocalNet")
            assert _unpacked(pp, got, case.get("rearrange", False)) == oracle[name], name
            path = "gather" if name.endswith("king") else case["op"].replace("ifft", "fft")
            want_ops = _PATH[path]
        for r in ranks:
            assert r[name]["ops"] == want_ops, f"{name}: the path taken"
            assert r[name]["stats"]["rounds"] == 1, name


def test_spmd_prove_equals_local_prove():
    """The whole prove over 4 gloo ranks on the CPU (n = 4, l = 1)."""
    jr1cs, jz = _circuit(JConstraintBuilder, J_FR)
    rng = random.Random(321)
    keys = jlocal.setup(jr1cs, rng, reduction="circom")
    r, s = rng.randrange(J_FR.p), rng.randrange(J_FR.p)
    expected = jlocal.local_prove(keys, jr1cs, jz, r, s)

    r1cs, z = _circuit(ConstraintBuilder, BN254_FR)
    ss = setup_scalars(r1cs, random.Random(321), reduction="circom")
    vk = vk_from_scalars(ss)
    pp = pss(BN254_FR, 1)
    g1, g2 = curve_g1(), curve_g2()
    ks = split(generator(888), 6)
    q = qap_pack(pp, r1cs, z, ks[0], DEV)
    res = spmd_prove.prove_spmd(
        pp, g1, g2, pack_proving_key_device(ss, vk, pp, g1, g2, device=DEV), q,
        pack_witness(pp, z[1:], ks[1], DEV), pack_witness(pp, z[r1cs.num_instance :], ks[2], DEV),
        pack_scalar_repeated(pp, r, ks[3], DEV), pack_scalar_repeated(pp, s, ks[4], DEV),
        ProveMasks.sample(pp, g1, g2, q.dom.n, ks[5], DEV), 7, "gloo", device=DEV,
        timeout=300.0)
    sa, sb, sc = res["shares"]
    a = g1.decode(tuple(c[:1] for c in pp.unpack2_g(g1, sa)))[0]
    b = g2.decode(tuple(c[:1] for c in pp.unpack2_g(g2, sb)))[0]
    c = g1.decode(tuple(c[:1] for c in pp.unpack2_g(g1, sc)))[0]
    assert (a, b, c) == (expected.a, expected.b, expected.c)
    assert verify(vk, z[1 : r1cs.num_instance], Proof(a=a, b=b, c=c))
    assert res["exitcodes"] == [0] * (pp.n - 1)
    # both sharded paths on every rank: 2 fft rounds and deg_red as
    # all_to_all pairs, 5 msm rounds and the collection as all_gathers
    kinds = [(e["round"], e["kind"], e["op"]) for e in res["rounds"]]
    assert [k for k in kinds if k[1] != "gather"] == [
        (1, "fft", "all_to_all"), (1, "fft", "shift"), (1, "fft", "all_to_all"),
        (2, "fft", "all_to_all"), (2, "fft", "shift"), (2, "fft", "all_to_all"),
        (3, "deg_red", "all_to_all"), (3, "deg_red", "all_to_all")]
    assert {k[0] for k in kinds if k[1] == "gather"} == set(range(4, 10))
    for st in res["stats"]:
        assert (st["rounds"], st["all_to_all"], st["shift"]) == (9, 6, 2)
        assert st["all_gather"] > 0 and st["bytes_out"] == st["bytes_in"] > 0
