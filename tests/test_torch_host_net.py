"""The port's deployment transport, held against the JAX package on the CPU.

* The TCP star (comm/star.py) against zksaas_tpu/comm/star.py, both ways:
  a port king with JAX clients and a JAX king with port clients, in
  threads, through the scenarios of tests/test_star_tls.py (add-ids over
  plain TCP and over mTLS, a dropped party giving a Partial gather, too few
  responses raising).  The byte layer needs no JAX compile.
* The round journal (comm/journal.py) through the scenarios of
  tests/test_journal.py, on the port's d_ifft then deg_red over LocalNet(8)
  from the JAX dealer's shares and masks (convert.py): transparent, a full
  replay that never reaches the network, a resume that runs only the
  missing round, a torn record ignored.  The unpacked outputs equal the JAX
  protocol's bit for bit (the shares themselves carry each king's pads).
* HostStarNet across processes (tests/test_host_net.py): deg_red over
  n = 4 with 3 spawned client processes (tests/test_torch_host_worker.py),
  lossless and with one silent party, then the journal's resume across
  processes; the unpacked secret is 49, and the king's share equals the
  port's LocalNet result on the same shares.
* The slice as a whole (tests/test_host_prove.py): host_prove.prove_king on
  the CPU with 3 spawned client parties (n = 4, l = 1); the unpacked proof
  equals zksaas_tpu.groth16.local.local_prove for the same keys, r and s
  and verifies.

The scenarios of each share one test (the number of tests collected sets
the chunks pytest-xdist hands its workers first, ROADMAP "Test memory");
assertion messages name the scenario.  Tolerance: exact equality.
"""

import multiprocessing as mp
import os
import random
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zksaas_tpu.comm import LocalNet as JLocalNet
from zksaas_tpu.comm import star as jstar
from zksaas_tpu.circom import ConstraintBuilder as JConstraintBuilder
from zksaas_tpu.dist import DegRedMask as JDegRedMask
from zksaas_tpu.dist import FftMask as JFftMask
from zksaas_tpu.dist import d_ifft as j_d_ifft
from zksaas_tpu.dist import deg_red as j_deg_red
from zksaas_tpu.fields import BN254_FR as J_FR
from zksaas_tpu.groth16 import local as jlocal
from zksaas_tpu.ntt import domain as jdomain
from zksaas_tpu.pss import pss as jpss
from zksaas_tpu.utils import rearrange_perm as j_rearrange_perm
from zksaas_tpu.utils import stride_chunks as j_stride_chunks
from zksaas_tpu_torch import convert, host_prove
from zksaas_tpu_torch.circom.r1cs import ConstraintBuilder
from zksaas_tpu_torch.comm import JournalNet, LocalNet
from zksaas_tpu_torch.comm import star
from zksaas_tpu_torch.comm.host_net import HostStarNet
from zksaas_tpu_torch.curves.curve import curve_g1, curve_g2
from zksaas_tpu_torch.dist.deg_red import DegRedMask, deg_red
from zksaas_tpu_torch.dist.dfft import d_ifft
from zksaas_tpu_torch.fields.spec import BN254_FR
from zksaas_tpu_torch.groth16.local import Proof, verify
from zksaas_tpu_torch.groth16.prove import ProveMasks, pack_scalar_repeated, pack_witness
from zksaas_tpu_torch.groth16.qap import qap_pack
from zksaas_tpu_torch.groth16.setup_device import (
    pack_proving_key_device,
    setup_scalars,
    vk_from_scalars,
)
from zksaas_tpu_torch.ntt.domain import domain
from zksaas_tpu_torch.pss.pss import pss
from zksaas_tpu_torch.utils.rng import generator, split

from test_torch_heap import release_heap  # noqa: F401  (autouse)
from test_torch_host_worker import collect_all, dealer_state, run_client, run_client_journal

torch.set_num_threads(1)
DEV = "cpu"


# --- the TCP star, port against JAX ---------------------------------------

def _tls(king_mod, client_mod, n, tmp):
    """Pinned self-signed certs: the king's context from king_mod, the
    clients' from client_mod (tests/test_star_tls.py::_run_star)."""
    files = []
    for i in range(n):
        cert, key = king_mod.make_self_signed_cert(f"party{i}")
        cf, kf = os.path.join(tmp, f"p{i}.crt"), os.path.join(tmp, f"p{i}.key")
        with open(cf, "wb") as f:
            f.write(cert)
        with open(kf, "wb") as f:
            f.write(key)
        files.append((cf, kf))
    server = king_mod._tls_server_ctx(*files[0], [cf for cf, _ in files[1:]])
    clients = [client_mod._tls_client_ctx(cf, kf, files[0][0]) for cf, kf in files[1:]]
    return server, clients


def _run_star(king_mod, client_mod, n, tmp=None, drop_party=None, timeout=60.0):
    """add_ids (mpc-net/examples/add_ids.rs): every party sends its id on
    channel 3, the king sums the ids that arrived and scatters the total."""
    server, clients = _tls(king_mod, client_mod, n, tmp) if tmp else (None, [None] * n)
    king = king_mod.StarKing(n, timeout=timeout, tls_ctx=server)
    results = {}

    def client_main(pid):
        c = client_mod.StarClient(pid, ("127.0.0.1", king.port), timeout=max(10.0, 5 * timeout),
                                  tls_ctx=clients[pid - 1])
        try:
            if pid != drop_party:
                c.send(f"id={pid}".encode(), channel=3)
            results[pid] = c.recv(channel=3)
        finally:
            c.close()

    threads = [threading.Thread(target=client_main, args=(i,), daemon=True) for i in range(1, n)]
    for t in threads:
        t.start()
    king.accept_all(accept_timeout=300.0)
    rb = king.gather(b"id=0", channel=3, threshold=2)
    total = sum(int(s.decode().split("=")[1]) for s in rb.shares if s is not None)
    king.scatter([None] + [str(total).encode()] * (n - 1), channel=3)
    for t in threads:
        t.join(timeout=120)
    king.close()
    return rb, results


def _threshold_raises(king_mod, client_mod):
    king = king_mod.StarKing(2, timeout=1.0)
    t = threading.Thread(target=lambda: client_mod.StarClient(1, ("127.0.0.1", king.port),
                                                              timeout=5.0), daemon=True)
    t.start()
    king.accept_all(accept_timeout=30.0)
    try:
        with pytest.raises(TimeoutError):
            king.gather(b"x", channel=1, threshold=2)  # the client sends nothing
    finally:
        king.close()
    t.join(timeout=30)


# --- the round journal ------------------------------------------------------

L, M = 2, 8


class _PoisonNet:
    """A net that must never be used: a full replay is network-free."""

    def __init__(self, n):
        self.n_parties = n

    def round(self, x, king_fn, channel: int = 0):
        raise AssertionError("replay touched the network")


def _jax_dealer():
    """tests/test_journal.py::_protocol's dealer: rearranged packed shares
    of M values, the d_ifft's FftMask, the deg_red's DegRedMask."""
    jpp = jpss(J_FR, L)
    rng = random.Random(77)
    evals = [rng.randrange(J_FR.p) for _ in range(M)]
    dom = jdomain(J_FR, M)
    k1, k2, k3, k4, k5 = jax.random.split(jax.random.PRNGKey(91), 5)
    x = jnp.asarray(jpp.F.encode(evals))[np.asarray(j_rearrange_perm(M))]
    shares = jpp.pack(j_stride_chunks(x, L), jpp.rand_pads(k1, (M // L,)))
    shares = jnp.swapaxes(shares, 0, 1)
    mask = JFftMask.sample(False, 1, dom.group_gen_inv, M, jpp, k2)
    dmask = JDegRedMask.sample(jpp, M // L, k4)
    return jpp, dom, shares, mask, dmask, k3, k5


def _unpacked(pp_, shares):
    """(n, num, K) shares -> their unpacked secrets as uint32 limbs."""
    return np.asarray(pp_.unpack(jnp.swapaxes(jnp.asarray(shares), 0, 1)))


# --- the tests --------------------------------------------------------------

def test_star_and_journal_match_jax(tmp_path):
    """The star both ways through test_star_tls.py's four scenarios, then
    the journal's four scenarios against the JAX d_ifft + deg_red."""
    for king_mod, client_mod in ((star, jstar), (jstar, star)):
        way = f"{king_mod.__name__} king, {client_mod.__name__} clients"
        rb, res = _run_star(king_mod, client_mod, 4)
        assert rb.is_full and rb.parties == (0, 1, 2, 3), f"plain TCP, {way}"
        assert all(v == b"6" for v in res.values()) and len(res) == 3, f"plain TCP, {way}"
        tls = tmp_path / f"tls_{king_mod.__name__}"
        tls.mkdir()
        rb, res = _run_star(king_mod, client_mod, 4, tmp=str(tls))
        assert rb.is_full and all(v == b"6" for v in res.values()), f"mTLS, {way}"
        rb, res = _run_star(king_mod, client_mod, 4, drop_party=3, timeout=2.0)
        assert not rb.is_full and rb.parties == (0, 1, 2), f"dropout, {way}"
        assert res[3] == b"3", f"dropout: the dropped party gets the scatter, {way}"
        _threshold_raises(king_mod, client_mod)

    # the journal: the JAX protocol once, then the port's on the same dealer
    jpp, jdom, jshares, jmask, jdmask, k3, k5 = _jax_dealer()
    jnet = JLocalNet(jpp.n)
    jout = j_d_ifft(jpp, jshares, jmask, False, jdom, 1, jnet, k3)
    jout2 = j_deg_red(jpp, jout, jdmask, jnet, k5)
    want = [_unpacked(jpp, jout), _unpacked(jpp, jout2)]

    pp = pss(BN254_FR, L)
    dom = domain(BN254_FR, M)
    shares = convert.to_torch(jshares, DEV, BN254_FR.nlimbs)
    mask = convert.fft_mask_from(jmask, BN254_FR, DEV)
    dmask = convert.degred_mask_from(jdmask, BN254_FR, DEV)

    def protocol(net):
        g3, g5 = split(generator(91), 2)
        out = d_ifft(pp, shares, mask, False, dom, 1, net, g3)
        return [convert.to_numpy(out), convert.to_numpy(deg_red(pp, out, dmask, net, g5))]

    def same(a, b, what):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=what)

    plain = protocol(LocalNet(pp.n))
    same([_unpacked(jpp, o) for o in plain], want, "the port's unpacked outputs against JAX's")
    d = str(tmp_path / "journal")
    jn = JournalNet(LocalNet(pp.n), d)
    same(protocol(jn), plain, "transparent")
    total = jn.rounds
    assert total == 2 and jn.replayed == 0 and jn._recorded_len() == total, "transparent"

    jn = JournalNet(_PoisonNet(pp.n), d)
    same(protocol(jn), plain, "full replay")
    assert jn.replayed == total, "full replay"

    os.unlink(os.path.join(d, f"round_{total - 1:04d}.ckpt"))  # the last record lost
    live = LocalNet(pp.n)
    jn = JournalNet(live, d)
    same(protocol(jn), plain, "partial resume")
    assert jn.replayed == total - 1 and live.rounds == 1, "partial resume: one live round"
    assert jn._recorded_len() == total, "partial resume: the round recorded again"
    jn.clear()
    assert jn._recorded_len() == 0, "clear"

    jn = JournalNet(LocalNet(pp.n), d)
    protocol(jn)
    os.unlink(os.path.join(d, f"round_{total - 1:04d}.ckpt"))
    with open(os.path.join(d, f"round_{total - 1:04d}.ckpt.tmp"), "wb") as f:
        f.write(b"torn")  # a write that never reached its rename
    jn = JournalNet(LocalNet(pp.n), d)
    assert jn._recorded_len() == total - 1, "torn record"
    same(protocol(jn), plain, "torn record")


def _spawn(target, args_of, n):
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of(i), daemon=True) for i in range(1, n)]
    for p in procs:
        p.start()
    return procs


def _join(procs, what):
    for p in procs:
        p.join(timeout=120)
    assert [p.exitcode for p in procs] == [0] * len(procs), f"client exit codes, {what}"


def test_host_star_deg_red_across_processes(tmp_path):
    """deg_red over 4 processes, lossless and with party 3 silent (the king
    proceeds Partial), then a journaled run, a lost last record at party 3
    and a resume across processes (tests/test_host_net.py)."""
    n = 4
    for lossy in (False, True):
        what = "lossy" if lossy else "lossless"
        pp, x0, mask0, gen = dealer_state(0)
        net = HostStarNet.make_king(n, pp.t, timeout=6.0 if lossy else 60.0)
        procs = _spawn(run_client, lambda i: (i, net.port, n, lossy and i == 3), n)
        try:
            net.accept_all()
            out0 = deg_red(pp, x0, mask0, net, gen)
            stacked = net.round(out0, collect_all, 7)  # (n, 1, K)
        finally:
            net.close()
            _join(procs, what)
        got = pp.F.decode(pp.unpack(stacked.transpose(0, 1)).reshape(-1, pp.F.k))
        assert list(got) == [49], what
        st = net.stats()
        assert st["rounds"] == 2 and st["bytes_in"] > 0 and st["bytes_out"] > 0, what
        # the king's share: the port's LocalNet king on the same shares
        parties = [dealer_state(i) for i in range(n)]
        mask = DegRedMask(torch.stack([st[2].in_mask for st in parties]),
                          torch.stack([st[2].out_mask for st in parties]))
        local = deg_red(pp, torch.stack([st[1] for st in parties]), mask,
                        LocalNet(n, drop=(3,) if lossy else ()), parties[0][3])
        assert torch.equal(out0, local[0]), f"the king's share against LocalNet's, {what}"

    pp = dealer_state(0)[0]
    dirs = [str(tmp_path / f"party{i}") for i in range(n)]

    def one_run(resume):
        _, x0, mask0, gen = dealer_state(0)
        inner = HostStarNet.make_king(n, pp.t, timeout=60.0)
        procs = _spawn(run_client_journal, lambda i: (i, inner.port, n, dirs[i], resume), n)
        net = JournalNet(inner, dirs[0])
        try:
            inner.accept_all()
            if resume:
                net.negotiate_resume()
            stacked = net.round(deg_red(pp, x0, mask0, net, gen), collect_all, 7)
        finally:
            net.close()
            _join(procs, f"journal, resume={resume}")
        got = pp.F.decode(pp.unpack(stacked.transpose(0, 1)).reshape(-1, pp.F.k))
        return list(got), net

    got, net1 = one_run(False)
    total = net1.rounds
    assert got == [49] and net1._recorded_len() == total, "journaled run"
    os.unlink(os.path.join(dirs[3], f"round_{total - 1:04d}.ckpt"))  # party 3 crashed
    got, net2 = one_run(True)
    assert got == [49], "resume"
    assert net2.replayed == total - 1, "resume: the common prefix from disk"
    assert net2._recorded_len() == total, "resume: the missing round recorded again"


def _circuit(builder_cls, spec):
    """tests/test_host_prove.py:25-50: x -> x^8, one public output."""
    cb = builder_cls(spec)
    x = cb.witness(3)
    val = 3
    for _ in range(3):
        x = cb.mul(x, x)
        val = val * val % spec.p
    out = cb.pub_input(val)
    cb.constrain([(1, x)], [(1, 0)], [(1, out)])
    return cb.finalize()


def test_host_prove_equals_local_prove():
    """The whole prove over the TCP star, one process a party (n = 4,
    l = 1): the unpacked proof equals the JAX package's local_prove for the
    same keys, r and s, and verifies."""
    jr1cs, jz = _circuit(JConstraintBuilder, J_FR)
    rng = random.Random(321)
    keys = jlocal.setup(jr1cs, rng, reduction="circom")
    r, s = rng.randrange(J_FR.p), rng.randrange(J_FR.p)
    expected = jlocal.local_prove(keys, jr1cs, jz, r, s)

    r1cs, z = _circuit(ConstraintBuilder, BN254_FR)
    ss = setup_scalars(r1cs, random.Random(321), reduction="circom")
    vk = vk_from_scalars(ss)
    assert vk.delta_g1 == keys.delta_g1  # the same CRS from the same seed
    pp = pss(BN254_FR, 1)
    g1, g2 = curve_g1(), curve_g2()
    ks = split(generator(888), 7)
    q = qap_pack(pp, r1cs, z, ks[0], DEV)
    res = host_prove.prove_king(
        pp, g1, g2, pack_proving_key_device(ss, vk, pp, g1, g2, device=DEV), q,
        pack_witness(pp, z[1:], ks[1], DEV), pack_witness(pp, z[r1cs.num_instance :], ks[2], DEV),
        pack_scalar_repeated(pp, r, ks[3], DEV), pack_scalar_repeated(pp, s, ks[4], DEV),
        ProveMasks.sample(pp, g1, g2, q.dom.n, ks[5], DEV), ks[6], timeout=600.0, device=DEV)
    sa, sb, sc = res["shares"]
    a = g1.decode(tuple(c[:1] for c in pp.unpack2_g(g1, sa)))[0]
    b = g2.decode(tuple(c[:1] for c in pp.unpack2_g(g2, sb)))[0]
    c = g1.decode(tuple(c[:1] for c in pp.unpack2_g(g1, sc)))[0]
    assert (a, b, c) == (expected.a, expected.b, expected.c)
    assert verify(vk, z[1 : r1cs.num_instance], Proof(a=a, b=b, c=c))
    assert jlocal.verify(keys, jz[1 : r1cs.num_instance], jlocal.Proof(a=a, b=b, c=c))
    # 2 fft rounds, deg_red, 5 d_msm, the collection
    st = res["stats"]
    assert st["rounds"] == len(host_prove.ROUND_KINDS) == 9
    assert st["bytes_in"] > 0 and st["bytes_out"] > 0
    assert res["exitcodes"] == [0] * (pp.n - 1)
