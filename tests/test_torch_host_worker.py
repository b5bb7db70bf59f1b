"""Client parties of tests/test_torch_host_net.py, each spawned as a process
of its own (its own trust domain, like a ProdNet peer).

The port's counterparts of tests/hostnet_worker.py: deg_red (n = 4, l = 1)
of a packed sharing of 7 * 7, every party's state recomputed in its own
process from the same seeds (`dealer_state`), then a collection round
(channel 7) in which every party gets the stack of all parties' shares.
This module imports neither JAX nor the JAX package, so a spawned client
starts with torch and the port alone; it holds no tests.
"""

import torch

from zksaas_tpu_torch.comm.host_net import HostStarNet, deser_like
from zksaas_tpu_torch.comm.journal import JournalNet
from zksaas_tpu_torch.dist.deg_red import DegRedMask, deg_red
from zksaas_tpu_torch.fields.spec import BN254_FR
from zksaas_tpu_torch.pss.pss import pss
from zksaas_tpu_torch.utils.rng import generator, split

DEV = "cpu"


def dealer_state(party_id: int):
    """(pp, party_id's share of 7 * 7, its DegRedMask, the king's generator)."""
    pp = pss(BN254_FR, 1)  # n = 4 parties
    F = pp.F
    k1, k2, k3 = split(generator(5), 3)
    shares = pp.pack(F.encode([[7]], DEV), pp.rand_pads(k1, (1,), DEV))  # (1, n, K)
    x_all = F.mul(shares, shares).transpose(0, 1).contiguous()  # (n, 1, K)
    return pp, x_all[party_id], DegRedMask.sample(pp, 1, k2, DEV).party(party_id), k3


def collect_all(xs, parties):
    """The collection round's king: every party gets the whole stack."""
    return xs.unsqueeze(0).expand((4,) + xs.shape)


def run_client(party_id: int, port: int, n: int, silent: bool):
    torch.set_num_threads(1)
    pp, x_share, mask, key = dealer_state(party_id)
    net = HostStarNet.make_client(n, pp.t, party_id, ("127.0.0.1", port), timeout=15.0)
    try:
        if silent:
            # a dropped party: it skips the protocol send but keeps
            # listening; the king times out on it, proceeds Partial through
            # Lagrange and still scatters it a fresh share
            net.rounds = 1
            data = net.role.recv(0 + 16 * 1)
            out = pp.F.add(deser_like(data, x_share), mask.out_mask)
        else:
            out = deg_red(pp, x_share, mask, net, key)
        net.round(out, collect_all, 7)
    finally:
        net.close()


def run_client_journal(party_id: int, port: int, n: int, jdir: str, resume: bool):
    """The same deg_red and collection with every round journaled to jdir;
    on resume, the common prefix is negotiated first and replayed."""
    torch.set_num_threads(1)
    pp, x_share, mask, key = dealer_state(party_id)
    inner = HostStarNet.make_client(n, pp.t, party_id, ("127.0.0.1", port), timeout=15.0)
    net = JournalNet(inner, jdir)
    try:
        if resume:
            net.negotiate_resume()
        net.round(deg_red(pp, x_share, mask, net, key), collect_all, 7)
    finally:
        net.close()
