"""The distributed prove as one process a party over the TCP star.

The reference's deployment shape (groth16/examples/sha256.rs:159-416 runs
the whole prove over sockets): the king runs in the caller's process and
spawns the n - 1 clients, each its own process (its own trust domain).
Every party runs the complete d_prove protocol over HostStarNet, every
share, mask and intermediate crossing process boundaries in the numpy wire
format, and a last collection round (channel 7) stacks every party's proof
shares at the king, who unpacks them.  Port of the harness of
tests/hostnet_prove_worker.py and the king side of tests/test_host_prove.py.

Each process holds one party with no party axis.  A client gets its state
as numpy (`party_state`: the `party(i)` of each dealer container through
convert.py), never as device tensors, and puts it on its own device.  Only
the king's generators decide the pads; the clients' are unused.  The king
builds the kernel library before it spawns, so the clients load that build
and never compile.  On the CPU every process runs torch with one thread.
"""

from __future__ import annotations

import multiprocessing as mp

import torch

from . import convert, kernels
from .comm.host_net import HostStarNet
from .comm.net import _map
from .curves.curve import curve_g1, curve_g2
from .device import resolve_device
from .fields.spec import FIELDS
from .groth16.local import curve_family
from .groth16.prove import d_prove
from .pss.pss import pss
from .utils.rng import generator, split
from .utils.trace import span

COLLECT = 7  # the collection round's logical channel
# the rounds of one prove, in order (circom_h: the a/b/c d_ifft and d_fft
# batched, one round each, then deg_red; then the five d_msm), then the
# collection
ROUND_KINDS = ("fft", "fft", "deg_red", "msm", "msm", "msm", "msm", "msm", "collection")


def party_state(i: int, pp, crs, qap_share, a_share, ax_share, r_share, s_share, masks) -> dict:
    """Party i's part of the dealer's outputs, as numpy arrays in dicts."""
    return dict(
        spec=pp.spec.name, l=pp.l,
        crs=convert.crs_to_numpy(crs.party(i)),
        qap=convert.qap_to_numpy(qap_share.party(i)),
        a=convert.to_numpy(a_share[i]), ax=convert.to_numpy(ax_share[i]),
        r=convert.to_numpy(r_share[i]), s=convert.to_numpy(s_share[i]),
        masks=convert.prove_masks_to_numpy(masks.party(i)),
    )


def party_inputs(state: dict, device):
    """A party_state on `device`: (pp, g1, g2, crs, qap, a, ax, r, s, masks),
    the arguments of d_prove up to the net."""
    spec = FIELDS[state["spec"]]
    fam = curve_family(spec)
    k = spec.nlimbs
    return (
        pss(spec, state["l"]), curve_g1(fam), curve_g2(fam),
        convert.crs_from(state["crs"], spec, device),
        convert.qap_from(state["qap"], spec, device),
        *(convert.to_torch(state[x], device, k) for x in ("a", "ax", "r", "s")),
        convert.prove_masks_from(state["masks"], spec, device),
    )


def collect(net, pi):
    """The collection round: every party sends its proof shares and gets
    the survivors' stack; returns it."""
    n = net.n_parties
    return net.round(pi, lambda xs, parties: _map(
        lambda a: a.unsqueeze(0).expand((n,) + a.shape), xs), COLLECT)


def run_prove_client(party_id: int, port: int, n: int, state: dict, timeout: float,
                     device="cuda", proves: int = 1):
    """A client party: `proves` proves and their collection rounds over the
    king at 127.0.0.1:port."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    args = party_inputs(state, dev)
    pp = args[0]
    net = HostStarNet.make_client(n, pp.t, party_id, ("127.0.0.1", port), timeout=timeout)
    try:
        for _ in range(proves):
            collect(net, d_prove(*args, net, generator(1000 + party_id)))
    finally:
        net.close()


def _client_main(party_id: int, port: int, n: int, conn, timeout: float, device, proves: int):
    """The target of the king's spawned processes: run_prove_client on the
    party_state that arrives on `conn`.  A state passed as an argument of
    the process would be written while the child imports torch, which
    holds the parent's start() of every child in turn."""
    state = conn.recv()
    conn.close()
    run_prove_client(party_id, port, n, state, timeout, device, proves)


class _Metered:
    """Forwards rounds to a HostStarNet and logs each one's bytes and
    seconds."""

    def __init__(self, net):
        self.net = net
        self.n_parties = net.n_parties
        self.log: list = []

    def round(self, x, king_fn, channel: int = 0):
        before, t = self.net.stats(), {}
        with span("round", t):
            out = self.net.round(x, king_fn, channel)
        after = self.net.stats()
        self.log.append(dict(channel=channel, s=t["round"],
                             bytes_in=after["bytes_in"] - before["bytes_in"],
                             bytes_out=after["bytes_out"] - before["bytes_out"]))
        return out


def prove_king(pp, g1, g2, crs, qap_share, a_share, ax_share, r_share, s_share, masks, rng,
               timeout: float = 900.0, device="cuda", warmup: bool = False) -> dict:
    """The king of a prove over the TCP star on 127.0.0.1, with the n - 1
    clients spawned here, on `device` (the card unless device="cpu").
    The arguments are the dealer's, as d_prove takes them (leading party
    axis), up to the net.  With `warmup`, every party first runs one prove
    and collection that is not timed.  Returns the stacked proof shares
    (pi_a, pi_b_g2, pi_c), each with a leading party axis, the net's stats
    and per-round log of the timed prove and its collection, the king's
    split of its round time (HostStarNet.times), seconds of each phase, and
    each kernel's launches in the king's timed d_prove."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        kernels.cuda_lib()  # built once here; the clients load this build
    n = pp.n
    dealt = (crs, qap_share, a_share, ax_share, r_share, s_share, masks)
    times: dict = {}
    with span("party_states", times):
        states = [party_state(i, pp, *dealt) for i in range(n)]
    star = HostStarNet.make_king(n, pp.t, timeout=timeout)
    ctx = mp.get_context("spawn")
    pipes = [ctx.Pipe(duplex=False) for _ in range(1, n)]
    procs = [ctx.Process(target=_client_main,
                         args=(i, star.port, n, pipes[i - 1][0], timeout, dev.type, 1 + warmup),
                         daemon=True) for i in range(1, n)]
    phases: dict = {}
    started = []
    try:
        with span("spawn", times):
            for p in procs:
                p.start()
                started.append(p)
            for i, (recv_end, send_end) in enumerate(pipes, start=1):
                recv_end.close()
                send_end.send(states[i])
                send_end.close()
        with span("accept", times):
            star.accept_all()
        mine = party_inputs(states[0], dev)[3:]
        del states
        k_warm, k_prove = split(rng, 2)
        if warmup:
            with span("warmup", times):
                collect(star, d_prove(pp, g1, g2, *mine, star, k_warm))
        star.times.clear()
        base = star.stats()
        net = _Metered(star)
        saved = kernels.save_launches()
        with span("prove", times):
            pi = d_prove(pp, g1, g2, *mine, net, k_prove, times=phases)
        launches = {k.name: k.launches - b[0] for k, b in zip(kernels.KERNELS, saved)}
        with span("collect", times):
            stacked = collect(net, pi)
    finally:
        star.close()
        for p in started:
            p.join(timeout=120)
            if p.is_alive():  # a client still waiting on a king that failed
                p.terminate()
                p.join(timeout=10)
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"client exit codes {codes}")
    stats = {k: v - base[k] for k, v in star.stats().items()}
    return dict(shares=stacked, stats=stats, rounds=net.log, king_split=dict(star.times),
                times=times, prove_phases=phases, launches=launches, exitcodes=codes)
