"""The distributed prove as one process a party over torch.distributed.

Port of examples/spmd_prove.py, the JAX package's production path: the
complete d_prove with every party its own rank of a torch.distributed
process group, over SpmdNet (comm/net.py).  A protocol round is one
all_gather and the king step runs on every rank; the two heavy rounds, the
batched fft2 of circom_h and deg_red, split the king's work over the ranks
with two all_to_alls each (dist/dfft.py, dist/deg_red.py).  A last
collection round (an all_gather) brings every party's proof shares to
rank 0, which returns them.

The caller's process is rank 0.  It builds the kernel library first, so
the other ranks load that build and never compile, then spawns ranks
1 .. n-1 (multiprocessing "spawn") and sends each its party_state
(host_prove.py: numpy, never device tensors) through a pipe once every
child has started.  Each rank joins the group over a TCP store on
127.0.0.1 (rank 0 holds it, on a free port), puts its state on its device
and proves with generator(seed): under SpmdNet every rank draws the king's
pads, so every rank's generator is seeded alike.

The backend is the caller's choice, and it decides the devices:
  gloo  every rank on `device` (the card, or the CPU with device="cpu");
        SpmdNet moves CUDA tensors through pinned host memory around each
        collective and counts that time.  This is how 8 ranks share one
        card: NCCL refuses two ranks on one device.
  nccl  rank i on cuda:i, so n cards.
On the CPU every process runs torch with one thread.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp

import torch
import torch.distributed as dist

from . import kernels
from .comm.net import SpmdNet
from .device import resolve_device
from .groth16.prove import d_prove
from .host_prove import collect, party_inputs, party_state
from .utils.rng import generator, split
from .utils.trace import span

BACKENDS = ("gloo", "nccl")


def _rank_device(rank: int, backend: str, dev: torch.device) -> torch.device:
    if backend == "nccl":
        return torch.device("cuda", rank)
    return dev


def _join(rank: int, n: int, port: int, backend: str, dev, timeout: float, store=None):
    """Join the process group of the store at 127.0.0.1:port as `rank`."""
    td = datetime.timedelta(seconds=timeout)
    if store is None:
        store = dist.TCPStore("127.0.0.1", port, n, False, timeout=td)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n, timeout=td)


def _prove(state: dict, dev, seed: int, warmup: bool, times: dict, phases: dict | None = None):
    """One rank's proves: with `warmup` one prove and collection that is
    not timed, then the timed one on a fresh SpmdNet.  Returns (the stacked
    proof shares, the timed net, each kernel's launches in the timed
    d_prove)."""
    args = party_inputs(state, dev)
    k_warm, k_prove = split(generator(seed), 2)
    if warmup:
        with span("warmup", times):
            net = SpmdNet()
            collect(net, d_prove(*args, net, k_warm))
    dist.barrier()
    net = SpmdNet()
    saved = kernels.save_launches()
    with span("prove", times):
        pi = d_prove(*args, net, k_prove, times=phases)
    launches = {k.name: k.launches - b[0] for k, b in zip(kernels.KERNELS, saved)}
    with span("collect", times):
        stacked = collect(net, pi)
    return stacked, net, launches


def _rank_main(rank: int, n: int, port: int, conn, backend: str, device: str, seed: int,
               warmup: bool, timeout: float):
    """The target of rank 0's spawned processes: take the party_state that
    arrives on `conn`, prove, send back this rank's counters and times."""
    state = conn.recv()
    dev = _rank_device(rank, backend, torch.device(device))
    if dev.type == "cpu":
        torch.set_num_threads(1)
    _join(rank, n, port, backend, dev, timeout)
    try:
        times: dict = {}
        _, net, _ = _prove(state, dev, seed, warmup, times)
        conn.send(dict(stats=net.stats(), times=times))
    finally:
        dist.destroy_process_group()
        conn.close()


def prove_spmd(pp, g1, g2, crs, qap_share, a_share, ax_share, r_share, s_share, masks,
               seed: int, backend: str, device="cuda", warmup: bool = False,
               timeout: float = 900.0) -> dict:
    """A prove with one process a party, this process rank 0, over
    torch.distributed with `backend` (gloo or nccl), on `device` (the card
    unless device="cpu").  The arguments are the dealer's, as d_prove takes
    them (leading party axis), up to the net; `seed` seeds every rank's
    generator.  With `warmup`, every rank first runs one prove and
    collection that is not timed.  Returns the stacked proof shares
    (pi_a, pi_b_g2, pi_c), each with a leading party axis; each rank's
    SpmdNet counters of the timed prove and its collection (`stats`, rank
    order) and the times of the other ranks; rank 0's collective log
    (`rounds`), its times (party_states, spawn, init, warmup, prove,
    collect), prove phases and each kernel's launches in its timed d_prove;
    and the other ranks' exit codes.  Raises if a rank fails."""
    dev = resolve_device(device)
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    n = pp.n
    if backend == "nccl" and (dev.type != "cuda" or torch.cuda.device_count() < n):
        raise ValueError(f"nccl puts rank i on cuda:i: {n} cards needed")
    if dev.type == "cuda":
        kernels.cuda_lib()  # built once here; the other ranks load this build
    dealt = (crs, qap_share, a_share, ax_share, r_share, s_share, masks)
    times: dict = {}
    with span("party_states", times):
        states = [party_state(i, pp, *dealt) for i in range(n)]
    store = dist.TCPStore("127.0.0.1", 0, n, True, timeout=datetime.timedelta(seconds=timeout),
                          wait_for_workers=False)
    ctx = mp.get_context("spawn")
    pipes = [ctx.Pipe() for _ in range(1, n)]
    procs = [ctx.Process(target=_rank_main,
                         args=(i, n, store.port, pipes[i - 1][1], backend, dev.type, seed,
                               warmup, timeout), daemon=True) for i in range(1, n)]
    started, joined, reports = [], False, []
    phases: dict = {}
    try:
        with span("spawn", times):
            for p in procs:
                p.start()
                started.append(p)
            for i, (mine, theirs) in enumerate(pipes, start=1):
                theirs.close()
                mine.send(states[i])
        with span("init", times):
            _join(0, n, store.port, backend, _rank_device(0, backend, dev), timeout, store)
            joined = True
        state0 = states[0]
        del states
        stacked, net, launches = _prove(state0, _rank_device(0, backend, dev), seed, warmup,
                                        times, phases)
        for mine, _ in pipes:
            if not mine.poll(timeout):
                raise TimeoutError("a rank sent no report")
            reports.append(mine.recv())
    finally:
        if joined:
            dist.destroy_process_group()
        for p in started:
            p.join(timeout=120)
            if p.is_alive():  # a rank still waiting on a collective that failed
                p.terminate()
                p.join(timeout=10)
        for mine, _ in pipes:
            mine.close()
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"rank exit codes {codes}")
    return dict(shares=stacked, stats=[net.stats()] + [r["stats"] for r in reports],
                rank_times=[r["times"] for r in reports], rounds=net.log, times=times,
                prove_phases=phases, launches=launches, exitcodes=codes)
