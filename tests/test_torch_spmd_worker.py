"""Ranks of tests/test_torch_spmd.py, each spawned as a process of its own.

`run_case` runs one primitive of the port (d_ifft, d_fft, deg_red, d_msm)
from numpy inputs: over LocalNet on every party's stack in the test's
process, or over SpmdNet on one rank's slice in a rank process
(`run_rank`, which joins a gloo group of the store at 127.0.0.1:port and
runs every case in turn).  Every generator is seeded from the case, so both
draw the king's pads alike.  This module imports neither JAX nor the JAX
package, so a spawned rank starts with torch and the port alone; it holds
no tests.
"""

import datetime

import numpy as np
import torch
import torch.distributed as dist

from zksaas_tpu_torch import convert
from zksaas_tpu_torch.comm.net import SpmdNet
from zksaas_tpu_torch.curves.curve import curve_g1
from zksaas_tpu_torch.dist.deg_red import deg_red
from zksaas_tpu_torch.dist.dfft import d_fft, d_ifft
from zksaas_tpu_torch.dist.dmsm import d_msm
from zksaas_tpu_torch.fields.spec import BN254_FR
from zksaas_tpu_torch.ntt.domain import domain
from zksaas_tpu_torch.pss.pss import pss
from zksaas_tpu_torch.utils.rng import generator

DEV = "cpu"
SPEC = BN254_FR


def run_case(case: dict, net, rank=None):
    """The case's primitive over `net`; rank None: every party's inputs
    (leading party axis), else that party's alone.  Returns the output
    shares as numpy (points: a tuple of coordinate arrays)."""
    pp = pss(SPEC, case["l"])
    k = SPEC.nlimbs
    pick = (lambda a: a) if rank is None else (lambda a: a[rank])
    arr = lambda a: convert.to_torch(pick(a), DEV, None)
    gen = generator(case["seed"])
    op = case["op"]
    if op == "msm":
        C = curve_g1()
        mk = case["mask"]
        mask = convert.msm_mask_from({key: tuple(pick(c) for c in mk[key]) for key in mk},
                                     SPEC, DEV)
        out = d_msm(pp, C, tuple(arr(c) for c in case["bases"]), arr(case["scalars"]), mask, net)
        return convert.points_to_numpy(out)
    mask = {key: pick(v) for key, v in case["mask"].items()}
    x = convert.to_torch(pick(case["shares"]), DEV, k)
    if op == "deg_red":
        return convert.to_numpy(deg_red(pp, x, convert.degred_mask_from(mask, SPEC, DEV), net,
                                        gen))
    mask = convert.fft_mask_from(mask, SPEC, DEV)
    dom = domain(SPEC, case["m"])
    if op == "ifft":
        out = d_ifft(pp, x, mask, case["rearrange"], dom, case["g"], net, gen)
    else:
        out = d_fft(pp, x, mask, case["rearrange"], dom, net, gen)
    return convert.to_numpy(out)


def run_rank(rank: int, n: int, port: int, conn):
    """One rank: the cases that arrive on `conn`, each over a fresh SpmdNet;
    sends back each case's output share, counters and (op, round kind) log."""
    torch.set_num_threads(1)
    cases = conn.recv()
    td = datetime.timedelta(seconds=300)
    store = dist.TCPStore("127.0.0.1", port, n, False, timeout=td)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=n, timeout=td)
    try:
        out = {}
        for name, case in cases.items():
            net = SpmdNet()
            share = run_case(case, net, rank)
            out[name] = dict(share=share, stats=net.stats(),
                             ops=[(e["op"], e["kind"]) for e in net.log])
        conn.send(out)
    finally:
        dist.destroy_process_group()
        conn.close()
