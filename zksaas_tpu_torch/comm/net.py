"""The star-topology protocol transport: the in-process LocalNet.

Port of zksaas_tpu/comm/net.py::LocalNet (the reference's LocalTestNet,
mpc-net/src/multi.rs:244-363).  Every distributed primitive is
local compute -> gather -> king compute -> scatter -> local compute, so
the transport is one `round(x, king_fn)` primitive.  Party data carries an
explicit leading party axis; `drop` simulates lossy rounds
(simulate_lossy_network_round, multi.rs:330-363) by withholding those
parties' shares and handing king_fn the surviving-party tuple, which
selects the Lagrange reconstruction path.  The multi-device SpmdNet
(torch.distributed) is a later slice.
"""

from __future__ import annotations

from typing import Callable

import torch

KingFn = Callable[[object, tuple], object]


def _leaves(x):
    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return []


def _map(fn, x):
    if torch.is_tensor(x):
        return fn(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_map(fn, v) for v in x)
    return x


class LocalNet:
    """In-process n-party simulator.  king_fn receives the gathered
    tensors (tuples nest) restricted to surviving parties plus the party
    tuple, and returns per-party outputs with leading axis n."""

    def __init__(self, n: int, drop: tuple = ()):
        self.n_parties = n
        self.drop = tuple(drop)
        self.rounds = 0
        self.gathered_elems = 0

    @property
    def parties(self) -> tuple:
        return tuple(i for i in range(self.n_parties) if i not in self.drop)

    def round(self, x, king_fn: KingFn, channel: int = 0):
        self.rounds += 1
        for leaf in _leaves(x):
            self.gathered_elems += leaf.numel()
        parties = self.parties
        if self.drop:
            idx = torch.tensor(parties, device=_leaves(x)[0].device)
            x = _map(lambda a: a.index_select(0, idx), x)
        return king_fn(x, parties)
