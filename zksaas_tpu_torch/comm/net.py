"""The star-topology protocol transports: LocalNet and SpmdNet.

Port of zksaas_tpu/comm/net.py.  Every distributed primitive is
local compute -> gather -> king compute -> scatter -> local compute, so
the transport is one `round(x, king_fn)` primitive.

* LocalNet (the reference's LocalTestNet, mpc-net/src/multi.rs:244-363):
  all parties in one process.  Party data carries an explicit leading
  party axis; `drop` simulates lossy rounds (simulate_lossy_network_round,
  multi.rs:330-363) by withholding those parties' shares and handing
  king_fn the surviving-party tuple, which selects the Lagrange
  reconstruction path.
* SpmdNet: one process a party over a torch.distributed process group
  whose rank is the party id.  Party data is the rank's own shard (no
  party axis).  The gather and scatter of a round become one all_gather and
  the king step is computed again on every rank ("replicated king"; the
  king only ever sees masked values, so replicating it reveals nothing).
  The two heavy rounds (dist/dfft.py's fft2, dist/deg_red.py) do not
  gather at all: they split the king's work over the ranks with two
  all_to_alls, through `all_to_all` and `shift_from_prev` here.
"""

from __future__ import annotations

import time
from typing import Callable

import torch
import torch.distributed as dist

from ..utils.trace import span

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
        with span("zk.net.king"):
            return king_fn(x, parties)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class SpmdNet:
    """This rank's party over the default torch.distributed process group;
    the rank is the party id.

    `round` all_gathers the tensors of x (tuples and lists nest, as in
    LocalNet) onto a leading party axis, runs king_fn on every rank and
    returns this rank's row.  `all_to_all` and `shift_from_prev` are the
    collectives of the sharded king paths.

    The backend is the caller's choice when it makes the group.  Under
    gloo, SpmdNet copies CUDA tensors to pinned host memory before a
    collective and back after it, itself, and counts that time (`stage_s`);
    under nccl they go to the collective as they are.  CPU tensors are never
    copied.

    Counters (`stats()`): protocol rounds (a `round`, or one sharded round
    of the fft or deg_red), calls of each collective, bytes this rank sent
    to and received from other ranks, seconds in collectives and seconds
    in host staging.  `log` holds one entry a collective: its op, the round
    it belongs to, that round's kind, bytes and seconds."""

    def __init__(self):
        self.rank = dist.get_rank()
        self.n_parties = dist.get_world_size()
        self.stage = dist.get_backend() == "gloo"
        self.rounds = 0
        self.kind = None
        self.calls = {"all_gather": 0, "all_to_all": 0, "shift": 0}
        self.bytes_out = 0
        self.bytes_in = 0
        self.collective_s = 0.0
        self.stage_s = 0.0
        self.log: list = []

    def stats(self) -> dict:
        return dict(rounds=self.rounds, **self.calls, bytes_out=self.bytes_out,
                    bytes_in=self.bytes_in, collective_s=self.collective_s,
                    stage_s=self.stage_s)

    def begin_round(self, kind: str) -> None:
        """Count one protocol round; the collectives until the next one
        are logged under it."""
        self.rounds += 1
        self.kind = kind

    def _collective(self, op: str, x: torch.Tensor, run, bytes_out: int, bytes_in: int):
        """run(x on the host or as it is) -> the result there; staged
        through pinned host memory under gloo for a CUDA x."""
        dev = x.device
        stage = self.stage and dev.type == "cuda"
        t_stage = 0.0
        if stage:
            _sync(dev)
            t0 = time.perf_counter()
            x = torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)
            t_stage += time.perf_counter() - t0
        _sync(x.device)
        t0 = time.perf_counter()
        y = run(x)
        _sync(y.device)
        secs = time.perf_counter() - t0
        if stage:
            t0 = time.perf_counter()
            y = y.to(dev)
            _sync(dev)
            t_stage += time.perf_counter() - t0
        self.calls[op] += 1
        self.bytes_out += bytes_out
        self.bytes_in += bytes_in
        self.collective_s += secs
        self.stage_s += t_stage
        self.log.append(dict(op=op, round=self.rounds, kind=self.kind, bytes_out=bytes_out,
                             bytes_in=bytes_in, s=secs, stage_s=t_stage))
        return y

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(n, *t.shape): every rank's t, in rank order."""
        n = self.n_parties
        nbytes = t.numel() * t.element_size()

        def run(x):
            out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
            dist.all_gather(list(out.unbind(0)), x.contiguous())
            return out

        return self._collective("all_gather", t, run, (n - 1) * nbytes, (n - 1) * nbytes)

    def all_to_all(self, t: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        """jax.lax.all_to_all: split t's split_dim into n equal blocks, send
        block j to rank j, and concatenate the blocks received, in rank
        order, along concat_dim."""
        n = self.n_parties
        split_dim %= t.dim()
        concat_dim %= t.dim()
        if t.shape[split_dim] % n:
            raise ValueError(f"dim {split_dim} of {tuple(t.shape)} does not split {n} ways")
        x = t.movedim(split_dim, 0)
        x = x.reshape((n, x.shape[0] // n) + tuple(x.shape[1:])).contiguous()
        block = list(t.shape)
        block[split_dim] //= n
        nbytes = x.numel() * x.element_size() * (n - 1) // n

        def run(x):
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x)
            return y

        y = self._collective("all_to_all", x, run, nbytes, nbytes)
        y = y.movedim(1, split_dim + 1).movedim(0, concat_dim)  # rank axis before concat_dim
        out = list(block)
        out[concat_dim] *= n
        return y.reshape(out)

    def shift_from_prev(self, t: torch.Tensor) -> torch.Tensor:
        """Rank i gets rank (i - 1) mod n's t (jax.lax.ppermute i -> i + 1)."""
        n, me = self.n_parties, self.rank
        nbytes = t.numel() * t.element_size()

        def run(x):
            y = torch.empty_like(x)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, (me + 1) % n),
                dist.P2POp(dist.irecv, y, (me - 1) % n),
            ])
            for r in reqs:
                r.wait()
            return y

        return self._collective("shift", t.contiguous(), run, nbytes, nbytes)

    def round(self, x, king_fn: KingFn, channel: int = 0):
        """One all_gather per tensor of x, king_fn on the stacks, this
        rank's row of its output."""
        self.begin_round("gather")
        gathered = _map(self.all_gather, x)
        with span("zk.net.king"):
            out = king_fn(gathered, tuple(range(self.n_parties)))
        return _map(lambda a: a[self.rank], out)
