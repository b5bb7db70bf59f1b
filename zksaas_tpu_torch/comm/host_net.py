"""HostStarNet: the protocol `round` interface over the real TCP star.

Port of zksaas_tpu/comm/host_net.py.  Each party is its own PROCESS (its
own trust domain, the deployment mode the reference's ProdNet serves,
prod.rs).  The king process gathers serialized shares (with the
timeout/threshold/Partial contract of comm/star.py), runs king_fn on the
survivors' stack, and scatters per-party slices; clients just serialize
and deserialize.

Protocol code (d_fft, deg_red, d_msm, d_prove) runs unchanged: under
HostStarNet the party axis is implicit (each process holds its own shard,
no leading party axis), and king_fn sees exactly the layout LocalNet hands
it, the survivors stacked on a leading axis plus their party tuple.

Wire format: the tensors of a round's input, a tensor or nested tuples and
lists of them, in order, as one `np.savez` archive; a reader takes the
nesting from the tensors it already holds (`like`), loads with
allow_pickle=False and puts every array on the device of its `like` tensor.
`times` splits the king's rounds into ser (tensors to bytes, the device
copy included), wait (the gather), deser (bytes to tensors on the device),
king (the stack and king_fn) and scatter; `bytes_in` / `bytes_out` count
the payloads that cross the wire.
"""

from __future__ import annotations

import io

import numpy as np
import torch

from ..utils.trace import span
from .net import _leaves, _map
from .star import StarClient, StarKing


def ser(x) -> bytes:
    """The tensors of x (nested tuples and lists) as one npz archive."""
    buf = io.BytesIO()
    np.savez(buf, *[t.detach().cpu().numpy() for t in _leaves(x)])
    return buf.getvalue()


def deser_like(data: bytes, like):
    """An archive of `ser` back into the nesting of `like`, each tensor on
    the device of the `like` tensor in its place."""
    leaves = _leaves(like)
    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        if len(z.files) != len(leaves):
            raise ValueError(f"{len(z.files)} arrays on the wire, {len(leaves)} expected")
        arrs = [z[f"arr_{i}"] for i in range(len(leaves))]
    it = iter(torch.from_numpy(a).to(t.device) for a, t in zip(arrs, leaves))
    return _map(lambda _: next(it), like)


def _stack(shares):
    """Per-party nested tensors -> one nesting with a leading party axis."""
    first = shares[0]
    if torch.is_tensor(first):
        return torch.stack(shares)
    return type(first)(_stack([s[i] for s in shares]) for i in range(len(first)))


class HostStarNet:
    """Per-process star-net party.

    Build with `make_king` / `make_client`; `round(x, king_fn)` takes this
    party's local tensors (no party axis) and returns this party's output
    shard."""

    def __init__(self, n: int, threshold: int, role, my_id: int):
        self.n_parties = n
        self.threshold = threshold
        self.role = role
        self.my_id = my_id
        self.rounds = 0
        self.bytes_out = 0
        self.bytes_in = 0
        self.times: dict = {}

    def stats(self) -> dict:
        return {"rounds": self.rounds, "bytes_out": self.bytes_out, "bytes_in": self.bytes_in}

    @classmethod
    def make_king(cls, n: int, threshold: int, bind=("127.0.0.1", 0), timeout=30.0,
                  tls_ctx=None):
        return cls(n, threshold, StarKing(n, bind=bind, timeout=timeout, tls_ctx=tls_ctx), 0)

    @classmethod
    def make_client(cls, n: int, threshold: int, party_id: int, king_addr, timeout=30.0,
                    tls_ctx=None):
        client = StarClient(party_id, king_addr, timeout=timeout, tls_ctx=tls_ctx)
        return cls(n, threshold, client, party_id)

    @property
    def port(self):
        return self.role.port

    def accept_all(self):
        self.role.accept_all()

    def round(self, x, king_fn, channel: int = 0):
        if not 0 <= channel < 16:
            raise ValueError("logical channels 0..15 (wire ids alias otherwise)")
        self.rounds += 1
        channel = channel + 16 * self.rounds  # unique wire channel per round
        t = self.times
        if self.my_id != 0:
            with span("ser", t):
                blob = ser(x)
            self.bytes_out += len(blob)
            self.role.send(blob, channel)
            with span("wait", t):
                data = self.role.recv(channel)
            self.bytes_in += len(data)
            with span("deser", t):
                return deser_like(data, x)
        with span("wait", t):
            rb = self.role.gather(b"", channel, self.threshold)  # row 0 is x itself
        blobs = [s for s in rb.shares[1:] if s is not None]
        self.bytes_in += sum(len(s) for s in blobs)
        with span("deser", t):
            shares = [x] + [deser_like(s, x) for s in blobs]
        with span("king", t):
            out = king_fn(_stack(shares), rb.parties)  # leading axis n
        with span("ser", t):
            payloads = [None] + [ser(_map(lambda a: a[pid], out))
                                 for pid in range(1, self.n_parties)]
        self.bytes_out += sum(len(p) for p in payloads[1:])
        with span("scatter", t):
            self.role.scatter(payloads, channel)
        return _map(lambda a: a[0], out)

    def close(self):
        self.role.close()
