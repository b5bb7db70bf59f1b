"""Checkpoint/resume of a running proof: a round journal.

Port of zksaas_tpu/comm/journal.py.  Neither the reference nor the paper
checkpoints a running proof ("restart = rerun", SURVEY §5).  Every
distributed primitive is a sequence of `net.round(x, king_fn)` calls, each
a pure function of dealer artifacts (shares, masks, generators) that are
durable by construction, so a checkpoint is the per-party log of completed
round outputs:

* `JournalNet` wraps any backend (`LocalNet`, `HostStarNet`).  Each
  completed round's output is written atomically (tmp file, fsync,
  rename) to `<dir>/round_NNNN.ckpt` before it is returned to the caller.
* On restart, the SAME prover code runs with a fresh `JournalNet` over the
  same directory: recorded rounds replay from disk (no network, no king
  compute) onto the device of the round's input, and the first unrecorded
  round continues live.

A record is the round's output in the wire format of comm/host_net.py (an
npz archive of its tensors, read with allow_pickle=False); the nesting
comes from the round's input, which every protocol round shares with its
output.  The JAX package pickles its records; this format cannot run code
when it is read.

Multi-process resume: after a crash, journals may have different lengths
(the crashed party is typically one round behind).  `negotiate_resume()`
runs one live round, gathers the journal lengths to the king and scatters
the minimum, and truncates replay to that common prefix, so all parties
re-enter live execution on the same round.  Wire channels stay aligned
because replayed rounds never touch the inner net.
"""

from __future__ import annotations

import os

import torch

from .host_net import deser_like, ser


def _record_path(dir_: str, idx: int) -> str:
    return os.path.join(dir_, f"round_{idx:04d}.ckpt")


def _write_atomic(path: str, out) -> None:
    blob = ser(out)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # atomic: a record exists iff it is complete


def _read(path: str, like):
    with open(path, "rb") as f:
        return deser_like(f.read(), like)


class JournalNet:
    """Round-journaling wrapper around any star-protocol backend."""

    def __init__(self, inner, dir_: str):
        self.inner = inner
        self.dir = dir_
        os.makedirs(dir_, exist_ok=True)
        self.n_parties = inner.n_parties
        self.rounds = 0  # rounds served (replayed + live)
        self.replayed = 0
        self._limit = self._recorded_len()

    def _recorded_len(self) -> int:
        """Length of the contiguous recorded prefix."""
        n = 0
        while os.path.exists(_record_path(self.dir, n)):
            n += 1
        return n

    def negotiate_resume(self) -> int:
        """Agree on the common journal prefix across parties (call once
        before the proof when resuming a multi-process run): one live round
        gathers each party's recorded length and scatters the minimum;
        replay is truncated to it.  Returns the resume round."""
        mine = torch.tensor([self._recorded_len()], dtype=torch.int32)

        def king_min(stacked, parties):
            return stacked.min().expand(self.n_parties, 1)

        agreed = int(self.inner.round(mine, king_min).reshape(-1)[0])
        recorded = self._recorded_len()
        self._limit = min(self._limit, agreed)
        # records past the common prefix run again live, and may differ (a
        # changed survivor set routes the king through the Lagrange path)
        for i in range(self._limit, recorded):
            os.unlink(_record_path(self.dir, i))
        return self._limit

    def round(self, x, king_fn, channel: int = 0):
        idx = self.rounds
        self.rounds += 1
        path = _record_path(self.dir, idx)
        if idx < self._limit:
            self.replayed += 1
            return _read(path, x)
        out = self.inner.round(x, king_fn, channel)
        _write_atomic(path, out)
        return out

    def clear(self) -> None:
        """Drop the journal (after the proof is delivered)."""
        for i in range(self._recorded_len()):
            os.unlink(_record_path(self.dir, i))
        self._limit = 0

    def stats(self) -> dict:
        base = self.inner.stats() if hasattr(self.inner, "stats") else {}
        return {**base, "rounds": self.rounds, "replayed": self.replayed}

    def close(self):
        if hasattr(self.inner, "close"):
            self.inner.close()
