"""Faults planted under the timed path, to show that `correct` catches them.

Each fault patches the program in this process for the length of a `with`
block; the harness runs as it always does on top of it.

The controls break a guarantee the configurations state, as a tempting
shortcut would:
  rs_reused       every proof after the first reuses the first proof's r and
                  s shares (the proofs still pass the pairing check);
  masks_reused    every proof after the first reuses the first proof's masks
                  (the proofs are still right, the MPC's privacy is gone);
  fft_masks_reused  every proof after the first reuses the first proof's six
                  FFT masks, and draws the rest fresh (the proofs are right);
  degred_half_stale  every proof after the first keeps the first proof's
                  degree-reduction mask for the first half of its chunks
                  (chunks are masked apart, so the proofs are right).
The faults break the computation:
  stale_proof     d_prove returns its first proof again (state unchanged);
  half_witness    the MSMs see only the first half of the witness's chunks;
  lost_exchange   every LocalNet round hands the king party 0's message in
                  place of party 1's;
  altered_answer  one limb of party 0's share of C is changed where d_prove
                  produces it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect

CONTROLS = ("rs_reused", "masks_reused", "fft_masks_reused", "degred_half_stale")
FAULTS = ("stale_proof", "half_witness", "lost_exchange", "altered_answer")


def _first_calls(fn, keep: int):
    """fn, returning the first `keep` results again, in turn, after its
    first `keep` calls."""
    seen: list = []

    def wrapped(*args, **kwargs):
        if len(seen) < keep:
            seen.append(fn(*args, **kwargs))
            return seen[-1]
        out = seen[wrapped.calls % keep]
        wrapped.calls += 1
        return out

    wrapped.calls = 0
    return wrapped


@contextlib.contextmanager
def planted(name: str):
    from zksaas_tpu_torch.comm import net as net_mod
    from zksaas_tpu_torch.groth16 import prove

    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, inspect.getattr_static(obj, attr)))
        setattr(obj, attr, value)

    if name == "rs_reused":  # r's and s's sharings alternate
        patch(prove, "pack_scalar_repeated", _first_calls(prove.pack_scalar_repeated, 2))
    elif name == "masks_reused":
        patch(prove.ProveMasks, "sample", staticmethod(_first_calls(prove.ProveMasks.sample, 1)))
    elif name in ("fft_masks_reused", "degred_half_stale"):
        sample, first = prove.ProveMasks.sample, []

        def part_reused(*args, **kw):
            masks = sample(*args, **kw)
            if not first:
                first.append(masks)
            elif name == "fft_masks_reused":
                masks = dataclasses.replace(masks, fft_masks=first[0].fft_masks)
            else:
                old, new = first[0].degred_mask, masks.degred_mask
                half = new.in_mask.shape[1] // 2
                new.in_mask[:, :half] = old.in_mask[:, :half]
                new.out_mask[:, :half] = old.out_mask[:, :half]
            return masks

        patch(prove.ProveMasks, "sample", staticmethod(part_reused))
    elif name == "stale_proof":
        patch(prove, "d_prove", _first_calls(prove.d_prove, 1))
    elif name == "half_witness":
        d_prove = prove.d_prove

        def half(pp, g1, g2, crs, qap, a_share, ax_share, *rest, **kw):
            cut = a_share.clone()
            cut[:, a_share.shape[1] // 2:] = 0
            return d_prove(pp, g1, g2, crs, qap, cut, ax_share, *rest, **kw)

        patch(prove, "d_prove", half)
    elif name == "lost_exchange":
        round_ = net_mod.LocalNet.round

        def lossy(self, x, king_fn, channel=0):
            def swap(t):
                t = t.clone()
                t[1] = t[0]
                return t

            return round_(self, net_mod._map(swap, x), king_fn, channel)

        patch(net_mod.LocalNet, "round", lossy)
    elif name == "altered_answer":
        d_prove = prove.d_prove

        def altered(*args, **kw):
            a, b, c = d_prove(*args, **kw)
            x = c[0].clone()
            x.view(-1)[0] ^= 1
            return a, b, (x,) + tuple(c[1:])

        patch(prove, "d_prove", altered)
    else:
        raise ValueError(f"no fault named {name!r}")
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)
