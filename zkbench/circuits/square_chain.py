"""x -> x^(2^k): a circuit of k squarings and one public output.

Parameters: `squarings` (k).  The circuit of the port's CPU prove tests
(examples/e2e_small.py), small enough to prove on the CPU, where the
benchmark's own tests drive the harness.
"""

from __future__ import annotations

import random

from ..r1cs import Circuit, ConstraintBuilder


def draw_inputs(params: dict, rng: random.Random) -> list[int]:
    return [rng.getrandbits(64) | 2]


def statement(params: dict, inputs, p: int) -> list[int]:
    return [pow(inputs[0], 1 << params["squarings"], p)]


def synthesize(params: dict, inputs, p: int) -> Circuit:
    cb = ConstraintBuilder(p)
    x = cb.witness(inputs[0])
    for _ in range(params["squarings"]):
        x = cb.mul(x, x)
    out = cb.pub_input(cb._val(x))
    cb.constrain([(1, x)], [(1, 0)], [(1, out)])
    return cb.finalize()
