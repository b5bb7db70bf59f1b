"""Explicit random streams: torch.Generators in place of jax.random keys.

`split(gen, n)` mirrors jax.random.split: n independent CPU generators,
seeded from draws of `gen`, so every consumer of randomness takes its own
stream and the draws do not depend on the order of unrelated calls.
The generators live on the CPU and advance alike whatever the device:
Field.rand draws only a ChaCha20 key from one and makes its elements on
the tensors' device (fields/field.py), so a seed gives the same values on
every device.
"""

from __future__ import annotations

import torch


def generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def split(gen: torch.Generator, n: int) -> list[torch.Generator]:
    seeds = torch.randint(0, 2**62, (n,), generator=gen, dtype=torch.int64)
    return [generator(int(s)) for s in seeds]
