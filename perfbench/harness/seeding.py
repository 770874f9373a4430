"""Seeds of the benchmark's inputs: one ``torch.Generator`` per input, its
state derived from ``--seed`` and the input's tags, so that the same seed
gives the same inputs on any device count and in any job order."""
from __future__ import annotations

import numpy as np
import torch


def derive(seed: int, *tags) -> int:
    """A 63-bit seed from ``seed`` (any whole number) and integer or string
    tags."""
    words = [int(seed) % (1 << 64)]
    for t in tags:
        words.append(int.from_bytes(t.encode(), "little") if isinstance(t, str) else int(t))
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1


def generator(seed: int, *tags, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive(seed, *tags))
    return g
