"""Order statistics of the benchmark, with no device in them."""
from __future__ import annotations

import math
import random
import statistics


def nearest_rank(values, q: float) -> float:
    """The ``q``-quantile (0 < q <= 1) by nearest rank: the smallest value
    with at least a share ``q`` of the values at or below it, so that at
    least ``n - ceil(q n)`` values lie beyond it."""
    if not values:
        raise ValueError("no values")
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def spread(values) -> float:
    """The distance between the first and the third quartile
    (``statistics.quantiles(values, n=4)``) as a share of the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length, drawn
    from ``seed``: the same seed and stream give the same sample."""

    def __init__(self, k: int, seed: int):
        self.k = int(k)
        self.rng = random.Random(seed)
        self.items = []
        self.seen = 0

    def offer(self, item):
        """Offer ``item``; returns the item that is not kept (``item``
        itself, or the one it replaced), or None."""
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return None
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j], item = item, self.items[j]
        return item
