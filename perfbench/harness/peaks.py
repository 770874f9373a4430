"""Published peaks of the cards the benchmark knows (NVIDIA's data sheet:
the H100 SXM part, dense float32 outside the tensor cores, HBM3), at the
card's full power limit.  A card that is not listed has no roofline."""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flop_per_s": 67e12, "hbm_byte_per_s": 3.35e12},
}

