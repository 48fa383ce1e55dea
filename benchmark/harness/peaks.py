"""Published peaks of the cards the benchmark knows (NVIDIA's data sheets,
SXM parts, dense rates).  A roofline share or an MFU is stated against
these, with the card's power limit printed beside it."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Peaks:
    bf16_flops_per_s: float
    f32_flops_per_s: float
    hbm_bytes_per_s: float


TABLE = {
    "H100": Peaks(bf16_flops_per_s=989e12, f32_flops_per_s=67e12, hbm_bytes_per_s=3.35e12),
}


def for_device(name: str) -> Peaks:
    for key, peaks in TABLE.items():
        if key in name:
            return peaks
    raise ValueError(f"no published peaks for {name!r}; known: {sorted(TABLE)}")
