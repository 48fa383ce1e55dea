"""One run's random streams, all derived from ``--seed``.

Any whole number is a seed (negative ones are taken modulo 2**64); each
stream is a 63-bit integer drawn from ``numpy.random.SeedSequence``, so the
same seed gives the same weights, inputs and draws on every machine.
"""

from __future__ import annotations

import numpy as np

STREAMS = ("weights", "translator", "data", "draws", "dropout_student", "dropout_teacher",
           "sample")


def streams(seed: int) -> dict[str, int]:
    ss = np.random.SeedSequence(int(seed) % 2**64)
    words = ss.generate_state(2 * len(STREAMS), dtype=np.uint32)
    return {name: int(words[2 * i]) << 31 | int(words[2 * i + 1]) >> 1
            for i, name in enumerate(STREAMS)}
