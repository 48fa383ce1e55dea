"""``model: hrnet_ocr``: HRNet with OCR and its aux head (``reference/hrnet_ocr.py``).

Keys: ``num_classes``, ``hrnet`` (the stem, stage 1, each later stage as
[modules, blocks, channels], the OCR widths), ``dropout``.  One random
draw a train-mode forward: the OCR head's channel dropout.
"""

from __future__ import annotations

from ..hrnet_ocr import HRNetOCR


def build(config: dict) -> HRNetOCR:
    arch = dict(config["hrnet"])
    arch["stages"] = [(m, b, tuple(c)) for m, b, c in arch["stages"]]
    return HRNetOCR(config["num_classes"], arch, config["dropout"])
