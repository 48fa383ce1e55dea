"""``model: deeplabv2``: DeepLabV2 on a dilated ResNet (``reference/deeplab.py``).

Keys: ``num_classes``, ``layers``, ``aspp_width``, ``gn_groups``,
``aspp_dilations``, ``dropout``.  One random draw a train-mode forward:
the head's channel dropout.
"""

from __future__ import annotations

from ..deeplab import DeepLabV2


def build(config: dict) -> DeepLabV2:
    return DeepLabV2(config["num_classes"], tuple(config["layers"]), config["aspp_width"],
                     config["gn_groups"], tuple(config["aspp_dilations"]), config["dropout"])
