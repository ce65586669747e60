"""What the harness takes from the program: its model spec for a
configuration, held to the configuration's numbers."""

from __future__ import annotations

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
SPEC_KEYS = ("m", "n", "planes", "ppm_planes", "head_planes", "num_classes")


def spec_of(config: dict, augment: bool):
    """The program's spec of the configuration's model name
    (`tools.common.spec_from_name`, the CLIs' own); raises where one of its
    sizes differs from the configuration's."""
    from pidnet_tpu_torch.tools.common import spec_from_name

    spec = spec_from_name(config["name"], config["num_classes"], augment=augment)
    for key in SPEC_KEYS:
        if getattr(spec, key) != config[key]:
            raise ValueError(f"the program's {config['name']} has {key} {getattr(spec, key)}, "
                             f"the configuration {config[key]}")
    return spec
