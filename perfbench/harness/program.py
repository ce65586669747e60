"""What the harness takes from the program: its model spec for a
configuration, held to the configuration's numbers."""

from __future__ import annotations

import dataclasses

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def spec_of(config: dict, augment: bool):
    """The program's spec of the configuration's model name
    (`tools.common.spec_from_name`, the CLIs' own), held to the
    configuration: its `family` must name the program's module that
    defines the spec (`models/<family>.py`), since the reference is found
    by that key, and it must carry every size of the spec, each field of
    its dataclass but `augment`, at the same value. Raises otherwise,
    naming the key."""
    from pidnet_tpu_torch.tools.common import spec_from_name

    name = config["name"]
    spec = spec_from_name(name, config.get("num_classes"), augment=augment)
    family = type(spec).__module__.rsplit(".", 1)[-1]
    if config.get("family") != family:
        raise ValueError(f"the program's {name} is of family {family!r}, "
                         f"the configuration's family {config.get('family')!r}")
    for field in dataclasses.fields(spec):
        if field.name == "augment":
            continue
        mine = getattr(spec, field.name)
        if field.name not in config:
            raise ValueError(f"the configuration of {name} lacks {field.name} "
                             f"(the program's is {mine})")
        if mine != config[field.name]:
            raise ValueError(f"the program's {name} has {field.name} {mine}, "
                             f"the configuration {config[field.name]}")
    return spec
