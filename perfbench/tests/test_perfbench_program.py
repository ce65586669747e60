"""`harness.program.spec_of` on configurations of each family the port
builds, held in memory and named as `tools.common.spec_from_name` takes
them: the program's spec at the family's own sizes, and a refusal that
names the key for a size missing or off by one and for a family that
names another."""

import dataclasses

import pytest

from perfbench.harness.program import spec_of

# The port's sizes of each family, written out here and not read from the
# program, so that a spec that drifts from them fails.
CONFIGS = {
    "pidnet": {"name": "pidnet_small", "family": "pidnet", "num_classes": 19, "m": 2, "n": 3,
               "planes": 32, "ppm_planes": 96, "head_planes": 128},
    "ddrnet": {"name": "ddrnet_23_adb_bag", "family": "ddrnet", "num_classes": 19, "m": 2,
               "planes": 64, "spp_planes": 128, "head_planes": 128},
    "bisenet": {"name": "bisenet_adb_bag", "family": "bisenet", "num_classes": 19},
}
SIZES = [(family, key) for family, config in CONFIGS.items()
         for key in config if key not in ("name", "family")]
# num_classes is what the spec is built with, so it cannot differ from the
# spec's; every other size is the program's own.
FIXED = [(family, key) for family, key in SIZES if key != "num_classes"]


@pytest.mark.parametrize("family", CONFIGS)
@pytest.mark.parametrize("augment", [False, True])
def test_the_programs_spec_at_the_familys_sizes(family, augment):
    sizes = {k: v for k, v in CONFIGS[family].items() if k not in ("name", "family")}
    spec = spec_of(CONFIGS[family], augment)
    assert type(spec).__module__ == f"pidnet_tpu_torch.models.{family}"
    assert {f.name for f in dataclasses.fields(spec)} == {*sizes, "augment"}
    assert {k: getattr(spec, k) for k in sizes} == sizes and spec.augment is augment


@pytest.mark.parametrize("family,key", SIZES)
def test_a_missing_size_is_named(family, key):
    config = {k: v for k, v in CONFIGS[family].items() if k != key}
    with pytest.raises(ValueError, match=rf"lacks {key}\b"):
        spec_of(config, True)


@pytest.mark.parametrize("family,key", FIXED)
def test_a_size_off_by_one_is_named(family, key):
    config = {**CONFIGS[family], key: CONFIGS[family][key] + 1}
    with pytest.raises(ValueError, match=rf"has {key} {CONFIGS[family][key]}, "
                                         rf"the configuration {CONFIGS[family][key] + 1}$"):
        spec_of(config, True)


@pytest.mark.parametrize("family,other", [(f, o) for f in CONFIGS for o in CONFIGS if o != f])
def test_a_family_that_names_another_is_named(family, other):
    config = {**CONFIGS[family], "family": other}
    with pytest.raises(ValueError, match=rf"family {family!r}, the configuration's family "
                                         rf"{other!r}"):
        spec_of(config, True)
