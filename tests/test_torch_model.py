"""PyTorch port: PIDNet blocks, the whole model, BN folding and the weight
converters against the JAX package on the CPU, from the same seeded numpy
weights and inputs."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pidnet_tpu.convert import fold_params
from pidnet_tpu.convert.torch_weights import export_state_dict
from pidnet_tpu.models import pidnet as JM
from pidnet_tpu_torch.convert import weights as W
from pidnet_tpu_torch.convert.fold import fold_state_dict
from pidnet_tpu_torch.models import pidnet as M

torch.set_num_threads(2)

TRAINED_WEIGHTS = os.path.join(
    os.path.dirname(__file__), "..", "runs", "train2k", "weights_f16.npz"
)


def _random_sd(module: torch.nn.Module, rng) -> dict:
    """Seeded numpy values for every tensor of `module` (BN statistics
    kept away from the identity, as tests/test_blocks.py does)."""
    sd = {}
    for k, v in module.state_dict().items():
        if k.endswith("running_var"):
            arr = 0.5 + rng.random(v.shape)
        else:
            arr = rng.standard_normal(v.shape) * 0.3
        sd[k] = torch.from_numpy(arr.astype(np.float32))
    module.load_state_dict(sd)
    return sd


def _jax_ops(sd: dict, prefix: str):
    params, state = W.to_jax({prefix + k: v for k, v in sd.items()})
    return JM._ApplyOps(params, state, train=False, sync_axis=None, compute_dtype=None,
                        folded=False)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


# (port module, JAX block call, input shapes NHWC)
BLOCKS = {
    "basic_identity": (lambda: M.BasicBlock(16, 16, folded=False),
                       lambda ops, xs: JM._basic_block(ops, "b", xs[0], 16), [(2, 8, 12, 16)]),
    "basic_stride2_no_relu": (lambda: M.BasicBlock(16, 32, 2, True, folded=False),
                              lambda ops, xs: JM._basic_block(ops, "b", xs[0], 32, 2, True),
                              [(2, 8, 12, 16)]),
    "bottleneck_downsample": (lambda: M.Bottleneck(16, 16, folded=False),
                              lambda ops, xs: JM._bottleneck(ops, "b", xs[0], 16),
                              [(1, 8, 12, 16)]),
    "bottleneck_stride2_relu": (lambda: M.Bottleneck(32, 16, 2, False, folded=False),
                                lambda ops, xs: JM._bottleneck(ops, "b", xs[0], 16, 2, False),
                                [(1, 8, 12, 32)]),
    "segmenthead": (lambda: M.SegHead(16, 24, 19, folded=False),
                    lambda ops, xs: JM._segmenthead(ops, "b", xs[0], 24, 19), [(1, 8, 12, 16)]),
    "segmenthead_scale": (lambda: M.SegHead(16, 24, 19, 8, folded=False),
                          lambda ops, xs: JM._segmenthead(ops, "b", xs[0], 24, 19, 8),
                          [(1, 8, 12, 16)]),
    "pappm": (lambda: M.PAPPM(32, 8, 16, folded=False),
              lambda ops, xs: JM._pappm(ops, "b", xs[0], 8, 16), [(1, 16, 32, 32)]),
    "dappm": (lambda: M.DAPPM(32, 8, 16, folded=False),
              lambda ops, xs: JM._dappm(ops, "b", xs[0], 8, 16), [(1, 16, 32, 32)]),
    "light_bag": (lambda: M.LightBag(16, 16, folded=False),
                  lambda ops, xs: JM._light_bag(ops, "b", *xs, 16), [(1, 8, 12, 16)] * 3),
    "bag": (lambda: M.Bag(16, 16, folded=False),
            lambda ops, xs: JM._bag(ops, "b", *xs, 16), [(1, 8, 12, 16)] * 3),
}
for _wc, _ar in [(False, False), (True, False), (False, True), (True, True)]:
    BLOCKS[f"pagfm_channel{int(_wc)}_relu{int(_ar)}"] = (
        lambda wc=_wc, ar=_ar: M.PagFM(32, 16, ar, wc, folded=False),
        lambda ops, xs, wc=_wc, ar=_ar: JM._pagfm(ops, "b", *xs, 16, after_relu=ar,
                                                   with_channel=wc),
        [(2, 16, 24, 32), (2, 8, 12, 32)],
    )


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(rng, name):
    make, jax_fn, shapes = BLOCKS[name]
    module = make().eval()
    sd = _random_sd(module, rng)
    xs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want = np.asarray(jax_fn(_jax_ops(sd, "b."), [jnp.asarray(x) for x in xs]))
    with torch.no_grad():
        got = module(*(_nchw(x) for x in xs)).permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["pidnet_s", "pidnet_m", "pidnet_l"])
@pytest.mark.parametrize("augment", [True, False])
def test_state_dict_keys_equal_jax_names(name, augment):
    """Unfolded keys = the JAX params+state names; folded keys = the JAX
    fold_params names without its space-to-depth stem copies."""
    jspec = JM.spec_for(name, 19, augment)
    traced = JM.trace_spec(jspec)
    want = {n + ".weight" for n in traced.convs}
    want |= {n + ".bias" for n, (_, _, _, bias) in traced.convs.items() if bias}
    for bn in traced.bns:
        want |= {bn + s for s in (".weight", ".bias", ".running_mean", ".running_var")}
    spec = M.spec_for(name, 19, augment)
    with torch.device("meta"):
        model = M.PIDNet(spec)
        folded_model = M.PIDNet(spec, folded=True)
    assert set(model.state_dict()) == want
    assert sorted(model.conv_bn_pairs()) == sorted(traced.fold_pairs)
    params = {n + ".weight": np.zeros((k, k, cin_g, cout), np.float32)
              for n, (k, cin_g, cout, _) in traced.convs.items()}
    params.update({n + ".bias": np.zeros(cout, np.float32)
                   for n, (_, _, cout, bias) in traced.convs.items() if bias})
    state = {}
    for bn, ch in traced.bns.items():
        params[bn + ".weight"] = params[bn + ".bias"] = np.zeros(ch, np.float32)
        state[bn + ".running_mean"] = state[bn + ".running_var"] = np.ones(ch, np.float32)
    jfolded = {k for k in fold_params(params, state, jspec) if not k.startswith("s2d.")}
    assert set(folded_model.state_dict()) == jfolded
    # OIHW shapes
    for k, v in model.state_dict().items():
        jv = params.get(k, state.get(k))
        assert tuple(v.shape) == (tuple(np.transpose(jv, (3, 2, 0, 1)).shape)
                                  if jv.ndim == 4 else jv.shape), k


def _trained():
    sd = W.load_npz(TRAINED_WEIGHTS)
    params, state = W.to_jax(sd)
    return sd, params, state


def test_pidnet_s_augment_matches_jax_all_heads(rng):
    """Whole model, three heads, trained weights: the aux heads read the
    relu'd temp_p/temp_d exactly as the JAX model (and the reference's
    inplace ReLU) does."""
    sd, params, state = _trained()
    x = rng.standard_normal((1, 64, 128, 3)).astype(np.float32)
    jspec = JM.spec_for("pidnet_s", 19, augment=True)
    want = [np.asarray(o) for o in JM.apply(params, state, jnp.asarray(x), jspec)]
    model = M.build(M.spec_for("pidnet_s", 19, augment=True), sd, device="cpu")
    with torch.no_grad():
        got = [o.numpy() for o in model(torch.from_numpy(x))]
    assert [g.shape for g in got] == [(1, 8, 16, 19), (1, 8, 16, 19), (1, 8, 16, 1)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=5e-4)


def test_pidnet_l_matches_jax(rng):
    """L (DAPPM, Bag, 4-block stages) with JAX init weights and BN
    statistics perturbed away from the identity; variances in [1.2, 1.6]
    keep the logits O(1) (at the identity they grow with depth)."""
    jspec = JM.spec_for("pidnet_l", 19, augment=False)
    params, state = JM.init(jax.random.PRNGKey(1), jspec)
    params = {k: np.asarray(v) for k, v in params.items()}
    for k, v in params.items():
        if v.ndim == 1:
            params[k] = (v + rng.standard_normal(v.shape) * 0.05).astype(np.float32)
    state = {k: (1.2 + 0.4 * rng.random(v.shape) if "var" in k
                 else rng.standard_normal(v.shape) * 0.05).astype(np.float32)
             for k, v in state.items()}
    x = rng.standard_normal((1, 64, 128, 3)).astype(np.float32)
    want = np.asarray(JM.apply(params, state, jnp.asarray(x), jspec))
    model = M.build(M.spec_for("pidnet_l", 19, augment=False), W.from_jax(params, state),
                    device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (1, 8, 16, 19)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=5e-4)


def test_folded_port_matches_unfolded_jax(rng):
    sd, params, state = _trained()
    spec = M.spec_for("pidnet_s", 19, augment=False)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    want = np.asarray(JM.apply(params, state, jnp.asarray(x), JM.spec_for("pidnet_s", 19, False)))
    model = M.build(spec, fold_state_dict(sd, spec), folded=True, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_fold_matches_jax_fold_params(rng):
    """Folded tensors equal JAX fold_params' (OIHW), the stem's own conv
    bias included."""
    spec = M.spec_for("pidnet_m", 19, augment=False)
    jspec = JM.spec_for("pidnet_m", 19, augment=False)
    params, state = JM.init(jax.random.PRNGKey(2), jspec)
    state = {k: (np.abs(np.asarray(v)) + 0.5 if "var" in k else np.asarray(v) + 0.1)
             for k, v in state.items()}
    want = fold_params(params, state, jspec)
    got = fold_state_dict(W.from_jax(params, state), spec)
    fp, _ = W.to_jax(got)
    assert "conv1.0.bias" in fp
    for k, v in fp.items():
        np.testing.assert_allclose(v, np.asarray(want[k]), rtol=1e-6, atol=1e-7, err_msg=k)


def test_from_jax_to_jax_round_trip_exact(rng):
    sd, params, state = _trained()
    p2, s2 = W.to_jax(W.from_jax(params, state))
    assert p2.keys() == params.keys() and s2.keys() == state.keys()
    for k in params:
        np.testing.assert_array_equal(p2[k], params[k])
    for k in state:
        np.testing.assert_array_equal(s2[k], state[k])
    assert sd["conv1.0.weight"].shape == (32, 3, 3, 3)
    assert all(v.dtype == torch.float32 for v in sd.values())


def test_pt_checkpoint_with_model_prefix_loads(tmp_path):
    """A reference `.pt` (FullModel `model.` prefix, num_batches_tracked)
    written by the JAX exporter loads through the port unchanged."""
    sd, params, state = _trained()
    exported = export_state_dict(params, state)  # "model." + OIHW
    payload = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in exported.items()}
    payload["model.conv1.1.num_batches_tracked"] = torch.tensor(7)
    path = str(tmp_path / "ckpt.pt")
    torch.save(payload, path)
    loaded = W.load(path)
    assert loaded.keys() == sd.keys()
    for k in sd:
        assert torch.equal(loaded[k], sd[k]), k
    tar = str(tmp_path / "imagenet.pth.tar")
    torch.save({"state_dict": {k[6:]: v for k, v in payload.items()}}, tar)
    assert W.load(tar).keys() == sd.keys()
    assert W.normalize_keys({"model.a": 1, "b.num_batches_tracked": 2, "c": 3}) == {"a": 1, "c": 3}


def test_build_ignores_unused_heads_and_requires_the_rest():
    sd, _, _ = _trained()
    spec = M.spec_for("pidnet_s", 19, augment=False)
    model = M.build(spec, sd, device="cpu")  # sd carries seghead_p/seghead_d
    assert not any(k.startswith("seghead") for k in model.state_dict())
    del sd["final_layer.conv2.bias"]
    with pytest.raises(KeyError, match="lacks 1"):
        M.build(spec, sd, device="cpu")


def test_init_is_kaiming_fan_out():
    spec = M.spec_for("pidnet_s", 19, augment=True)
    sd = M.init(spec, torch.Generator().manual_seed(0))
    with torch.device("meta"):
        assert sd.keys() == M.PIDNet(spec).state_dict().keys()
    w = sd["layer4.0.conv1.weight"]  # (256, 128, 3, 3): fan_out 256*9
    assert abs(w.std().item() - (2.0 / (256 * 9)) ** 0.5) < 2e-3
    assert torch.equal(sd["spp.scale1.1.running_var"], torch.ones(512))
    b = sd["conv1.0.bias"]
    assert b.abs().max().item() <= 1 / 27 ** 0.5
    again = M.init(spec, torch.Generator().manual_seed(0))
    assert all(torch.equal(again[k], sd[k]) for k in sd)
