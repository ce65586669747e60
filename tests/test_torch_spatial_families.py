"""PyTorch port, spatial partitioning of DDRNet-23 and BiSeNetV1 on the CPU
(parallel/spatial.max_pool_rows and global_pool_rows, the families'
declarations for models/pidnet.spatial_sharding, FullLoss and the spatial
steps with three segmentation heads at scale 1, the engine's sharded
class map and the CLIs' --spatial), held against the JAX package's
spatial functions (pidnet_tpu/parallel/spatial.py) on the conftest's
virtual CPU devices.

As in tests/test_torch_spatial.py: the port's ranks are gloo processes
spawned by parallel/launch.py, JAX runs only in the parent's oracle
fixture, the JAX steps run their plain layouts (stem_s2d=False,
wfold=False), and the weights are the port's seeded init carried to the
JAX package by convert.weights.to_jax.

BiSeNet's steps take 4 samples where the other steps take 2: its BNs after
each global pool normalise an (N, C, 1, 1) vector in training mode, and
over the pooled vectors of 2 noise frames, which nearly coincide, they
amplify fp32 rounding. On one device its own step's update moves to
cosine 0.988 under a 1e-7 relative perturbation of the input at 2
samples, and to 0.999997 at 4 (scripts/bisenet_conditioning.py on the
CPU), so at 2 samples any two correct implementations differ by more than
the step's bound.
"""

import glob
import os

import numpy as np
import pytest
import torch
from test_torch_spatial import LOSS_KW, _close_step, _jax_state, _Writer

from pidnet_tpu_torch import engine
from pidnet_tpu_torch.data.png import write_png
from pidnet_tpu_torch.losses.criterion import FullLoss
from pidnet_tpu_torch.models import pidnet as M
from pidnet_tpu_torch.parallel import launch
from pidnet_tpu_torch.parallel import spatial as SP
from pidnet_tpu_torch.tools import common
from pidnet_tpu_torch.train.step import (TrainState, make_spatial_eval_step,
                                         make_spatial_train_step)

torch.set_num_threads(2)

H = 128  # 1/32 is 4 rows: 2 a shard on (1, 2)
NAMES = ["ddrnet_23", "bisenet"]
OUTPUT_INDEX = {"ddrnet_23": 1, "bisenet": 2}  # the final head
TRAIN_N = {"ddrnet_23": 2, "bisenet": 4}  # the module docstring
# the BNs on BiSeNet's pooled vectors, replicated over a spatial row
REPLICATED_BN = ("cp.arm32.bn_atten.running_var", "ffm.bn.running_var")


def _spec(name):
    return common.spec_from_name(name, 19)


def _loss(name) -> FullLoss:
    bw = M.balance_weights(_spec(name))
    return FullLoss(num_outputs=len(bw), balance_weights=bw, **LOSS_KW)


def _batch(n, seed=11):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((n, H, H, 3)).astype(np.float32)
    lab = rng.integers(0, 19, (n, H, H)).astype(np.int32)
    lab[0, :8] = 255
    edge = (rng.random((n, H, H)) < 0.1).astype(np.float32)
    return img, lab, edge


def _cfg(name):
    return engine.config(num_outputs=M.module_for(_spec(name)).seg_heads, align_corners=True,
                         output_index=OUTPUT_INDEX[name])


# ---------------------------------------------------------------------------
# A network that declares no spatial parts
# ---------------------------------------------------------------------------


def test_network_without_spatial_parts_raises():
    """A Network that declares no `replicated` parts raises TypeError under
    spatial_sharding before it runs, and leaves no module sharded."""

    class Plain(M.Network):
        def __init__(self):
            super().__init__()
            self.conv = M.Conv2d(3, 4, 3)

        def forward(self, x):
            raise AssertionError("ran")

    model = Plain()
    with pytest.raises(TypeError, match="declares no spatial parts"):
        with M.spatial_sharding(model, SP.make_mesh_2d(1, 1, "cpu")):
            model(torch.zeros(1, 8, 8, 3))
    assert model.conv.spatial is None


@pytest.mark.parametrize("name", NAMES)
def test_families_declare_their_spatial_parts(name):
    """Under spatial_sharding every BN of a replicated part takes the
    replicated sync and every other BN the mesh; the k > 1 convs outside
    the replicated parts and the modules with a `spatial` attribute take
    the mesh; all of it is undone on exit."""
    spec = _spec(name)
    with torch.device("meta"):
        model = M.module_for(spec)(spec)
    mesh = SP.make_mesh_2d(1, 1, "cpu")
    inside = {id(m) for n in model.replicated for m in model.get_submodule(n).modules()}
    with M.spatial_sharding(model, mesh):
        for m in model.modules():
            if isinstance(m, M.BatchNorm):
                want = SP.replicated_sync(mesh) if id(m) in inside else mesh.world
                assert m.sync == want
            elif isinstance(m, M.Conv2d):
                assert (m.spatial is mesh) == (id(m) not in inside and m.weight.shape[-1] > 1)
            elif hasattr(m, "spatial"):
                assert m.spatial is mesh
        sevens = {n for n, m in model.named_modules()
                  if isinstance(m, M.Conv2d) and m.spatial is mesh and m.weight.shape[-1] == 7}
    assert sevens == ({"cp.resnet.conv1", "sp.conv1.conv"} if name == "bisenet" else set())
    assert all(getattr(m, "spatial", None) is None and getattr(m, "sync", None) is None
               for m in model.modules())


# ---------------------------------------------------------------------------
# Ranks
# ---------------------------------------------------------------------------


def _rows_op(mesh, whole, own, sharded, full_fn, rng):
    """(forward max-abs error, backward max-abs error, gradcheck) of a
    row-sharded op against `full_fn` on the whole fp64 tensor: the rank's
    rows of the output, the gradient of the sum over the ranks of each
    one's cotangent, and gradcheck of the sharded function of the whole
    tensor (pmean'd first, so that each rank's gradient is the mesh's)."""
    s, big_s = mesh.spatial_index, mesh.n_spatial
    ref = whole.clone().requires_grad_()
    full = full_fn(ref)
    n_out = full.shape[2] // big_s
    cots = [torch.from_numpy(rng.standard_normal((*full.shape[:2], n_out, full.shape[3])))
            for _ in range(big_s)]
    x = whole[:, :, own].clone().requires_grad_()
    y = sharded(x)
    fwd = float((y.detach() - full.detach()[:, :, s * n_out:(s + 1) * n_out]).abs().max())
    (gx,) = torch.autograd.grad(y, x, cots[s])
    (gref,) = torch.autograd.grad(full, ref, torch.cat(cots, 2))
    bwd = float((gx - gref[:, :, own]).abs().max())
    check = torch.autograd.gradcheck(
        lambda t: SP.gather_rows(sharded(mesh.world.pmean(t)[:, :, own]), mesh),
        (whole[:1].clone().requires_grad_(),), eps=1e-6, atol=1e-8)
    return fwd, bwd, check


def _leaves(mesh):
    """The sharded leaves BiSeNet adds, on rank-dependent fp64 rows whose
    top and bottom image rows are negative (zero padding would win there):
    max_pool_rows at 3x3/s2/p1 (the stem's; halo 1 and 0) and 3x3/s1/p1
    (a bottom halo row too), conv_rows at 7x7/s2 (halo 3 and 2), each
    against the unsharded op (`_rows_op`); and global_pool_rows against
    the whole image's mean, its backward against the sum of the row's
    cotangents spread over the image, and gradcheck."""
    s, big_s = mesh.spatial_index, mesh.n_spatial
    rng = np.random.default_rng(6)
    whole = torch.from_numpy(rng.standard_normal((2, 3, 8 * big_s, 6)))
    whole[:, :, 0] = -3 - whole[:, :, 0].abs()
    whole[:, :, -1] = -3 - whole[:, :, -1].abs()
    own = slice(8 * s, 8 * s + 8)
    out = {}
    for k, st, p in ((3, 2, 1), (3, 1, 1)):
        out[f"max{k}{st}{p}"] = _rows_op(
            mesh, whole, own, lambda x, k=k, st=st, p=p: SP.max_pool_rows(x, k, st, p, mesh),
            lambda x, k=k, st=st, p=p: torch.nn.functional.max_pool2d(x, k, st, p), rng)
    w7 = torch.from_numpy(rng.standard_normal((4, 3, 7, 7)))
    out["conv7"] = _rows_op(mesh, whole, own, lambda x: SP.conv_rows(x, w7, None, 2, 1, mesh),
                            lambda x: torch.nn.functional.conv2d(x, w7, stride=2, padding=3),
                            rng)

    x = whole[:, :, own].clone().requires_grad_()
    y = SP.global_pool_rows(x, mesh)
    fwd = float((y.detach() - whole.mean((2, 3), keepdim=True)).abs().max())
    cots = [torch.from_numpy(rng.standard_normal((2, 3, 1, 1))) for _ in range(big_s)]
    (gx,) = torch.autograd.grad(y, x, cots[s])
    want = sum(cots).expand(2, 3, 8, 6) / (whole.shape[2] * whole.shape[3])
    check = torch.autograd.gradcheck(
        lambda t: SP.global_pool_rows(mesh.world.pmean(t)[:, :, own], mesh),
        (whole[:1].clone().requires_grad_(),), eps=1e-6, atol=1e-8)
    out["global"] = (fwd, float((gx - want).abs().max()), check)
    return out


def _train(mesh, name, sd, batch):
    """One fp32 spatial train step from `sd` on this rank's share: metrics,
    params, BN state."""
    ts = TrainState.create(M.build(_spec(name), sd, device="cpu", train=True))
    step = make_spatial_train_step(ts, _loss(name), mesh, momentum=0.9, weight_decay=5e-4)
    metrics = step(*SP.shard_rows(mesh, *batch), 0.01)
    return ({k: float(v) for k, v in metrics.items()},
            {k: v.numpy().copy() for k, v in ts.params().items()},
            {k: v.numpy().copy() for k, v in ts.state().items()})


def _rank_12(rank, sds, batches):
    """A rank of the (1, 2) mesh: the sharded leaves, and for each family
    its sharded heads, the engine's sharded class map, the eval step (the
    second sample masked) and the train step."""
    torch.set_num_threads(2)
    mesh = SP.make_mesh_2d(1, 2, "cpu")
    out = {"leaves": _leaves(mesh)}
    img, lab, edge = batches["ddrnet_23"]
    for name in NAMES:
        sd = sds[name]
        model = M.build(_spec(name), sd, device="cpu")
        with torch.no_grad(), M.spatial_sharding(model, mesh):
            heads = model(SP.shard_rows(mesh, img))
            heads = [SP.gather_rows(o, mesh, dim=1).numpy() for o in heads]
        classmap = engine.make_inference_classmap(_cfg(name), _spec(name), sd, device="cpu",
                                                  spatial_mesh=mesh)(img).numpy()
        evaluate = make_spatial_eval_step(model, _loss(name), mesh, num_classes=19)
        metrics, cms = evaluate(*SP.shard_rows(mesh, img, lab, edge,
                                               np.array([1.0, 0.0], np.float32)))
        out[name] = {"heads": heads, "classmap": classmap,
                     "eval": ({k: float(v) for k, v in metrics.items()}, cms.numpy()),
                     "train": _train(mesh, name, sd, batches[name])}
    return out


def _rank_22(rank, sds, batches):
    """A rank of the (2, 2) mesh: each family's train step on its data
    row's samples."""
    torch.set_num_threads(1)
    mesh = SP.make_mesh_2d(2, 2, "cpu")
    d = mesh.data_index
    out = {"mesh": (mesh.data_index, mesh.spatial_index)}
    for name in NAMES:
        batch = batches[name]
        half = batch[0].shape[0] // 2
        out[name] = _train(mesh, name, sds[name], [a[d * half:(d + 1) * half] for a in batch])
    return out


@pytest.fixture(scope="module")
def weights():
    return {name: M.init(_spec(name), torch.Generator().manual_seed(seed))
            for name, seed in zip(NAMES, (7, 8))}


@pytest.fixture(scope="module")
def batches():
    return {name: _batch(TRAIN_N[name]) for name in NAMES}


@pytest.fixture(scope="module")
def ranks_12(weights, batches):
    return launch.spawn(_rank_12, 2, weights, batches, backend="gloo", timeout=600)


@pytest.fixture(scope="module")
def ranks_22(weights, batches):
    return launch.spawn(_rank_22, 4, weights, batches, backend="gloo", timeout=600)


@pytest.fixture(scope="module")
def jax_spatial(weights, batches):
    """The JAX package's spatial functions on the virtual CPU devices, for
    each family: heads of make_spatial_infer and the eval step on (1, 2),
    the train step on (1, 2) and on (2, 2), DDRNet's on (1, 1) in place of
    (2, 2) (test_ddrnet_step_22_matches_the_global_program); each as
    numpy."""
    import jax

    from pidnet_tpu.losses import FullLoss as JaxFullLoss
    from pidnet_tpu.models import bisenet as JB
    from pidnet_tpu.models import ddrnet as JD
    from pidnet_tpu.parallel import spatial as JS
    from pidnet_tpu.train import TrainState as JaxTrainState

    plain = dict(stem_s2d=False, wfold=False)
    mesh = JS.make_mesh_2d(1, 2)
    out = {}
    for name in NAMES:
        spec = {"ddrnet_23": JD, "bisenet": JB}[name].spec_for(name, 19, True)
        bw = M.balance_weights(_spec(name))
        loss = JaxFullLoss(num_outputs=len(bw), balance_weights=bw, **LOSS_KW)
        state = _jax_state(weights[name])
        img, lab, edge = batches["ddrnet_23"]
        heads = JS.make_spatial_infer(spec, mesh, **plain)(*state, JS.put_batch(mesh, img))
        m, cms = JS.make_spatial_eval_step(spec, loss, mesh, num_classes=19, **plain)(
            JaxTrainState.create(*state),
            *JS.put_batch(mesh, img, lab, edge, np.array([1.0, 0.0], np.float32)))
        got = {"heads": [np.asarray(h) for h in heads],
               "eval": ({k: float(v) for k, v in m.items()}, np.asarray(cms))}
        for key, shape in (("train_12", (1, 2)),
                           ("train_22", (1, 1) if name == "ddrnet_23" else (2, 2))):
            tmesh = JS.make_mesh_2d(*shape)
            step = JS.make_spatial_train_step(spec, loss, tmesh, weight_decay=5e-4, **plain)
            ts, m = step(JaxTrainState.create(*_jax_state(weights[name])),
                         *JS.put_batch(tmesh, *batches[name]), 0.01)
            ts = jax.device_get(ts)
            got[key] = ({k: float(v) for k, v in m.items()},
                        {k: np.asarray(v) for k, v in ts.params.items()},
                        {k: np.asarray(v) for k, v in ts.state.items()})
        out[name] = got
    return out


def test_leaves_match_the_unsharded_ops(ranks_12):
    """max_pool_rows equal to the unsharded pool's rows bit for bit (the
    image's border padded so that it never wins) and conv_rows at 7x7/s2
    within 1e-12 (fp64); their backwards within 1e-12 of autograd's;
    global_pool_rows within 1e-12 of the whole image's mean, its backward
    the row's summed cotangent spread over the image; gradcheck passes for
    each on both ranks."""
    for r in ranks_12:
        for key, (fwd, bwd, check) in r["leaves"].items():
            assert check, key
            assert (fwd == 0.0 if key.startswith("max") else fwd < 1e-12), (key, fwd)
            assert bwd < 1e-12, (key, bwd)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_heads_match_jax_spatial_infer(ranks_12, jax_spatial, name):
    """DDRNet-23's three heads and BiSeNetV1's four (at the input's
    resolution), sharded over (1, 2) and gathered, against
    make_spatial_infer on (1, 2): rtol/atol 2e-2, tightened to 1e-3 of
    each head's largest |logit|, and >= 0.999 of the argmaxes equal; both
    ranks hold the same heads."""
    got, want = ranks_12[0][name]["heads"], jax_spatial[name]["heads"]
    assert len(got) == len(want) == M.module_for(_spec(name)).seg_heads + 1
    for g, g1, w in zip(got, ranks_12[1][name]["heads"], want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, g1)
        np.testing.assert_allclose(g, w, rtol=2e-2, atol=2e-2)
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max()
        if w.shape[-1] > 1:
            assert (np.argmax(g, -1) == np.argmax(w, -1)).mean() >= 0.999


@pytest.mark.parametrize("name", NAMES)
def test_sharded_classmap_matches_one_device(ranks_12, weights, batches, name):
    """engine.make_inference_classmap over (1, 2) (BiSeNet's K1 windowed at
    scale 1, DDRNet's at x8): every rank returns the whole (N, H, W) int32
    map, >= 0.999 equal to the one-device closure's."""
    img = batches["ddrnet_23"][0]
    want = engine.make_inference_classmap(_cfg(name), _spec(name), weights[name],
                                          device="cpu")(img).numpy()
    got = [r[name]["classmap"] for r in ranks_12]
    assert got[0].dtype == np.int32 and got[0].shape == want.shape
    np.testing.assert_array_equal(got[0], got[1])
    assert (got[0] == want).mean() >= 0.999


@pytest.mark.parametrize("name", NAMES)
def test_eval_step_matches_jax_spatial(ranks_12, jax_spatial, name):
    """make_spatial_eval_step on (1, 2), OHEM on, the second sample masked:
    one matrix a segmentation head (3 for BiSeNet), metrics rtol 2e-2 /
    atol 1e-3 (the global weight exact), matrices with equal totals and <
    5e-3 of the pixels moved, the same on both ranks."""
    (got_m, got_cm), (want_m, want_cm) = ranks_12[0][name]["eval"], jax_spatial[name]["eval"]
    assert ranks_12[1][name]["eval"][0] == got_m
    np.testing.assert_array_equal(ranks_12[1][name]["eval"][1], got_cm)
    assert got_m["weight"] == want_m["weight"] == 1.0
    for k in want_m:
        np.testing.assert_allclose(got_m[k], want_m[k], rtol=2e-2, atol=1e-3, err_msg=k)
    heads = M.module_for(_spec(name)).seg_heads
    assert got_cm.shape == want_cm.shape == (heads, 19, 19)
    for g, w in zip(got_cm, want_cm):
        assert g.sum() == w.sum() > 0
        assert np.abs(g - w).sum() / w.sum() < 5e-3


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_jax_spatial_12(ranks_12, jax_spatial, weights, name):
    """make_spatial_train_step on (1, 2) against the JAX package's on (1,
    2), at tests/test_torch_spatial.py's bounds; both ranks end the step
    with the same weights and BN state."""
    got = ranks_12[0][name]["train"]
    _close_step(got, jax_spatial[name]["train_12"], weights[name])
    other = ranks_12[1][name]["train"]
    assert other[0] == got[0]
    for a, b in ((got[1], other[1]), (got[2], other[2])):
        assert all(np.array_equal(a[k], b[k]) for k in a)


def test_bisenet_step_22_matches_jax_spatial(ranks_22, jax_spatial, weights):
    """BiSeNet on (2, 2): two samples a data row, rows over two spatial
    ranks, against the JAX package's (2, 2) step; every rank holds the same
    weights."""
    assert [r["mesh"] for r in ranks_22] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    got = ranks_22[0]["bisenet"]
    _close_step(got, jax_spatial["bisenet"]["train_22"], weights["bisenet"])
    for r in ranks_22[1:]:
        assert all(np.array_equal(got[1][k], r["bisenet"][1][k]) for k in got[1])


def test_ddrnet_step_22_matches_the_global_program(ranks_22, jax_spatial, weights):
    """DDRNet-23 on (2, 2) against the JAX package's step on a (1, 1) mesh:
    the same global program, unpartitioned. The JAX (2, 2) step itself is
    not the global program's: DDRNet's JAX forward has no "pre_spp" hint,
    so GSPMD partitions the DAPPM's large-padding pools, whose gradients
    come out wrong on a 2-D mesh: its update's cosine with the (1, 1)
    step's is 0.840, against 0.99994 with PIDNet's hints added to a copy
    of that forward (scripts/spatial_quirk.py; ROADMAP.md, reference
    quirks). The port gathers the 1/32 map before layer5 as PIDNet does."""
    got = ranks_22[0]["ddrnet_23"]
    _close_step(got, jax_spatial["ddrnet_23"]["train_22"], weights["ddrnet_23"])
    for r in ranks_22[1:]:
        assert all(np.array_equal(got[1][k], r["ddrnet_23"][1][k]) for k in got[1])


def test_replicated_bn_state_matches_jax(ranks_12, ranks_22, jax_spatial):
    """The BNs on BiSeNet's pooled vectors count the global batch's samples
    (n_data ranks', not the mesh's): after one step their running_var
    matches the JAX package's within 1e-4 relative on (1, 2) and (2, 2);
    counting every rank would scale its unbiased part by 8/7 in place of
    4/3."""
    for got, want in ((ranks_12[0]["bisenet"]["train"], jax_spatial["bisenet"]["train_12"]),
                      (ranks_22[0]["bisenet"], jax_spatial["bisenet"]["train_22"])):
        for k in REPLICATED_BN:
            np.testing.assert_allclose(got[2][k], want[2][k], rtol=1e-4, err_msg=k)


# ---------------------------------------------------------------------------
# The CLIs: tools.train --spatial 2 and tools.eval --spatial 2 on two ranks
# ---------------------------------------------------------------------------

YAML = """
DATASET:
  DATASET: cityscapes
  ROOT: {root}/data/
  TRAIN_SET: 'list/cityscapes/train.lst'
  TEST_SET: 'list/cityscapes/val.lst'
  NUM_CLASSES: 19
MODEL:
  NAME: {name}
  PRETRAINED: ''
  NUM_OUTPUTS: {outputs}
LOSS:
  OHEMKEEP: 500
  BALANCE_WEIGHTS: {balance}
TRAIN:
  IMAGE_SIZE: [128, 128]
  BASE_SIZE: 128
  LR: 0.001
  BATCH_SIZE_PER_GPU: 1
  END_EPOCH: 1
  IGNORE_LABEL: 255
TEST:
  IMAGE_SIZE: [128, 128]
  BASE_SIZE: 128
  OUTPUT_INDEX: {index}
WORKERS: 1
PRINT_FREQ: 1
"""


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """One train frame and one val frame, random 128x128, and a YAML for
    each family."""
    root = tmp_path_factory.mktemp("sp_fam_cli")
    rng = np.random.default_rng(29)
    for d in ("data/cityscapes/img", "data/cityscapes/gt", "data/list/cityscapes"):
        (root / d).mkdir(parents=True)
    lines = []
    for i in range(2):
        write_png(str(root / f"data/cityscapes/img/{i}.png"),
                  rng.integers(0, 256, (128, 128, 3), dtype=np.uint8))
        write_png(str(root / f"data/cityscapes/gt/{i}_gtFine_labelIds.png"),
                  rng.integers(0, 34, (128, 128), dtype=np.uint8))
        lines.append(f"img/{i}.png\tgt/{i}_gtFine_labelIds.png")
    (root / "data/list/cityscapes/train.lst").write_text(lines[0])
    (root / "data/list/cityscapes/val.lst").write_text(lines[1])
    for name in NAMES:
        bw = list(M.balance_weights(_spec(name)))
        (root / f"{name}.yaml").write_text(YAML.format(root=root, name=name, outputs=len(bw),
                                                       balance=bw, index=OUTPUT_INDEX[name]))
    return root


def _argv(tree, name, *flags, opts=()):
    return ["--cfg", str(tree / f"{name}.yaml"), "--device", "cpu", *flags, "OUTPUT_DIR",
            str(tree / "output"), "LOG_DIR", str(tree / "log"), *opts]


def _cli_rank(rank, tool, argv):
    """One rank of `tools.<tool> --spatial 2`: what it returns."""
    from pidnet_tpu_torch.tools import eval as eval_cli
    from pidnet_tpu_torch.tools import train

    torch.set_num_threads(1)
    train.TBWriter = _Writer
    return (train if tool == "train" else eval_cli).main(argv)


@pytest.fixture(scope="module", params=NAMES)
def cli_runs(request, tree):
    name = request.param
    trained = launch.spawn(_cli_rank, 2, "train",
                           _argv(tree, name, "--multihost", "--spatial", "2"), backend=None,
                           timeout=600)
    model = str(tree / "output" / "cityscapes" / name / "final_state.pt")
    evaluated = launch.spawn(_cli_rank, 2, "eval",
                             _argv(tree, name, "--spatial", "2", opts=("TEST.MODEL_FILE", model)),
                             backend=None, timeout=600)
    return name, trained, evaluated, model


def test_cli_train_and_eval_spatial(cli_runs, tree):
    """tools.train --multihost --spatial 2 of DDRNet-23 and of BiSeNetV1
    (three balance weights): one step and one val frame with finite logged
    losses and the artifacts written; then tools.eval --spatial 2 of the
    trained weights: both ranks return the same scores, within 1e-2 of one
    process's tools.eval."""
    from pidnet_tpu_torch.tools import eval as eval_cli

    name, _, evaluated, model = cli_runs
    run = os.path.dirname(model)
    (log,) = glob.glob(os.path.join(run, f"{name}_*_train.log"))
    with open(log) as f:
        losses = [float(v.split(",")[0]) for v in f.read().split("Loss: ")[1:]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert {"checkpoint.pt", "best.pt", "final_state.pt"} <= set(os.listdir(run))
    got0, got1 = evaluated
    assert got0[0] == got1[0] and np.array_equal(got0[1], got1[1])
    want = eval_cli.main(_argv(tree, name, opts=("TEST.MODEL_FILE", model)))
    assert abs(got0[0] - want[0]) < 1e-2 and abs(got0[2] - want[2]) < 1e-2
