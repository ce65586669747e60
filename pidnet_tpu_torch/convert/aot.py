"""Serving export: a self-contained, serialised inference program
(counterpart of pidnet_tpu/convert/aot.py).

`export_serving` folds BN into the convs, traces the folded bf16 class-map
pipeline (normalised f32 NHWC image -> bf16 -> folded model -> the final
head -> fused upsample + argmax -> int32 (N, H, W)) with `torch.export`
at a static (batch, H, W, 3), and serialises it with `torch.export.save`
to bytes, the weights inside. The program

- needs no model code, no checkpoint and no state of this package to run:
  `load_serving(blob)(x)` is the whole API, and the loader imports only
  the module that registers the custom operator;
- keeps K1: the fused upsample + argmax is the custom operator
  `pidnet_tpu_torch::upsample_argmax` (ops/upsample_argmax.py), which runs
  the CUDA kernel on the card and its plain version on the CPU, so one
  file serves both devices (`load_serving(..., device="cpu")`). The JAX
  artifact gives its Pallas kernel up for the XLA resize + argmax to stay
  portable; a custom operator with a CPU version needs no such trade;
- is traced on the CPU and moved to the serving device at load
  (`torch.export.passes.move_to_device_pass`), its 4-D weights laid out
  channels_last there, as the eager path holds them;
- is tied to the torch version that wrote it: each machine exports its
  own.

Input: normalised f32 NHWC (the reference's ImageNet normalisation) of
the export's static shape. Output: int32 (N, H, W) class map.
"""

from __future__ import annotations

import io

import torch
from torch import nn

from pidnet_tpu_torch import resolve_device
from pidnet_tpu_torch.ops import upsample_argmax  # noqa: F401  (registers the operator)


class ServingPipeline(nn.Module):
    """f32 NHWC image -> int32 (N, H, W) class map through a folded bf16
    model and K1 (the custom operator)."""

    def __init__(self, model: nn.Module, align_corners: bool):
        super().__init__()
        self.model, self.align_corners = model, align_corners

    def forward(self, x):
        logits = self.model(x.to(torch.bfloat16))
        if isinstance(logits, (list, tuple)):  # augment spec: the final head
            logits = logits[-2] if len(logits) > 2 else logits[-1]
        return torch.ops.pidnet_tpu_torch.upsample_argmax(
            logits.contiguous(), x.shape[1], x.shape[2], self.align_corners)


def make_serving_fn(folded_sd: dict, spec, *, align_corners: bool = True,
                    device=None) -> ServingPipeline:
    """The serving pipeline of `folded_sd` (from
    `convert.fold.fold_state_dict`) as an eval-mode module on `device`
    (the card unless the caller names another): bf16 weights in
    channels_last, as `engine.make_inference_classmap(...,
    compute_dtype=torch.bfloat16)` holds them. `align_corners=True` is the
    reference's eval and custom upsampling."""
    from pidnet_tpu_torch.models import pidnet as M

    model = M.build(spec, folded_sd, folded=True, device=resolve_device(device))
    model = model.to(torch.bfloat16).to(memory_format=torch.channels_last)
    return ServingPipeline(model, align_corners).eval()


def export_serving(state_dict: dict, spec, hw: tuple[int, int], *, batch: int = 1,
                   align_corners: bool = True) -> bytes:
    """Fold, trace on the CPU at (batch, H, W, 3) f32 and serialise;
    returns the program's bytes. H and W must be multiples of 64, as for
    the eager closures (the network's 1/64 stage and 1/8 fusions)."""
    from pidnet_tpu_torch.convert.fold import fold_state_dict

    if hw[0] % 64 or hw[1] % 64:
        raise ValueError(f"export_serving: H and W must be multiples of 64, got {tuple(hw)}")

    folded = fold_state_dict(state_dict, spec)
    pipeline = make_serving_fn(folded, spec, align_corners=align_corners, device="cpu")
    # the file holds the weights in the default layout: torch.export.save
    # takes a channels_last tensor for a fragment of its storage
    # ("No complete tensor found"); load_serving lays them out again
    pipeline = pipeline.to(memory_format=torch.contiguous_format)
    x = torch.zeros((int(batch), int(hw[0]), int(hw[1]), 3), dtype=torch.float32)
    with torch.no_grad():
        program = torch.export.export(pipeline, (x,))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


class LoadedServing:
    """A loaded serving program: call it with an f32 NHWC image on its
    device; `input_shape` is the export's static (N, H, W, 3)."""

    def __init__(self, program, device: torch.device):
        self.program, self.device = program, device
        (val,) = [node.meta["val"] for node in program.graph.nodes
                  if node.op == "placeholder"
                  and node.name in program.graph_signature.user_inputs]
        self.input_shape = tuple(int(s) for s in val.shape)
        # channels_last 4-D weights, as the eager path holds them: the
        # layout picks cuDNN's kernels, and so the bf16 sums
        fn = program.module().to(memory_format=torch.channels_last)
        # the trace puts a metadata assert before each cast: the module
        # checks the input's shape before the graph runs and __call__ its
        # dtype and device, so inside the graph they only cost dispatches
        for node in list(fn.graph.nodes):
            if node.target == torch.ops.aten._assert_tensor_metadata.default:
                fn.graph.erase_node(node)
        fn.recompile()
        self._fn = fn

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.float32 or x.device.type != self.device.type:
            raise ValueError(f"the program takes float32 on {self.device}, got {x.dtype} on "
                             f"{x.device}")
        with torch.inference_mode():
            return self._fn(x)


def load_serving(blob_or_path, device=None) -> LoadedServing:
    """An exported program (bytes or a file path) on `device` (the card
    unless the caller names another)."""
    dev = resolve_device(device)
    src = io.BytesIO(blob_or_path) if isinstance(blob_or_path, (bytes, bytearray)) else \
        blob_or_path
    program = torch.export.load(src)
    if dev.type != "cpu":
        from torch.export.passes import move_to_device_pass

        program = move_to_device_pass(program, dev)
    return LoadedServing(program, dev)
