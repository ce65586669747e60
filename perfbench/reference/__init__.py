"""The plain float32 references the benchmark judges the program by. They
import torch and nothing of the program or of JAX."""

import contextlib

import torch


@contextlib.contextmanager
def float32():
    """Inside, float32 products stay float32: no TF32 in cuBLAS or cuDNN."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
