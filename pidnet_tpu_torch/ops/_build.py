"""Build and load the hand-written CUDA kernels of `pidnet_tpu_torch/csrc`.

Each `csrc/<name>.cu` has a plain C interface and compiles with `nvcc` for
`sm_90a` into `pidnet_tpu_torch/csrc/build/<name>-<hash>.so` (listed in
.gitignore), keyed by a hash of its source, the shared `csrc/*.cuh` headers
and the flags, at first use; it is loaded with `ctypes`. Nothing here runs
at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = CSRC / "build"
# -DNDEBUG compiles the kernels' device asserts out; drop it to debug them
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-DNDEBUG",
    "-shared", "-Xcompiler", "-fPIC",
]

_loaded: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every kernel source in csrc/."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    """The library's path, keyed by its source, the shared headers and the flags."""
    text = (CSRC / f"{name}.cu").read_bytes()
    text += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"{name}-{digest}.so"


def build(names: list[str], verbose: bool = False) -> dict[str, Path]:
    """Compile every named source whose library is not built yet, all at
    once (one nvcc process each), and return the library paths. Raises
    with nvcc's output when a build fails."""
    paths = {name: library_path(name) for name in names}
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        if verbose and log:
            print(f"[nvcc {name}]\n{log.rstrip()}")
        os.replace(tmp, paths[name])  # atomic: a concurrent builder sees a whole file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built at first use."""
    if name not in _loaded:
        path = build([name])[name]
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
