"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds) and
loaded with ``ctypes``. Builds happen at first use, from the sources in the
checkout, into ``enflow_tpu_torch/_build/`` (listed in ``.gitignore``); the
library name carries a hash of the source, the headers in ``csrc/`` and
the flags, so an edited source is rebuilt and a stale library is never
loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict[str, ctypes.CDLL] = {}


class LaunchCounts:
    """Kernel launches (on the card) and plain-version calls (on the CPU)
    of one kernel module since the last ``reset``: one integer attribute
    per name."""

    def __init__(self, *names: str):
        self._names = names
        self.reset()

    def reset(self):
        for name in self._names:
            setattr(self, name, 0)


_n_sm: dict[int, int] = {}


def multiprocessors(device) -> int:
    """The number of streaming multiprocessors of a CUDA ``device``."""
    import torch
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _n_sm:
        _n_sm[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _n_sm[idx]


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source on a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    # the source and every header beside it (a header edit rebuilds)
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                             *sorted(CSRC.glob("*.cuh"))])
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build_all(names) -> dict[str, tuple[Path, float, str]]:
    """Compile ``csrc/<name>.cu`` for each name whose library does not
    exist yet, one ``nvcc`` process per source, all started together.
    Returns ``{name: (library path, build seconds, nvcc's messages)}``
    (seconds 0 for a library that was already built); raises with the
    compiler's output when a build fails."""
    out, procs = {}, {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            out[name] = (lib, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (lib, tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (lib, tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building "
                          f"{name}:\n{log}")
            continue
        os.replace(tmp, lib)
        out[name] = (lib, secs, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def build(name: str) -> tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists (see
    :func:`build_all`)."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first."""
    if name not in _loaded:
        path, _, _ = build(name)
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
