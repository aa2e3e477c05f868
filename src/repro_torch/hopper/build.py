"""Build and load the Hopper kernels: nvcc -> shared library -> ctypes.

Each `csrc/<name>.cu` compiles on first use into its own shared library
under `build/repro_torch/` at the repository root (listed in .gitignore):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/repro_torch/<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the source and the flags, so a library is
rebuilt exactly when its source changes, and only from the sources in the
checkout.  The sources include no PyTorch header (they export plain C
functions), which keeps a build to seconds.  `build_all` starts one nvcc
per source at once.  Importing this module builds nothing.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict, List

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME")
    if home and (pathlib.Path(home) / "bin" / "nvcc").exists():
        return str(pathlib.Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> pathlib.Path:
    """Where the current build of csrc/<name>.cu lives (or will)."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for csrc/<name>.cu unless its library is current; returns
    (process or None, output path, temp path)."""
    out = library_path(name)
    if out.exists():
        return None, out, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, out, tmp


def _finish(name: str, proc, out: pathlib.Path, tmp) -> str:
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        if tmp is not None and tmp.exists():
            tmp.unlink()
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(log)
    return log


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> Dict[str, float]:
    """Build every csrc/*.cu that is not current, one nvcc per source, all
    started together.  Returns {name: seconds} (0.0 when already built);
    raises with nvcc's output on any failure."""
    t0 = time.perf_counter()
    started = {name: _start(name) for name in sources()}
    took = {}
    try:
        for name, (proc, out, tmp) in started.items():
            _finish(name, proc, out, tmp)
            took[name] = 0.0 if proc is None else time.perf_counter() - t0
    finally:
        for proc, _, _ in started.values():
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    return took


def build_log(name: str) -> str:
    """nvcc's output (register and shared-memory use, from -Xptxas -v) for
    the current build of csrc/<name>.cu; empty if it was not built here."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of csrc/<name>.cu, built on first use."""
    proc, out, tmp = _start(name)
    _finish(name, proc, out, tmp)
    return ctypes.CDLL(str(out))
