"""Build the package's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled by ``nvcc``
for ``sm_90a`` into a shared library under ``build/kernels/`` beside the
package (a directory that ``.gitignore`` lists), named by a hash of the
source, the ``csrc/*.cuh`` headers it includes and the flags, so an edited
source or header builds anew and an unchanged one is reused. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Iterable, Tuple

KERNEL_SOURCES = ("flash_attention", "flash_attention_tc", "swiglu", "swiglu_tc")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    # optimise and assemble the kernel instances on all host cores
    "--split-compile=0",
)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCAL_INCLUDE = re.compile(rb'^[ \t]*#include "([^"/]+\.cuh)"', re.MULTILINE)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def library_path(name: str) -> str:
    """The library of ``csrc/<name>.cu``, named by a hash of the source, of
    the ``csrc`` headers it includes (``#include "x.cuh"``) and of the flags."""
    with open(os.path.join(CSRC_DIR, name + ".cu"), "rb") as f:
        source = f.read()
    digest = hashlib.sha256(source)
    for header in sorted(set(_LOCAL_INCLUDE.findall(source))):
        with open(os.path.join(CSRC_DIR, header.decode()), "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str) -> Tuple[str, str, subprocess.Popen]:
    """Start nvcc on one source into a temporary file in the build dir, its
    output into the library's log file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = library_path(name)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
    with open(out[:-3] + ".log", "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, out: str, tmp: str, proc: subprocess.Popen) -> str:
    with open(out[:-3] + ".log") as f:
        log = f.read()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return log


def build(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, Tuple[str, float]]:
    """Compile every source that has no up-to-date library, one nvcc per
    source, all started together. Returns {name: (nvcc log, seconds from
    the start until its nvcc ended)} for those built."""
    t0 = time.perf_counter()
    started = [(n, *_start(n)) for n in names
               if not os.path.exists(library_path(n))]
    built = {}
    try:
        pending = list(started)
        while pending:
            for item in [p for p in pending if p[3].poll() is not None]:
                built[item[0]] = (_finish(*item), time.perf_counter() - t0)
                pending.remove(item)
            if pending:
                time.sleep(0.05)
    finally:
        for _, _, tmp, proc in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return built


def load(name: str) -> ctypes.CDLL:
    """The kernel library for ``csrc/<name>.cu``, built if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        _LOADED[name] = lib
    return lib
