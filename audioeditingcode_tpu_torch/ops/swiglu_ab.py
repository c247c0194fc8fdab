"""Time variants of the bfloat16 SwiGLU kernel (B3) in turns, on one card.

    python -m audioeditingcode_tpu_torch.ops.swiglu_ab NAME=SOURCE.cu [NAME=SOURCE.cu ...]

Each SOURCE is a variant of ``csrc/swiglu_tc.cu`` with its C entry
``aec_swiglu_tc_fwd``. All are compiled together, one nvcc each, with the
package's nvcc flags and ``csrc/`` on the include path, into ``build/ab/``
(gitignored); each variant's registers and spills are printed from ptxas.
Then each is held to ``swiglu.BF16_TOL`` against the plain version at every
shape of ``SHAPES``, and timed at the shapes of ``TIMED`` in turns (in the
order given, then reversed): by CUDA events around back-to-back launches
and on the device alone (torch.profiler), beside one library call
(F.linear + silu * mul) on the same inputs. At the small shape the first
is the host's cost of a launch. A variant that fails the check is still
timed. The last line is one JSON object. Needs one CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import torch
from torch.nn import functional as F

from . import build, swiglu
from ..utils.timing import cuda_ms, device_ms

# (M, E, N): the DiT's two shapes and a small one; the checks add the edges:
# ragged M, E not a multiple of 64, N not of 128, a consumer's rows all past
# M, M = 1, more tiles than SMs at few rows
TIMED = [(2050, 1536, 6144), (1025, 1536, 6144), (77, 80, 192)]
SHAPES = TIMED + [(130, 80, 320), (64, 128, 128), (1, 16, 64), (300, 64, 8192)]
AB_DIR = os.path.join(os.path.dirname(build.BUILD_DIR), "ab")


def build_variants(variants: dict) -> dict:
    """Compile every variant at once; returns {name: (library, ptxas log)}."""
    os.makedirs(AB_DIR, exist_ok=True)
    procs = {}
    for name, src in variants.items():
        out = os.path.join(AB_DIR, name + ".so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", build.CSRC_DIR, "-o", out, src]
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate(timeout=600)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {variants[name]}:\n{log}")
        built[name] = (out, log)
    return built


def ptxas_summary(log: str) -> dict:
    return {"registers": max((int(m) for m in re.findall(r"Used (\d+) registers", log)),
                             default=0),
            "spill_stores": sum(int(m) for m in re.findall(r"(\d+) bytes spill stores", log)),
            "warnings": [line for line in log.splitlines()
                         if "warning" in line.lower() or "Performance Loss" in line]}


def entry(library: str):
    fn = ctypes.CDLL(library).aec_swiglu_tc_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return fn


def inputs(M: int, E: int, N: int, seed: int = 5):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(M, E, device="cuda", generator=g).to(torch.bfloat16)
    w = (torch.randn(2 * N, E, device="cuda", generator=g) / E ** 0.5).to(torch.bfloat16)
    b = torch.randn(2 * N, device="cuda", generator=g) * 0.1
    return x, w, b


def launcher(fn, x, w, b):
    """A call of the variant that writes into one preallocated output."""
    M, E = x.shape
    N = w.shape[0] // 2
    out = torch.empty(M, N, dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        rc = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), M, E, N, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
        return out

    return call


def check(fn, shape) -> dict:
    """The variant against the plain version: the largest error over what
    BF16_TOL allows, and the share of outputs outside it."""
    x, w, b = inputs(*shape)
    out = launcher(fn, x, w, b)().clone()
    torch.cuda.synchronize()
    ref = swiglu.swiglu_reference(x, w, b).double()
    tol = swiglu.BF16_TOL
    over = (out.double() - ref).abs() / (tol["atol"] + tol["rtol"] * ref.abs())
    return {"over_allowed": over.max().item(),
            "share_outside": (over > 1).double().mean().item(),
            "max_abs_err": (out.double() - ref).abs().max().item(),
            "bit_equal_rerun": torch.equal(out, launcher(fn, x, w, b)())}


def main() -> int:
    if not torch.cuda.is_available():
        print("swiglu_ab: no CUDA device; this script needs one card", file=sys.stderr)
        return 2
    variants = dict(arg.split("=", 1) for arg in sys.argv[1:])
    if not variants:
        raise SystemExit(__doc__)
    built = build_variants(variants)
    fns = {name: entry(lib) for name, (lib, _) in built.items()}
    record = {"device": torch.cuda.get_device_name(0),
              "ptxas": {name: ptxas_summary(log) for name, (_, log) in built.items()},
              "checks": {}, "timed": {}}
    for name in variants:
        print(f"[swiglu_ab] {name}: ptxas {record['ptxas'][name]}", flush=True)
        record["checks"][name] = {str(s): check(fns[name], s) for s in SHAPES}
        print(f"[swiglu_ab] {name}: {record['checks'][name]}", flush=True)
    order = list(variants) + list(reversed(variants))
    for shape in TIMED:
        x, w, b = inputs(*shape)
        bl = b.to(torch.bfloat16)

        def library():
            h, gate = F.linear(x, w, bl).chunk(2, dim=-1)
            return h * F.silu(gate)

        times = {name: {"ms": [], "device_ms": []} for name in variants}
        times["library"] = {"ms": [cuda_ms(library, reps=20)],
                            "device_ms": [device_ms(library, reps=20)]}
        for name in order:
            call = launcher(fns[name], x, w, b)
            times[name]["ms"].append(cuda_ms(call, reps=20))
            times[name]["device_ms"].append(device_ms(call, reps=20))
        times["library"]["ms"].append(cuda_ms(library, reps=20))
        times["library"]["device_ms"].append(device_ms(library, reps=20))
        record["timed"][str(shape)] = times
        for name, t in times.items():
            print(f"[swiglu_ab] {shape} {name}: ms {t['ms']}, device_ms {t['device_ms']}",
                  flush=True)
        del x, w, b, bl
        torch.cuda.empty_cache()
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
