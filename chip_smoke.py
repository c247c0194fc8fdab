"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; without a CUDA card, or
without the rest of the repository beside this file, it exits non-zero and
prints no result):

0. the card's name and power limit; build every CUDA kernel from csrc/.
1. each kernel against its plain PyTorch version on the card, at the main
   path's shapes, in float32 and bfloat16, with its time, the plain
   version's time, one PyTorch library call's time and the card's bound.
2. one full-width AudioLDM-s UNet forward (random seeded weights, batch 2
   on the (8, 256, 16) latent of a 10 s clip) on the card, through the
   kernel, against the same forward on the CPU, through the plain version.
3. the main path: the port CLI's ``--mode ours`` edit of a synthetic 10 s
   clip with AudioLDM-s at 200 inversion + 100 edit steps, once as an edit
   and once with ``--selfcheck``; the kernel launch count of each run must
   be 20 per UNet forward.

The line before the last holds ``nvidia-smi``'s name and power limit, the
one before it the kernels' JSON record, and the last line
``{"ok": true, "device": {...}}``.

``python3 chip_smoke.py --profile`` adds a torch.profiler breakdown of the
main path's CFG UNet step (device time by kernel class, the device's idle
share) before the final lines.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

MODEL_ID = "cvssp/audioldm-s-full-v2"
STEPS, TSTART = 200, 100  # the bench.py edit config: 300 CFG UNet forwards
LATENT = (8, 256, 16)  # a 10 s clip: 1024 mel frames
ATTN_CALLS_PER_FORWARD = 20  # 10 at (16, 4096, 16) + 10 at (16, 1024, 32)

# H100 SXM data-sheet peaks (dense rates at the 700 W limit). Exponentials
# run on the SFU: 16 results per clock per SM (NVIDIA's CUDA documentation,
# arithmetic instruction throughput, compute capability 9.0) x 132 SMs x
# the 1.98 GHz boost clock that the 67 TFLOP/s float32 figure assumes.
HBM_BYTES_PER_S = 3.35e12
MATMUL_FLOPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
EXP_PER_S = 16 * 132 * 1.98e9

# (B, S, H, H_kv, D): the two main-path shapes, then the GQA/ragged
# interface shape of the Stable Audio DiT (S = 1025, 24 q / 12 kv heads)
ATTN_CASES = [
    ((2, 4096, 8, 8, 16), torch.float32),
    ((2, 1024, 8, 8, 32), torch.float32),
    ((2, 4096, 8, 8, 16), torch.bfloat16),
    ((2, 1024, 8, 8, 32), torch.bfloat16),
    ((2, 1025, 24, 12, 64), torch.float32),
    ((2, 1025, 24, 12, 64), torch.bfloat16),
]
# float32 differs only in summation order and the SFU exponential; bf16
# rounds p at the running rather than the final max (as tests/test_flash_attention.py)
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of fn() over reps launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def attention_bound_ms(B, S, H, Hkv, D, dtype):
    """Least time for the function: the larger of its bytes (q, k, v read
    once, o written once) over HBM bandwidth and its operations (the two
    matmuls at the type's peak, the exponentials at the SFU rate)."""
    itemsize = torch.finfo(dtype).bits // 8
    nbytes = (2 * B * S * H * D + 2 * B * S * Hkv * D) * itemsize
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(4.0 * B * H * S * S * D / MATMUL_FLOPS_PER_S[dtype],
                1.0 * B * H * S * S / EXP_PER_S)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase1_attention(fa):
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    cases = []
    g = torch.Generator(device="cuda").manual_seed(0)
    for (B, S, H, Hkv, D), dtype in ATTN_CASES:
        q = torch.randn(B, S, H, D, device="cuda", generator=g).to(dtype)
        k = torch.randn(B, S, Hkv, D, device="cuda", generator=g).to(dtype)
        v = torch.randn(B, S, Hkv, D, device="cuda", generator=g).to(dtype)
        out = fa.flash_attention_cuda(q, k, v)
        torch.cuda.synchronize()
        ref = fa.attention_reference(q, k, v)
        err = (out.float() - ref.float()).abs().max().item()
        tol = ATTN_TOL[dtype]
        torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
        # the library yardstick, one call; GQA's kv heads repeated beforehand
        kr, vr = (x.repeat_interleave(H // Hkv, dim=2).transpose(1, 2) for x in (k, v))
        qt = q.transpose(1, 2)
        bound, bound_by = attention_bound_ms(B, S, H, Hkv, D, dtype)
        case = {
            "shape": [B, S, H, D], "kv_heads": Hkv, "dtype": str(dtype).split(".")[-1],
            "max_abs_err": err, "tol": tol,
            "ms": cuda_ms(lambda: fa.flash_attention_cuda(q, k, v), reps=20),
            "plain_ms": cuda_ms(lambda: fa.attention_reference(q, k, v), reps=5, warmup=1),
            "library_ms": cuda_ms(lambda: sdpa(qt, kr, vr), reps=20),
            "bound_ms": bound, "bound_by": bound_by,
        }
        cases.append(case)
        log(f"[phase1] flash_attention {case['shape']} kv_heads={Hkv} {case['dtype']}: "
            f"max_abs_err {err:.3g} (tol {tol}), kernel {case['ms']:.4f} ms, plain "
            f"{case['plain_ms']:.4f} ms, library {case['library_ms']:.4f} ms, "
            f"bound {bound:.4f} ms ({bound_by})")
        del q, k, v, out, ref, kr, vr, qt
        torch.cuda.empty_cache()
    return cases


def phase2_unet_parity(fa):
    from audioeditingcode_tpu_torch.models.configs import MODEL_SPECS
    from audioeditingcode_tpu_torch.models.registry import random_init_
    from audioeditingcode_tpu_torch.models.text_encoders import NullTextEncoder
    from audioeditingcode_tpu_torch.models.unet2d import UNet2DConditionModel

    spec = MODEL_SPECS[MODEL_ID]
    unet = random_init_(UNet2DConditionModel(spec.unet), torch.Generator().manual_seed(1))
    unet.eval().requires_grad_(False)
    x = torch.randn((2,) + LATENT, generator=torch.Generator().manual_seed(2))
    t = torch.tensor([501, 501])
    labels = NullTextEncoder(class_dim=512)(["", "a dog barking"]).class_labels
    t0 = time.perf_counter()
    with torch.no_grad():
        cpu_out = unet(x, t, class_labels=labels)
    cpu_s = time.perf_counter() - t0
    gpu_unet = copy.deepcopy(unet).cuda()
    before = fa.flash_attention_cuda.launches
    with torch.no_grad():
        gpu_out = gpu_unet(x.cuda(), t.cuda(), class_labels=labels.cuda()).cpu()
    launched = fa.flash_attention_cuda.launches - before
    rel = ((gpu_out - cpu_out).abs().max() / cpu_out.abs().max()).item()
    log(f"[phase2] AudioLDM-s UNet forward {list(x.shape)}: card vs CPU max rel err "
        f"{rel:.3g} (limit 1e-3, TF32 off), {launched} kernel launches, CPU {cpu_s:.1f} s")
    if not np.isfinite(rel) or rel > 1e-3:
        raise AssertionError(f"UNet card/CPU parity {rel} > 1e-3")
    if launched != ATTN_CALLS_PER_FORWARD:
        raise AssertionError(f"{launched} kernel launches in one UNet forward")
    return {"unet_rel_err": rel}


def write_clip(path: str, seconds: float = 10.0, sr: int = 16000) -> None:
    from scipy.io import wavfile

    t = np.arange(int(sr * seconds)) / sr
    wave = 0.4 * np.sin(2 * np.pi * 330 * t) + 0.1 * np.sin(2 * np.pi * 1250 * t)
    wave += 0.02 * np.random.default_rng(0).standard_normal(t.shape)
    wavfile.write(path, sr, (wave * 32767).astype(np.int16))


def phase3_main_path(fa, tmp: str):
    from scipy.io import wavfile

    from audioeditingcode_tpu_torch.cli.run import main as run_edit

    clip = os.path.join(tmp, "clip.wav")
    write_clip(clip)
    runs = {}
    for name, extra in (("edit", []), ("selfcheck", ["--selfcheck"])):
        argv = ["--model_id", MODEL_ID, "--init_aud", clip,
                "--source_prompt", "a sine tone", "--target_prompt", "a dog barking",
                "--cfg_src", "3", "--cfg_tar", "12",
                "--num_diffusion_steps", str(STEPS), "--tstart", str(TSTART),
                "--seed", "0", "--results_path", os.path.join(tmp, name)] + extra
        fa.flash_attention_cuda.launches = 0
        out = run_edit(argv)
        launches = fa.flash_attention_cuda.launches
        with open(os.path.join(os.path.dirname(out), "run_args.json")) as f:
            rec = json.load(f)
        sr, wav = wavfile.read(out)
        forwards = rec["unet_steps"]
        run = {"launches": launches, "unet_forwards": forwards,
               "edit_s": rec["edit_seconds"], "steps_per_s": forwards / rec["edit_seconds"],
               "wav_samples": int(wav.shape[-1]), "selfcheck_snr_db": rec["selfcheck_snr_db"]}
        log(f"[phase3] {name}: {run}")
        if forwards != STEPS + TSTART or launches != ATTN_CALLS_PER_FORWARD * forwards:
            raise AssertionError(f"{name}: {launches} kernel launches for {forwards} "
                                 f"UNet forwards, expected {ATTN_CALLS_PER_FORWARD} each")
        if sr != 16000 or wav.shape[-1] < 10 * 16000 or not np.any(wav):
            raise AssertionError(f"{name}: bad output wav {out}: sr {sr}, shape {wav.shape}")
        runs[name] = run
    if not runs["selfcheck"]["selfcheck_snr_db"] >= 40.0:
        raise AssertionError(f"selfcheck SNR {runs['selfcheck']['selfcheck_snr_db']} < 40 dB")
    return runs


def _kernel_class(name: str) -> str:
    n = name.lower()
    for cls, keys in (("attention kernel B1", ("attn_fwd_kernel",)),
                      ("convolution", ("fprop", "conv", "implicit_gemm", "winograd", "fft")),
                      ("matmul", ("gemm", "cutlass", "cublas")),
                      ("norm", ("norm", "welford")),
                      ("softmax", ("softmax",))):
        if any(k in n for k in keys):
            return cls
    return "elementwise/other"


def profile_main_path_step(n_steps: int = 6) -> dict:
    """torch.profiler over n CFG UNet steps of the main path's config."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from audioeditingcode_tpu_torch.editing.cfg import build_cfg_tensors
    from audioeditingcode_tpu_torch.models.registry import load_model

    pipe = load_model(MODEL_ID, STEPS, device="cuda", seed=0)
    x = torch.randn((1,) + LATENT, device="cuda", generator=torch.Generator("cuda").manual_seed(3))
    cfg, _ = build_cfg_tensors(x.shape, ["a dog barking"], [12.0], device="cuda")
    den = pipe.make_denoiser(pipe.encode_text([""], negative=True),
                             pipe.encode_text(["a dog barking"]), cfg)
    for k in range(2):
        den(x, k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(n_steps):
        den(x, k)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for k in range(n_steps):
            den(x, k)
        torch.cuda.synchronize()
    by_class, kernels = {}, []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        ms = e.self_device_time_total / 1e3 / n_steps
        by_class[_kernel_class(e.key)] = by_class.get(_kernel_class(e.key), 0.0) + ms
        kernels.append((ms, e.count // n_steps, e.key[:90]))
    busy = sum(by_class.values())
    out = {"step_wall_ms": wall_ms, "device_busy_ms": busy,
           "idle_share": max(0.0, 1.0 - busy / wall_ms),
           "device_ms_by_class": dict(sorted(by_class.items(), key=lambda kv: -kv[1]))}
    log(f"[profile] {json.dumps(out)}")
    for ms, count, key in sorted(kernels, reverse=True)[:15]:
        log(f"[profile]   {ms:8.3f} ms/step  x{count:<4d} {key}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one card", file=sys.stderr)
        return 2
    from audioeditingcode_tpu_torch.ops import build
    from audioeditingcode_tpu_torch.ops import flash_attention as fa
    from audioeditingcode_tpu_torch.utils.device import resolve_device

    resolve_device("cuda", 0)  # also turns TF32 off for float32
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"[phase0] device {name}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    logs = build.build()
    build_s = time.perf_counter() - t0
    spills = sum(" 0 bytes spill stores" not in line
                 for log_ in logs.values() for line in log_.splitlines() if "spill stores" in line)
    log(f"[phase0] built {sorted(logs) or 'nothing (up to date)'} in {build_s:.1f} s; "
        f"kernel instances with register spills: {spills}")

    cases = phase1_attention(fa)
    parity = phase2_unet_parity(fa)
    with tempfile.TemporaryDirectory() as tmp:
        runs = phase3_main_path(fa, tmp)
    if "--profile" in sys.argv[1:]:
        profile_main_path_step()

    main_case = cases[0]
    record = {"kernels": [{
        "name": "flash_attention", "route": "cuda",
        "source": "audioeditingcode_tpu_torch/csrc/flash_attention.cu",
        "replaces": "audioeditingcode_tpu/ops/flash_attention.py:72",
        "tpu_kernel": "ops/flash_attention.py::_attn_kernel",
        "launches": runs["edit"]["launches"],
        "launches_selfcheck": runs["selfcheck"]["launches"],
        "shape": main_case["shape"], "dtype": main_case["dtype"],
        "max_abs_err": main_case["max_abs_err"], "max_err": main_case["max_abs_err"],
        "ms": main_case["ms"], "kernel_ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"], "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": main_case["library_ms"],
        "cases": cases,
    }], "build_s": build_s, **parity,
        "edit_s": runs["edit"]["edit_s"], "steps_per_s": runs["edit"]["steps_per_s"],
        "selfcheck_snr_db": runs["selfcheck"]["selfcheck_snr_db"]}
    print(json.dumps(record), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
