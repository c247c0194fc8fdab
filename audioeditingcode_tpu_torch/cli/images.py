"""Image-editing CLIs on PyTorch: SDEdit, PC extraction and PC drift
application on Stable Diffusion v1.4 and the CelebA-HQ LDM.

Counterpart of ``audioeditingcode_tpu/cli/images.py``, with the same flags
plus ``--device`` and ``--device_num``, the same results layout and file
names. The three algorithms are the audio CLIs' own (``editing/sdedit.py``,
``cli/pc_extract.py::run_pc_extraction``, ``cli/pc_apply.py::
run_pc_application``), driving the image models through the same pipeline.
Run them as ``aetorch-images-sdedit``, ``aetorch-images-pc-extract`` and
``aetorch-images-pc-apply`` (or ``python -m
audioeditingcode_tpu_torch.cli.images sdedit|pc_extract|pc_apply ...``).
Each runs on the CUDA card ``--device_num`` unless ``--device cpu`` is
given; a missing card is an error. Images are read from PNG, JPEG, GIF,
BMP, TIFF or WebP as PIL reads them and written as PNG
(``utils/image_io.py::read_image``; other formats raise). The draws come from a
``torch.Generator`` seeded with ``--seed``. ``run_args.json`` records the
loop's seconds and denoiser forwards (``sdedit_seconds`` and
``unet_steps``; the PC CLIs' ``stage_seconds`` and ``stage_forwards``).
The attention kernels take every head dim up to 256, so any ``--resize``
runs on the card.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
import warnings
from typing import Tuple

import numpy as np
import torch

from ..editing.pcdata import load_extraction
from ..editing.sdedit import sdedit_loop
from ..models.registry import load_model
from ..utils.device import resolve_device
from ..utils.image_io import load_image, save_image
from .common import StageClock, dump_run_summary, init_wandb, set_reproducibility, timestamp_name
from .pc_apply import parse_args as pc_apply_parse_args, run_pc_application
from .pc_extract import run_pc_extraction

IMAGE_MODEL_CHOICES = [
    "CompVis/stable-diffusion-v1-4",
    "CompVis/ldm-celebahq-256",
    "test/tiny-sd",
    "test/tiny-celebahq",
]


def _resize_for(model_id: str, resize) -> Tuple[int, int]:
    if resize is not None:
        return tuple(resize)
    return (256, 256) if "celebahq" in model_id else (512, 512)


def _add_device_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"],
                   help="run on a CUDA card (default) or on the CPU")
    p.add_argument("--device_num", type=int, default=0, help="CUDA card number")


def _save_path(results_path: str, model_id: str, init_im: str, prompts, neg) -> str:
    return os.path.join(
        results_path,
        model_id.split("/")[1] if "/" in model_id else model_id,
        os.path.basename(init_im).split(".")[0],
        "pmt_" + "__".join(x.replace(" ", "_") for x in prompts)
        + "__neg__" + "__".join(x.replace(" ", "_") for x in neg),
    )


def _decoded(pipe, xt: torch.Tensor) -> np.ndarray:
    x = pipe.vae_decode(xt).float().cpu().numpy()
    if not np.all(np.isfinite(x)):
        raise FloatingPointError("the image decoded to non-finite values")
    return np.clip(x, -1, 1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# --------------------------------------------------------------- sdedit
def sdedit_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="SDEdit on images")
    _add_device_flags(p)
    p.add_argument("-s", "--seed", type=int, default=None)
    p.add_argument("--model_id", type=str, choices=IMAGE_MODEL_CHOICES,
                   default="CompVis/stable-diffusion-v1-4")
    p.add_argument("--init_im", type=str, required=True)
    p.add_argument("--cfg_tar", type=float, default=12)
    p.add_argument("--num_diffusion_steps", type=int, default=100)
    p.add_argument("--target_prompt", type=str, nargs="+", default=[""])
    p.add_argument("--target_neg_prompt", type=str, nargs="+", default=[""])
    p.add_argument("--results_path", default="sdedit")
    p.add_argument("--tstart", type=int, default=50)
    p.add_argument("-r", "--resize", nargs=2, type=int, default=None)
    p.add_argument("--weights_dir", type=str, default=None)
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--wandb_name", type=str, default=None)
    p.add_argument("--wandb_group", type=str, default=None)
    p.add_argument("--wandb_disable", action="store_true")
    return p


def sdedit_main(argv=None):
    args = sdedit_parser().parse_args(argv)
    args.eta = 1.0
    if not os.path.exists(args.init_im):
        raise FileNotFoundError(f"--init_im: no such file: {args.init_im}")
    resize = _resize_for(args.model_id, args.resize)
    device = resolve_device(args.device, args.device_num)
    seed = set_reproducibility(args.seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    skip = args.num_diffusion_steps - args.tstart
    image_name = f"s{args.seed}_skip{skip}_cfg{args.cfg_tar}"
    wandb = init_wandb(args, "sdedit_images", image_name)
    if args.weights_dir is None:
        warnings.warn("--weights_dir not given: running with RANDOM weights.")

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    pipe = load_model(args.model_id, args.num_diffusion_steps, device=device, dtype=dtype,
                      seed=seed, weights_dir=args.weights_dir)
    x0 = torch.as_tensor(load_image(args.init_im, resize=resize), device=device)
    w0 = pipe.vae_encode(x0)

    uncond = pipe.encode_text(args.target_neg_prompt, negative=True)
    tgt = pipe.encode_text(args.target_prompt)
    runs = args.num_diffusion_steps - skip
    noise = torch.randn(w0.shape, generator=gen, device=device, dtype=w0.dtype)
    latents = torch.randn((runs,) + tuple(w0.shape), generator=gen, device=device,
                          dtype=w0.dtype)
    _sync(device)
    t0 = time.perf_counter()
    xt = sdedit_loop(pipe.sched, pipe.make_eps_pair(uncond, tgt), w0, noise, latents,
                     skip=skip, cfg_tar=float(args.cfg_tar), eta=args.eta)
    _sync(device)
    sdedit_s = time.perf_counter() - t0
    print(f"[sdedit] {sdedit_s:.3f} s for {runs} denoiser steps "
          f"({runs / max(sdedit_s, 1e-9):.2f} steps/s) on {device}")
    x_dec = _decoded(pipe, xt)

    save_path = _save_path(args.results_path, args.model_id, args.init_im,
                           args.target_prompt, args.target_neg_prompt)
    os.makedirs(save_path, exist_ok=True)
    out = os.path.join(save_path, image_name + ".png")
    save_image(out, x_dec)
    save_image(os.path.join(save_path, "orig.png"), x0.float().cpu().numpy())
    dump_run_summary(save_path, args, {"seed": seed, "device": str(device),
                                       "sdedit_seconds": sdedit_s, "unet_steps": runs})
    print(f"[+] saved {out}")
    wandb.finish()
    return out


# --------------------------------------------------------------- pc extract
def pc_extract_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Extract PCs for a real image")
    _add_device_flags(p)
    p.add_argument("-s", "--seed", type=int, default=None)
    p.add_argument("--cfg_tar", type=float, nargs="+", default=[3])
    p.add_argument("--model_id", type=str, choices=IMAGE_MODEL_CHOICES,
                   default="CompVis/stable-diffusion-v1-4")
    p.add_argument("--init_im", type=str, required=True)
    p.add_argument("--num_diffusion_steps", type=int, default=100)
    p.add_argument("--source_prompt", type=str, nargs="+", default=[""])
    p.add_argument("--target_neg_prompt", type=str, nargs="+", default=[""])
    p.add_argument("--corr_to_swap", type=float, default=0.8)
    p.add_argument("--drift_start", type=int, default=None)
    p.add_argument("--drift_end", type=int, default=None)
    p.add_argument("--results_path", default="pc_extractions")
    p.add_argument("-c", "--const", type=float, default=1e-3)
    p.add_argument("--n_evs", type=int, default=1)
    p.add_argument("-p", "--patch", nargs=4, default=None, type=int,
                   help="top bottom left right latent patch to restrict PCs to")
    p.add_argument("-t", "--iters", type=int, default=50)
    p.add_argument("-r", "--resize", nargs=2, type=int, default=(256, 256))
    p.add_argument("-d", "--dry", action="store_true")
    p.add_argument("--weights_dir", type=str, default=None)
    p.add_argument("--dtype", type=str, default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--wandb_name", type=str, default=None)
    p.add_argument("--wandb_group", type=str, default=None)
    p.add_argument("--wandb_disable", action="store_true")
    p.add_argument("--ts_chunk", type=int, default=1,
                   help="window steps per checkpoint (the results equal --ts_chunk 1)")
    return p


def pc_extract_main(argv=None):
    args = pc_extract_parser().parse_args(argv)
    args.pc_mode = "both"
    args.eta = 1.0
    args.numerical_fix = True
    if not os.path.exists(args.init_im):
        raise FileNotFoundError(f"--init_im: no such file: {args.init_im}")
    resize = tuple(args.resize)
    device = resolve_device(args.device, args.device_num)
    seed = set_reproducibility(args.seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    cfg_tar = float(np.atleast_1d(args.cfg_tar)[0])
    if args.drift_start is None:
        args.drift_start = args.num_diffusion_steps
    if args.drift_end is None:
        args.drift_end = -1

    image_name = (
        f"s{args.seed}_"
        + (f"p{'-'.join(str(x) for x in args.patch)}_" if args.patch is not None else "")
        + f"pc-{args.pc_mode}_cfgd{args.cfg_tar}_"
        + f"drift{args.drift_start}-{args.drift_end}_it{args.iters}_c{args.const:.1e}"
        + f"_{timestamp_name()}"
    )
    wandb = init_wandb(args, "pc_extraction_inv_images", image_name)
    if args.weights_dir is None:
        warnings.warn("--weights_dir not given: running with RANDOM weights.")
    if args.dtype == "bfloat16":
        # as cli/pc_extract.py: the finite-difference probe sits below
        # bfloat16's resolution and gives NaN eigenvectors
        warnings.warn("--dtype bfloat16 is numerically unsound for "
                      "finite-difference PC extraction (probe below bf16 "
                      "quantization); overriding to float32.")
        args.dtype = "float32"
    pipe = load_model(args.model_id, args.num_diffusion_steps, device=device,
                      dtype=torch.float32, seed=seed, weights_dir=args.weights_dir)
    x0 = torch.as_tensor(load_image(args.init_im, resize=resize), device=device)
    w0 = pipe.vae_encode(x0)

    save_path = _save_path(args.results_path, args.model_id, args.init_im,
                           args.source_prompt, args.target_neg_prompt)
    os.makedirs(save_path, exist_ok=True)
    clock = StageClock(device)
    ckpt_path, xt = run_pc_extraction(args, pipe, w0, gen, cfg_tar, save_path, image_name,
                                      seed, clock=clock)

    save_image(os.path.join(save_path, image_name + ".png"), _decoded(pipe, xt))
    save_image(os.path.join(save_path, "orig.png"), x0.float().cpu().numpy())
    window = len(load_extraction(ckpt_path[: -len(".npz")])["eig_ts"])
    power_s = clock.seconds.get("power_iteration", 0.0)
    dump_run_summary(save_path, args, {
        "seed": seed, "device": str(device), **clock.record(), "window_steps": window,
        "power_iteration_seconds_per_window_step": power_s / window if window else None,
    })
    print(f"[+] extraction saved to {ckpt_path}")
    wandb.finish()
    return ckpt_path


# --------------------------------------------------------------- pc apply
def pc_apply_main(argv=None):
    args = pc_apply_parse_args(argv)
    if args.drift_start < args.drift_end:
        raise ValueError("Drift start must be greater than drift end")
    for suffix in (".pt", ".npz"):
        if args.extraction_path.endswith(suffix):
            args.extraction_path = args.extraction_path[: -len(suffix)]
    load = load_extraction(args.extraction_path)
    ex_args = load["args"]
    if args.weights_dir is None and getattr(ex_args, "weights_dir", None):
        args.weights_dir = ex_args.weights_dir
    device = resolve_device(args.device, args.device_num)
    seed = set_reproducibility(args.seed)
    wandb = init_wandb(args, "pc_application_images",
                       f"drift{args.drift_start}-{args.drift_end}_a{args.amount}")

    eigdata = load["eigdata"]
    latents = torch.as_tensor(load["latents"], device=device)
    xts = torch.as_tensor(load["xts"], device=device) if args.fix_alpha is not None else None
    rng = np.random.default_rng(seed)
    if args.rand_v:
        for k in eigdata:
            v = eigdata[k]["eigvec"]
            r = rng.standard_normal(v.shape).astype(np.float32)
            eigdata[k]["eigvec"] = r / np.linalg.norm(r) * np.linalg.norm(v)

    args.fade_length = int(args.fade_length * latents.shape[3] / 15)
    S = int(ex_args.num_diffusion_steps)
    if args.weights_dir is None:
        warnings.warn("running with RANDOM weights.")
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    # the random weights are the extraction's: seeded by its seed
    pipe = load_model(ex_args.model_id, S, device=device, dtype=dtype,
                      seed=int(ex_args.seed), weights_dir=args.weights_dir)
    cfg_tar = float(getattr(ex_args, "cfg_tar_scalar", np.atleast_1d(ex_args.cfg_tar)[0]))
    clock = StageClock(device)
    xt = run_pc_application(args, pipe, ex_args, eigdata, latents, xts, cfg_tar,
                            float(ex_args.eta), clock=clock)

    drifts_path = args.extraction_path + "_driftgens"
    os.makedirs(drifts_path, exist_ok=True)
    outputs = []
    for i in range(xt.shape[0]):
        ev_tag = ("pcs" + "".join(str(x) for x in args.evs)) if args.combine_evs \
            else f"pc{args.evs[min(i, len(args.evs) - 1)]}"
        name = (f"{ev_tag}_drift{args.drift_start}-{args.drift_end}"
                f'{"_RAND" if args.rand_v else ""}_a{args.amount}.png')
        out = os.path.join(drifts_path, name)
        save_image(out, _decoded(pipe, xt[i: i + 1]))
        outputs.append(out)
    dump_run_summary(drifts_path, args, {"seed": seed, "device": str(device),
                                         **clock.record()})
    for o in outputs:
        print(f"[+] saved {o}")
    wandb.finish()
    return outputs


_COMMANDS = {"sdedit": sdedit_main, "pc_extract": pc_extract_main, "pc_apply": pc_apply_main}

if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] not in _COMMANDS:
        sys.exit(f"usage: python -m audioeditingcode_tpu_torch.cli.images "
                 f"{{{'|'.join(_COMMANDS)}}} [flags]")
    _COMMANDS[sys.argv[1]](sys.argv[2:])
