"""Convert a diffusers / transformers checkpoint into a ``weights_dir``.

Counterpart of ``tools/convert_checkpoint.py``, with no JAX, flax,
transformers or safetensors package. Run it as ``python -m
audioeditingcode_tpu_torch.cli.convert_checkpoint`` or ``aetorch-convert``::

  aetorch-convert --model_id cvssp/audioldm2-music --src /path/to/snapshot \\
      --out weights/audioldm2-music

``--src`` is a checkpoint in the diffusers pipeline layout (``unet/``,
``vae/`` or ``vqvae/``, ``vocoder/``, ``transformer/``, ``language_model/``,
``projection_model/``, ``text_encoder/``, ``text_encoder_2/``,
``tokenizer/``, ``tokenizer_2/``; ``huggingface_hub.snapshot_download``
gives one). ``--out`` gets the layout every port CLI reads with
``--weights_dir`` (``models/registry.py``)::

  <out>/unet.msgpack  vae.msgpack  vocoder.msgpack          (mel families)
  <out>/dit.msgpack   oobleck.msgpack  projection.msgpack   (Stable Audio)
  <out>/gpt2.msgpack  projection_lm.msgpack                 (AudioLDM2)
  <out>/t5/  clap_text/  clip/                              (text towers)

It is a host tool, as the JAX one is: the modules are built on the ``meta``
device and filled on the CPU; it touches no card. The rules, and the strict
accounting that makes a checkpoint that does not fit raise, are in
``models/convert.py``. A text encoder whose subfolder is absent is skipped
with one line (the registry then uses the null encoder, as the JAX one
does); one that is present but does not convert raises.
"""

from __future__ import annotations

import argparse
import os
import time

from ..models import convert as cv
from ..models import registry
from ..models.tokenizers import export_tokenizer

_TOKENIZER_KIND = {"t5": "t5", "clap_text": "roberta", "clip": "clip"}


def _bytes_under(d: str) -> int:
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(d) for f in fs)


def _weight_bytes(files: dict) -> int:
    return sum(os.path.getsize(p) for p in set(files.values()))


def convert(model_id: str, src: str, out: str) -> dict:
    """Convert checkpoint ``src`` of ``model_id`` into ``out``; returns
    {part: {"read_bytes", "written_bytes", "seconds"}} for each part and
    text tower written."""
    spec = registry.resolve_spec(model_id)
    parts, towers = cv.model_parts(spec)
    os.makedirs(out, exist_ok=True)
    stats = {}
    for part in parts:
        t0 = time.perf_counter()
        subfolder, name = cv.PARTS[part]
        sd, files, d = cv.read_part(src, subfolder)
        module = cv.convert_part(spec, part, sd, files, d)
        path = os.path.join(out, name)
        written = registry.save_params(module, path)
        stats[part] = {"read_bytes": _weight_bytes(files), "written_bytes": written,
                       "seconds": time.perf_counter() - t0}
        print(f"[+] wrote {path}")
        del sd, module
    for tower in towers:
        t0 = time.perf_counter()
        model_sub, tok_sub, out_name = cv.TOWERS[tower]
        model_dir, tok_dir = os.path.join(src, model_sub), os.path.join(src, tok_sub)
        if not os.path.isdir(model_dir):
            print(f"[!] {out_name} skipped: no {model_dir}")
            continue
        d, files = os.path.join(out, out_name), {}
        cv.convert_text_tower(tower, model_dir, d, files)
        export_tokenizer(tok_dir, d, _TOKENIZER_KIND[out_name])
        stats[out_name] = {"read_bytes": _weight_bytes(files), "written_bytes": _bytes_under(d),
                           "seconds": time.perf_counter() - t0}
        print(f"[+] wrote {d}")
    return stats


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert a diffusers/transformers checkpoint into a weights_dir.")
    p.add_argument("--model_id", required=True, choices=sorted(registry.MODEL_SPECS))
    p.add_argument("--src", required=True,
                   help="local checkpoint dir (diffusers pipeline layout)")
    p.add_argument("--out", required=True, help="output weights_dir")
    args = p.parse_args(argv)
    convert(args.model_id, args.src, args.out)


if __name__ == "__main__":
    main()
