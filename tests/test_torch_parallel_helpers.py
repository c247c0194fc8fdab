"""What the ranks of the parallel tests run (tests/test_torch_parallel.py,
tests/test_torch_parallel_cli.py): module-level functions, so that
``parallel.launch.spawn`` can start them by name in new processes, which
import only torch and the port. Each rank builds the tiny pipeline the
parent hands it (state dicts carried over from the JAX package by the
bridge), and returns numpy arrays or paths."""

import importlib
import os

import numpy as np
import torch
from torch import distributed as dist


def tiny_pipeline(model_id: str, steps: int, states: dict):
    """The port's tiny pipeline on the CPU with the given state dicts."""
    from audioeditingcode_tpu_torch.models.registry import load_model

    pipe = load_model(model_id, steps, device="cpu")
    for name, sd in states.items():
        getattr(pipe, name).load_state_dict(sd)
    if hasattr(pipe, "setup_duration"):
        pipe.setup_duration()
    return pipe


def pipeline_states(pipe) -> dict:
    """The state dicts a rank needs to rebuild ``pipe``."""
    names = ("dit", "vae", "projection") if hasattr(pipe, "dit") else ("unet", "vae", "vocoder")
    return {n: {k: v.clone() for k, v in getattr(pipe, n).state_dict().items()}
            for n in names}


def _plain_swiglu_shard(proj, axis):
    """A wrong tp split of the SwiGLU weight, for the mutation test: a plain
    output-row shard, which gives rank 0 value rows only."""
    from torch import nn

    from audioeditingcode_tpu_torch.parallel.mesh import _gather_channels

    lin = proj.proj
    n = lin.weight.shape[0] // axis.size
    lo = axis.index * n
    lin.weight = nn.Parameter(lin.weight.detach()[lo: lo + n].contiguous(), requires_grad=False)
    lin.bias = nn.Parameter(lin.bias.detach()[lo: lo + n].contiguous(), requires_grad=False)
    proj.register_forward_hook(_gather_channels(axis, -1))


def _sp_attention_without_kv_len(q, kf, vf, kv_len):
    """A wrong sp attention, for the mutation test: the padded keys are not
    masked."""
    from audioeditingcode_tpu_torch.ops import flash_attention as fa

    return fa.attention_reference(q, kf, vf)


def denoise(model_id: str, steps: int, states: dict, x: np.ndarray, k: int, cfg: float,
            dp: int = 1, tp: int = 1, sp=None, min_seq=None, mutant=None) -> dict:
    """One CFG denoiser call (empty prompt against "a violin") on this rank,
    with the pipeline sharded over a (dp, tp[, sp]) mesh; ``min_seq`` lowers
    the attention dispatcher's kernel threshold (the tiny DiT's 17 tokens
    then take the kernel route, its plain version on the CPU). Returns the
    output and how often each sp route ran."""
    from audioeditingcode_tpu_torch.cli.common import maybe_shard_pipeline
    from audioeditingcode_tpu_torch.ops import flash_attention as fa

    if min_seq is not None:
        fa._MIN_SEQ_FOR_KERNEL = min_seq
    if mutant == "swiglu_plain_shard":
        from audioeditingcode_tpu_torch.models import dit1d

        dit1d._SwiGLUProj.tp_shard = _plain_swiglu_shard
    calls = {"kernel": 0}
    real = (_sp_attention_without_kv_len if mutant == "sp_without_kv_len"
            else fa._sp_blocked_attention)

    def counted(*a, **kw):
        calls["kernel"] += 1
        return real(*a, **kw)

    fa._sp_blocked_attention = counted
    pipe = tiny_pipeline(model_id, steps, states)
    mesh = maybe_shard_pipeline(pipe, dp, tp, sp)
    empty = pipe.encode_text([""], negative=True)
    den = pipe.make_denoiser(empty, pipe.encode_text(["a violin"]),
                             torch.full((1,) + x.shape[1:], float(cfg)))
    with torch.no_grad(), fa.sp_mesh_scope(mesh):
        out = den(torch.from_numpy(x), k)
    return {"out": out.numpy(), "sp_kernel_calls": calls["kernel"],
            "mesh": None if mesh is None else dict(mesh.shape)}


def sp_attention(q, k, v, cos, sin, sp: int, min_seq: int) -> np.ndarray:
    """fused_attention over this rank's rows of (B, S0, ...) q, k, v padded
    to a multiple of 8 sp, with the rotary tables of the same rows, under an
    sp mesh; returns the gathered (B, S0, H, D) output and the sp kernel
    route's calls."""
    import torch.nn.functional as F

    from audioeditingcode_tpu_torch.ops import flash_attention as fa
    from audioeditingcode_tpu_torch.parallel.mesh import make_mesh

    fa._MIN_SEQ_FOR_KERNEL = min_seq
    calls = []
    real = fa._sp_blocked_attention
    fa._sp_blocked_attention = lambda *a, **kw: (calls.append(1), real(*a, **kw))[1]
    mesh = make_mesh(sp, dp=1, tp=1, sp=sp)
    axis = mesh.axis("sp")
    S0 = q.shape[1]
    S = -(-S0 // (8 * sp)) * 8 * sp
    n = S // sp
    rows = slice(axis.index * n, (axis.index + 1) * n)
    pad = [torch.from_numpy(t) for t in (q, k, v)]
    q_l, k_l, v_l = (F.pad(t, (0, 0, 0, 0, 0, S - S0))[:, rows] for t in pad)
    tables = tuple(F.pad(torch.from_numpy(t), (0, 0, 0, S - S0))[rows] for t in (cos, sin))
    with fa.sp_mesh_scope(mesh):
        out = fa.fused_attention(q_l, k_l, v_l, rotary=tables, kv_len=S0)
    return {"out": axis.gather(out, dim=1)[:, :S0].numpy(), "sp_kernel_calls": len(calls)}


def mesh_layout(dp: int, tp: int, sp) -> dict:
    """This rank's mesh coordinates, the ranks of each of its axis groups
    (all-gathered over the group) and a shard/gather round trip of 3 rows
    over each axis."""
    from audioeditingcode_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(dp=dp, tp=tp, sp=sp)
    groups, round_trips = {}, {}
    for name in mesh.shape:
        axis = mesh.axis(name)
        me = torch.tensor([dist.get_rank()])
        groups[name] = axis.gather(me).tolist()
        rows = torch.arange(3.0)[:, None].repeat(1, 2)
        part = axis.shard(rows)
        round_trips[name] = (tuple(part.shape), axis.gather(part, 3).tolist())
    return {"rank": dist.get_rank(), "coords": dict(mesh.coords), "shape": dict(mesh.shape),
            "groups": groups, "round_trips": round_trips}


def fail_on_rank(bad: int) -> None:
    """Raise on rank ``bad`` after the ranks meet once; the others then wait
    on a collective that never completes."""
    dist.barrier()
    if dist.get_rank() == bad:
        raise RuntimeError(f"rank {bad} failed on purpose")
    dist.barrier()


def cli(module: str, argv: list, model_id: str, steps: int, states: dict, noise=None):
    """One rank of a port CLI run (``module.main(argv)``) with the tiny
    pipeline built from ``states`` in place of the CLI's loader and, where
    given, ``noise`` as its inversion draw."""
    mod = importlib.import_module(f"audioeditingcode_tpu_torch.cli.{module}")
    pipe = tiny_pipeline(model_id, steps, states)
    mod.load_model = lambda *a, **kw: pipe
    if noise is not None:
        mod._inversion_noise = lambda gen, S, w0: noise.clone()
    return mod.main(argv)


def pc_extraction(model_id: str, steps: int, states: dict, argv: list, w0, inv, v0s,
                  out_dir: str):
    """The port's PC-extraction driver on this rank, with the given draws,
    on the mesh the argv's --dp/--tp ask for; rank 0 returns the npz."""
    from audioeditingcode_tpu_torch.cli import pc_extract as tpe
    from audioeditingcode_tpu_torch.cli.common import maybe_shard_pipeline

    pipe = tiny_pipeline(model_id, steps, states)
    args = tpe.parse_args(argv + ["--device", "cpu"])
    mesh = maybe_shard_pipeline(pipe, args.dp, args.tp)
    path, _ = tpe.run_pc_extraction(args, pipe, w0, None, 3.0, out_dir, "port", 3,
                                    inv_noise=inv, v0s=v0s, mesh=mesh)
    return path if dist.get_rank() == 0 and os.path.exists(path) else None
