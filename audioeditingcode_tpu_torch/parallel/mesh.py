"""Process-group meshes: dp x tp (x sp) sharding for the editing workloads.

Counterpart of ``audioeditingcode_tpu/parallel/mesh.py``. JAX runs one
program over a device mesh and lets GSPMD place the collectives; here each
device is a process (``parallel/launch.py`` starts them) and the mesh holds
one ``torch.distributed`` process group per axis, over the ranks that share
every other coordinate. Ranks are laid out row-major over (dp, tp, sp), as
``mesh_utils.create_device_mesh`` lays out devices.

- 'dp' shards independent batch work: the windows of a long-form edit, the
  clips of a batch edit, the n_ev batch or the window steps of PC
  extraction. A single clip is replicated over dp.
- 'tp' shards the output channels of every weight whose output-channel
  count tp divides (``_param_spec``); each rank computes its slice and the
  slices are all-gathered along the channel axis, so the next layer (and
  the attention kernel) sees whole activations.
- 'sp' (opt-in) splits the Stable Audio DiT's token axis: each rank keeps
  its rows through every block and attends from them to the sp-gathered K/V
  (``ops/flash_attention._sp_blocked_attention``; ``models/dit1d.py``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional

import torch
from torch import distributed as dist
from torch import nn


def mesh_shape(n: int, dp: Optional[int] = None, tp: Optional[int] = None,
               sp: Optional[int] = None) -> Dict[str, int]:
    """The JAX ``make_mesh`` sizing rules over n devices: an explicit sp, 1
    included, gives the 3-axis (dp, tp, sp) mesh (tp 1 unless given);
    without sp, tp defaults to 2 on an even count; dp * tp (* sp) must be
    n."""
    if sp is not None:
        assert sp >= 1, f"sp must be >= 1, got {sp}"
        if tp is None:
            tp = 1
        dp = dp or n // (tp * sp)
        assert dp * tp * sp == n, f"dp({dp}) * tp({tp}) * sp({sp}) != n({n})"
        return {"dp": dp, "tp": tp, "sp": sp}
    if dp is None and tp is None:
        tp = 2 if n % 2 == 0 and n >= 2 else 1
        dp = n // tp
    elif dp is None:
        dp = n // tp
    elif tp is None:
        tp = n // dp
    assert dp * tp == n, f"dp({dp}) * tp({tp}) != n({n})"
    return {"dp": dp, "tp": tp}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: the axis sizes (``shape``, in order),
    its coordinate on each axis and the process group of each axis (the
    ranks that differ from it on that axis alone)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, object]

    def axis(self, name: str) -> "Axis":
        return Axis(self.groups[name], self.shape[name], self.coords[name])


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it: its group, size and this rank's
    index. ``shard`` and ``gather`` split a dim into contiguous blocks of
    ceil(n / size) and join them back."""

    group: object
    size: int
    index: int

    def block(self, n: int) -> int:
        return -(-n // self.size)

    def shard(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block of ``dim``, padded to the common block length by
        repeating its last row (the last row of x where the block is empty),
        so that every rank runs the same shapes."""
        n = x.shape[dim]
        c = self.block(n)
        lo, hi = min(self.index * c, n - 1), min((self.index + 1) * c, n)
        part = x.narrow(dim, lo, max(hi - lo, 1))
        if part.shape[dim] < c:
            last = part.narrow(dim, part.shape[dim] - 1, 1)
            part = torch.cat([part] + [last] * (c - part.shape[dim]), dim=dim)
        return part

    def gather(self, x: torch.Tensor, n: Optional[int] = None, dim: int = 0) -> torch.Tensor:
        """The ranks' blocks joined along ``dim`` in rank order (every rank
        gets the whole), cut to n rows (the unpadded length). An axis of one
        rank with a process group still runs the collective (``--sp 1``
        rehearses the sp path's)."""
        if self.group is None:
            out = x
        else:
            x = x.contiguous()
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x, group=self.group)
            out = torch.cat(parts, dim=dim)
        return out if n is None else out.narrow(dim, 0, n)


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: Optional[int] = None, sp: Optional[int] = None) -> Mesh:
    """The ('dp', 'tp') mesh, or ('dp', 'tp', 'sp') when sp is given (sp = 1
    included), over the ranks of the initialised default process group.
    Every rank must call it: each axis group is created by all ranks."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(parallel.launch starts one)")
    world = dist.get_world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} devices over a process group of {world}")
    shape = mesh_shape(n, dp, tp, sp)
    names, sizes = list(shape), list(shape.values())
    rank = dist.get_rank()
    coords, rest = {}, rank
    for name, size in reversed(list(zip(names, sizes))):
        coords[name] = rest % size
        rest //= size
    coords = {name: coords[name] for name in names}
    groups = {}
    for a, name in enumerate(names):
        others = [range(s) for i, s in enumerate(sizes) if i != a]
        for fixed in itertools.product(*others):
            ranks = []
            for j in range(sizes[a]):
                c = list(fixed)
                c.insert(a, j)
                r = 0
                for ci, si in zip(c, sizes):
                    r = r * si + ci
                ranks.append(r)
            group = dist.new_group(ranks)  # collective: every rank creates every group
            if rank in ranks:
                groups[name] = group
    return Mesh(shape=shape, coords=coords, groups=groups)


def replicate(x: torch.Tensor) -> torch.Tensor:
    """x as global rank 0 holds it, on every rank (in place): what the JAX
    function's placement on every device gives a value made on one."""
    dist.broadcast(x, src=0)
    return x


def batch_sharding(mesh: Optional[Mesh]) -> Optional[Axis]:
    """The leading batch axis (windows, clips, PCs, window steps) split over
    'dp' (``Axis.shard``/``gather``); None without a mesh or at dp 1."""
    return None if mesh is None or mesh.shape["dp"] == 1 else mesh.axis("dp")


def seq_sharding(mesh: Optional[Mesh]) -> Optional[Axis]:
    """The DiT's token axis split over 'sp'; None without a mesh or on one
    without an sp axis (an sp axis of size 1 counts)."""
    return mesh.axis("sp") if mesh is not None and "sp" in mesh.shape else None


_SHARDABLE = (nn.Linear, nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d)


def _param_spec(layer: nn.Module, tp: int) -> Optional[int]:
    """The weight dim that holds the output channels where tp shards them,
    else None (replicated): a Linear or ungrouped conv whose output-channel
    count tp divides. A ConvTranspose weight is (in, out, k), so its output
    channels are dim 1; the others' are dim 0."""
    if not isinstance(layer, _SHARDABLE) or getattr(layer, "groups", 1) != 1:
        return None
    dim = 1 if isinstance(layer, nn.ConvTranspose1d) else 0
    out = layer.weight.shape[dim]
    return dim if out % tp == 0 and out >= tp else None


def _gather_channels(axis: Axis, dim: int):
    """A forward hook that all-gathers the module's output slices along the
    channel ``dim`` (counted from the end for a Linear)."""

    def hook(module, inputs, out):
        return axis.gather(out, dim=dim % out.dim())

    return hook


def shard_module_params(module: nn.Module, mesh: Mesh) -> nn.Module:
    """Tensor-parallel sharding of a module in place: every layer that
    ``_param_spec`` shards keeps its rank's output-channel slice of weight
    and bias, and all-gathers its output along the channel axis. Layers a
    parent names in ``tp_replicate`` (their weights are read outside their
    forward) stay whole; a layer with a ``tp_shard(axis)`` method shards
    itself and its children (the DiT's SwiGLU projection, whose weight
    holds two halves). A tp of 1 changes nothing. Counterpart of the JAX
    function, which places a Flax param tree; in JAX, GSPMD replicates the
    SwiGLU kernel's operands, so its tp gathers that weight instead: both
    compute the same function."""
    axis = mesh.axis("tp")
    if axis.size == 1:
        return module
    skip, own = set(), []
    for name, m in module.named_modules():
        for child in getattr(m, "tp_replicate", ()):
            skip.add(f"{name}.{child}" if name else child)
        if hasattr(m, "tp_shard"):
            m.tp_shard(axis)
            own.append(name + ".")
    for name, m in module.named_modules():
        if name in skip or hasattr(m, "tp_shard") or any(name.startswith(p) for p in own):
            continue
        dim = _param_spec(m, axis.size)
        if dim is None:
            continue
        n = m.weight.shape[dim] // axis.size
        m.weight = nn.Parameter(m.weight.detach().narrow(dim, axis.index * n, n).contiguous(),
                                requires_grad=False)
        if m.bias is not None:
            m.bias = nn.Parameter(m.bias.detach().narrow(0, axis.index * n, n).contiguous(),
                                  requires_grad=False)
        # activations are (..., C) out of a Linear and (B, C, ...) out of a conv
        m.register_forward_hook(_gather_channels(axis, -1 if isinstance(m, nn.Linear) else 1))
    return module
