"""Starting the ranks of a parallel run.

JAX is single-controller: one process drives every device of its mesh, so
the JAX package has no counterpart of this module. Here a run over
dp * tp * sp devices is that many processes, one per device, joined by a
``torch.distributed`` process group:

- :func:`run_on_ranks` is what a CLI calls with its parsed args. A run that
  asks for no parallelism runs as it is. A run already inside a process
  group (a rank started here, or under ``torchrun``, which sets
  ``WORLD_SIZE``) joins it. A run of one device that asks for sp (``--sp
  1``) builds a real process group of one in this process, so the sp path
  runs its collectives. A larger run starts its ranks with
  ``torch.multiprocessing`` and returns rank 0's result.
- Rank r takes card ``device_num + r`` with NCCL, or the CPU with gloo under
  ``--device cpu``; the store is a file in a temporary directory. Asking
  for more ranks than cards raises before any rank starts.
- An exception on any rank stops the others and is raised in the parent;
  nothing is swallowed. Only rank 0 writes results (:func:`is_writer`).
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import time
import traceback
from contextlib import contextmanager
from typing import Any, Callable, List, Optional

import torch
from torch import distributed as dist
from torch import multiprocessing as mp

# how long a collective waits for the other ranks before it fails
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def requested_sp(args) -> Optional[int]:
    """The CLI's --sp: None where not given or 0 (the no-op), else its value."""
    sp = getattr(args, "sp", None)
    return None if sp is None or sp < 1 else sp


def is_writer() -> bool:
    """True on the rank that writes a run's results: rank 0, or the only
    process of a run without a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _backend(device: str) -> str:
    return "nccl" if device == "cuda" else "gloo"


@contextmanager
def process_group(rank: int, world: int, device: str, store: Optional[str] = None,
                  device_num: int = 0):
    """The default process group for this rank, destroyed on exit: from a
    file store at ``store``, or from torchrun's environment when it is
    None. On the card, rank r's device is ``device_num`` (set current
    before the group starts)."""
    if device == "cuda":
        torch.cuda.set_device(device_num)
    init = "env://" if store is None else f"file://{store}"
    dist.init_process_group(_backend(device), init_method=init, rank=rank, world_size=world,
                            timeout=COLLECTIVE_TIMEOUT)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _check_cards(device: str, device_num: int, n: int) -> None:
    if device != "cuda":
        return
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if device_num + n > have:
        raise ValueError(f"{n} ranks from --device_num {device_num} need cards "
                         f"{device_num}..{device_num + n - 1}; {have} CUDA device(s)")


def _rank_main(rank: int, fn: Callable, args: tuple, world: int, device: str,
               device_num: int, tmp: str) -> None:
    if device == "cpu":
        # one intra-op thread a rank: the ranks share the host's cores, and
        # with several multi-threaded ranks starting at once the first call
        # of a CPU op (torch.exp) was seen to differ from its later calls
        torch.set_num_threads(1)
    with process_group(rank, world, device, os.path.join(tmp, "store"), device_num + rank):
        try:
            result = fn(*args)
        except BaseException:
            # when and why, written before the group goes down, for the
            # parent to name the rank that failed first (the others then
            # fail in their collectives)
            with open(os.path.join(tmp, f"error{rank}.txt"), "w") as f:
                f.write(f"{time.time()!r}\n{traceback.format_exc()}")
            raise
    torch.save(result, os.path.join(tmp, f"result{rank}.pt"))


def _joined(ctx, tmp: str) -> bool:
    """ctx.join for a second; a failed rank raises RuntimeError with the
    traceback of the rank that failed first."""
    try:
        return ctx.join(timeout=1.0)
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
        errors = []
        for name in os.listdir(tmp):
            if name.startswith("error"):
                with open(os.path.join(tmp, name)) as f:
                    when, tb = f.read().split("\n", 1)
                errors.append((float(when), int(name[5:-4]), tb))
        if not errors:
            raise
        _, rank, tb = min(errors)
        raise RuntimeError(f"rank {rank} of {len(ctx.processes)} failed first:\n{tb}") from e


def spawn(fn: Callable, world: int, *args, device: str = "cpu", device_num: int = 0,
          timeout: Optional[float] = None) -> List[Any]:
    """Run fn(*args) on ``world`` new processes, each rank r inside the
    default process group (gloo on the CPU; NCCL on card device_num + r);
    returns every rank's result, in rank order. fn must be importable by
    name (a module-level function) and its results picklable. A failing
    rank stops the others and raises here; past ``timeout`` seconds every
    rank is stopped and TimeoutError raised. The error raised names the
    rank that failed first, with its traceback."""
    _check_cards(device, device_num, world)
    tmp = tempfile.mkdtemp(prefix="aec_ranks_")
    try:
        ctx = mp.start_processes(_rank_main, args=(fn, args, world, device, device_num, tmp),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = None if timeout is None else time.time() + timeout
        while not _joined(ctx, tmp):
            if deadline is not None and time.time() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"{world} ranks did not finish in {timeout} s")
        return [torch.load(os.path.join(tmp, f"result{r}.pt"), weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _agree_seed(args) -> None:
    """A --seed left out is drawn once, on rank 0, for every rank: each
    rank makes the same draws."""
    from .mesh import replicate

    if getattr(args, "seed", 0) is None:
        device = "cuda" if args.device == "cuda" else "cpu"  # NCCL takes card tensors
        seed = torch.tensor([int.from_bytes(os.urandom(4), "little")], device=device)
        args.seed = int(replicate(seed).item())


def _cli_rank(body: Callable, args):
    """One rank of a CLI run: its card is ``--device_num`` + its rank."""
    args.device_num += dist.get_rank()
    _agree_seed(args)
    return body(args)


def run_on_ranks(body: Callable, args):
    """Run a CLI's ``body(args)`` on the ranks its --dp, --tp and --sp ask
    for (see the module docstring); returns its result on rank 0 (this
    process's own result where no rank was started)."""
    sp = requested_sp(args)
    n = args.dp * args.tp * (sp or 1)
    if (n == 1 and sp is None) or dist.is_initialized():
        return body(args)
    if "WORLD_SIZE" in os.environ:  # torchrun: one rank of its group
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        if world != n:
            raise ValueError(f"--dp/--tp/--sp ask for {n} ranks; WORLD_SIZE is {world}")
        local = int(os.environ.get("LOCAL_RANK", rank))
        _check_cards(args.device, args.device_num, local + 1)
        args.device_num += local
        with process_group(rank, world, args.device, None, args.device_num):
            _agree_seed(args)
            return body(args)
    if n == 1:  # --sp 1: a real group of one, here
        _check_cards(args.device, args.device_num, 1)
        tmp = tempfile.mkdtemp(prefix="aec_ranks_")
        try:
            with process_group(0, 1, args.device, os.path.join(tmp, "store"), args.device_num):
                return body(args)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return spawn(_cli_rank, n, body, args, device=args.device, device_num=args.device_num)[0]
