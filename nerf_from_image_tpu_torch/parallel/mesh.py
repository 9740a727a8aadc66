"""Data parallel over torch.distributed: one process per device.

Counterpart of nerf_from_image_tpu/parallel/mesh.py. The JAX package runs
SPMD over a device mesh and lets XLA insert the gradient all-reduce; here
each rank is a process holding one device, and the collectives are
written out where the JAX step's psum sits. The contract is the JAX
package's, and a run on W ranks gives what the run on one rank gives:

- every rank holds the identical GLOBAL batch and keeps its contiguous
  rows (`shard_batch`); parameters and optimizer state start equal on
  every rank (`replicate`: broadcast from rank 0);
- every random draw inside a step is taken at the global shape from the
  same generator on every rank and cut to the rank's rows (`draw` under
  `sharded_draws`), so the world size changes no number, and the
  generators stay in step;
- gradients are averaged by one flattened all-reduce before the
  optimizer's global-norm clip (`all_reduce_mean`); the statistics that
  couple the batch (the path-length mean, ADA's sign, logged metrics) are
  all-reduced too (`mean`, `mean_metrics`);
- report rows and FID activations are gathered in global order
  (`gather_rows`), and rank 0 alone writes files (`is_main`, `barrier`).

A group is joined from torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) or from the JAX package's explicit
topology (COORDINATOR_ADDRESS with NFI_NUM_PROCESSES and NFI_PROCESS_ID);
`--chips N` / `--gpus N` with neither spawns N local processes. The
backend follows the topology: nccl when each rank has a card of its own,
gloo on the CPU and when ranks share a card (host-staged collectives).
A failure to join propagates: there is no single-process fallback.
"""

from __future__ import annotations

import contextlib
import datetime
import functools
import os
import socket
import tempfile
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

INIT_TIMEOUT_S = 1800.0
_TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_DRAW_AXIS: List[Optional[int]] = []
_DEVICE: List[torch.device] = []  # this rank's device, once a group is joined


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def launcher_topology(env=None) -> Optional[Dict[str, object]]:
    """The process group the environment describes: {'rank', 'world',
    'local_rank', 'local_world', 'init_method'}, or None without one.
    A partial topology raises ValueError naming the missing variable."""
    env = os.environ if env is None else env
    if any(k in env for k in ("RANK", "WORLD_SIZE")):
        missing = [k for k in _TORCHRUN if k not in env]
        if missing:
            raise ValueError(f"an incomplete torchrun topology: {', '.join(missing)} "
                             f"missing (set all of {', '.join(_TORCHRUN)})")
        r, w = int(env["RANK"]), int(env["WORLD_SIZE"])
        return {"rank": r, "world": w, "local_rank": int(env.get("LOCAL_RANK", r)),
                "local_world": int(env.get("LOCAL_WORLD_SIZE", w)),
                "init_method": f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"}
    addr = env.get("COORDINATOR_ADDRESS") or env.get("JAX_COORDINATOR_ADDRESS")
    if not addr:
        return None
    have_n, have_id = "NFI_NUM_PROCESSES" in env, "NFI_PROCESS_ID" in env
    if not (have_n and have_id):
        # The JAX package falls back to jax's cluster auto-detection when
        # both are missing; torch has none, so that is an error here too.
        missing = [k for k, have in (("NFI_NUM_PROCESSES", have_n),
                                     ("NFI_PROCESS_ID", have_id)) if not have]
        raise ValueError(
            f"COORDINATOR_ADDRESS={addr} is set with an incomplete explicit topology: "
            f"{' and '.join(missing)} missing. Set both NFI_NUM_PROCESSES and "
            "NFI_PROCESS_ID.")
    r, w = int(env["NFI_PROCESS_ID"]), int(env["NFI_NUM_PROCESSES"])
    return {"rank": r, "world": w, "local_rank": int(env.get("LOCAL_RANK", r)),
            "local_world": int(env.get("LOCAL_WORLD_SIZE", w)), "init_method": f"tcp://{addr}"}


def rank_device(device, local_rank: int) -> torch.device:
    """This rank's device: for 'cuda' without an index, card
    local_rank modulo the visible cards."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                               "on the CPU")
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def init_process_group(rank_: int, world: int, init_method: str, device="cpu",
                       local_world: Optional[int] = None,
                       timeout_s: float = INIT_TIMEOUT_S) -> torch.device:
    """Joins a group of `world` ranks and returns this rank's device; the
    backend is nccl when each of the host's `local_world` ranks has a card
    of its own, gloo otherwise (the CPU, or ranks sharing a card)."""
    local_world = world if local_world is None else local_world
    dev = rank_device(device, rank_ if local_world == world else rank_ % local_world)
    backend = "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        if local_world <= torch.cuda.device_count():
            backend = "nccl"
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank_,
                            timeout=datetime.timedelta(seconds=timeout_s), **kwargs)
    _DEVICE[:] = [dev]
    return dev


def maybe_init_multihost(args=None, device="cuda") -> torch.device:
    """A driver's entry: joins the group that the environment describes
    (or keeps the one already joined) and returns this rank's device.
    Raises where --chips/--gpus disagrees with the group's size, and for
    --multihost without a topology."""
    chips = int(getattr(args, "chips", 0) or 0) if args is not None else 0
    if dist.is_available() and dist.is_initialized():
        if chips not in (0, world_size()):
            raise ValueError(f"--chips/--gpus {chips} under a group of {world_size()} ranks")
        return _DEVICE[0] if _DEVICE else torch.device(device)
    topo = launcher_topology()
    if topo is None:
        if args is not None and getattr(args, "multihost", False):
            raise ValueError("--multihost needs a launcher: torchrun's environment "
                             "(RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) or "
                             "COORDINATOR_ADDRESS with NFI_NUM_PROCESSES and NFI_PROCESS_ID")
        if chips > 1:
            raise ValueError(f"--chips/--gpus {chips} without a group: launch through "
                             "spawn_local or torchrun")
        from nerf_from_image_tpu_torch.utils.device import resolve_device

        return resolve_device(device)
    if chips not in (0, topo["world"]):
        raise ValueError(f"--chips/--gpus {chips} under a launcher of {topo['world']} ranks")
    dev = init_process_group(topo["rank"], topo["world"], topo["init_method"], device,
                             topo["local_world"])
    if topo["world"] > 1:
        print(f"multihost: rank {topo['rank']}/{topo['world']} on {dev} "
              f"({dist.get_backend()})")
    return dev


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(local_rank: int, module: str, argv: Sequence[str], world: int, port: int,
             result_path: str) -> None:
    import importlib

    os.environ.update(RANK=str(local_rank), WORLD_SIZE=str(world), LOCAL_RANK=str(local_rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    out = importlib.import_module(module).main(list(argv))
    if local_rank == 0:
        torch.save(out, result_path)
    dist.destroy_process_group()


def spawn_local(args, module: str, argv: Optional[Sequence[str]]):
    """--chips/--gpus N > 1 with no launcher and no group: runs `module`'s
    main(argv) in N local processes, one card each (one CPU process each
    under --device cpu), and returns (True, rank 0's result); (False,
    None) when there is nothing to spawn. More ranks than visible cards
    raise."""
    import sys

    import torch.multiprocessing as mp

    n = int(args.chips or 0)
    if n <= 1 or launcher_topology() is not None or (dist.is_available()
                                                     and dist.is_initialized()):
        return False, None
    if torch.device(args.device).type == "cuda":
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > visible:
            raise ValueError(f"--chips/--gpus {n} but {visible} visible cards")
    argv = list(sys.argv[1:] if argv is None else argv)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rank0.pt")
        mp.start_processes(_spawned, args=(module, argv, n, _free_port(), path), nprocs=n,
                           start_method="spawn")
        return True, torch.load(path, weights_only=False)


# --- batches and draws -----------------------------------------------------

def local_batch(global_batch: int) -> int:
    """This rank's share of a global batch; raises unless W divides it."""
    w = world_size()
    if global_batch % w:
        raise ValueError(f"global batch {global_batch} is not divisible by {w} ranks")
    return global_batch // w


def row_block(n: int) -> slice:
    """This rank's contiguous block of n rows; raises unless W divides n."""
    w = world_size()
    if n % w:
        raise ValueError(f"{n} rows are not divisible by {w} ranks")
    return slice(rank() * (n // w), (rank() + 1) * (n // w))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return None if tree is None else fn(tree)


def shard_batch(tree, global_batch: int):
    """This rank's contiguous rows [r·B/W, (r+1)·B/W) of every batched leaf
    (tensors or arrays, in dicts, lists or tuples; scalars and None kept).

    CONTRACT: every rank passes the identical GLOBAL batch of
    `global_batch` rows. A leaf with another leading size (a per-rank
    slice passed as global) raises ValueError, and so does a batch that W
    does not divide (checks that survive `python -O`)."""
    n = local_batch(global_batch)
    r = rank()

    def take(x):
        if np.ndim(x) == 0:
            return x
        if np.shape(x)[0] != global_batch:
            raise ValueError(
                f"shard_batch expects the GLOBAL batch ({global_batch} rows) on every "
                f"rank, got {np.shape(x)[0]}: did a caller pass a per-rank slice?")
        return x[r * n:(r + 1) * n]

    return _map(tree, take)


@contextlib.contextmanager
def sharded_draws(axis: int = 0):
    """Inside, `draw` takes every draw at the global shape (`axis` times
    the world size) and keeps this rank's block of it."""
    if world_size() == 1:
        yield
        return
    _DRAW_AXIS.append(axis)
    try:
        yield
    finally:
        _DRAW_AXIS.pop()


def sharded_step(fn):
    """Runs `fn` (a step over a batch whose rows the ranks share) under
    sharded_draws(axis=0)."""
    @functools.wraps(fn)
    def step(*args, **kwargs):
        with sharded_draws(0):
            return fn(*args, **kwargs)

    return step


def batch_sharded() -> bool:
    """True inside a sharded step on several ranks."""
    return bool(_DRAW_AXIS) and _DRAW_AXIS[-1] == 0


def draw(fn: Callable[..., torch.Tensor], shape, **kwargs) -> torch.Tensor:
    """fn(shape, **kwargs), a draw of independent numbers (torch.rand,
    torch.randn); under `sharded_draws` the rank's block of the global
    draw, so every rank's generator advances alike."""
    axis = _DRAW_AXIS[-1] if _DRAW_AXIS else None
    if axis is None:
        return fn(tuple(shape), **kwargs)
    shape = list(shape)
    n = shape[axis]
    shape[axis] = n * world_size()
    return fn(tuple(shape), **kwargs).narrow(axis, rank() * n, n).contiguous()


# --- collectives -----------------------------------------------------------

def _staged(t: torch.Tensor) -> bool:
    """gloo collectives go through host memory for card tensors."""
    return t.is_cuda and dist.get_backend() == "gloo"


def all_reduce_mean(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over ranks of each tensor, by one flattened all-reduce."""
    w = world_size()
    if w == 1 or not tensors:
        return tensors
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    if _staged(flat):
        host = flat.cpu()
        dist.all_reduce(host)
        flat.copy_(host)
    else:
        dist.all_reduce(flat)
    flat.div_(w)
    return [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def mean(t: torch.Tensor) -> torch.Tensor:
    """The mean over ranks of a (detached) tensor."""
    return all_reduce_mean([t])[0]


def mean_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Every scalar metric averaged over ranks, in one all-reduce."""
    if world_size() == 1 or not metrics:
        return metrics
    keys = list(metrics)
    return dict(zip(keys, all_reduce_mean([metrics[k] for k in keys])))


def replicate(tensors) -> None:
    """Broadcasts tensors (parameters, buffers, optimizer moments) from
    rank 0 in place."""
    if world_size() == 1:
        return
    for t in tensors:
        if _staged(t):
            host = t.detach().cpu()
            dist.broadcast(host, 0)
            t.data.copy_(host)
        else:
            dist.broadcast(t.data, 0)


def replicate_modules(*modules) -> None:
    """replicate() over modules' parameters and buffers (None skipped)."""
    for m in modules:
        if m is not None:
            replicate(list(m.parameters()) + list(m.buffers()))


def gather_objects(obj) -> List[object]:
    """Every rank's picklable `obj`, in rank order, on every rank."""
    if world_size() == 1:
        return [obj]
    parts: List[object] = [None] * world_size()
    dist.all_gather_object(parts, obj)
    return parts


def gather_rows(tree):
    """A host array, or a dict of them (per-row metrics), with rows
    concatenated over ranks in rank order, on every rank."""
    if world_size() == 1:
        return tree
    parts = gather_objects(tree)

    def cat(*leaves):
        return np.concatenate([np.asarray(x) for x in leaves])

    if isinstance(tree, dict):
        return {k: cat(*(p[k] for p in parts)) for k in tree}
    return cat(*parts)


def all_gather_rows(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """The autograd-aware concatenation of every rank's `x` along `dim`:
    the gradient of each rank's block is the sum over ranks of the
    gradients that reach it."""
    if world_size() == 1:
        return x
    from torch.distributed.nn.functional import all_gather

    staged = _staged(x)
    parts = all_gather(x.cpu() if staged else x)
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if staged else out
