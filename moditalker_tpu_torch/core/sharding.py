"""Process group, mesh and batch placement on ``torch.distributed`` (port of
``moditalker_tpu/core/sharding.py``).

The JAX package runs one controller over a mesh of every device: one
program, the batch sharded along the ``data`` axis, collectives compiled
into it. PyTorch's way, and the port's, is one process per card: each
process holds the whole model on its own card, builds the global batch
exactly as every other process does, keeps its own rows of it
(``shard_batch``) and joins the others in explicit collectives — the
gradients averaged before the optimizer step (``all_reduce_grads``), the
logged losses averaged (``mean_over_ranks``), the preemption latch agreed
(``agree``). A run of one process needs no process group: every helper
here is then the identity.

``init_distributed`` starts the group: ``nccl`` on the card, ``gloo`` for
``device="cpu"``, with a ``tcp://`` rendezvous at the coordinator (what the
CLI's ``--coordinator/--num-processes/--process-id`` give), or from
torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``).
"""

from __future__ import annotations

import collections
import os

import torch
import torch.distributed as dist

DATA_AXIS = "data"


def _tcp(coordinator: str) -> str:
    """``host:port`` or ``tcp://host:port`` → ``tcp://host:port``; raises
    on anything else."""
    addr = coordinator[len("tcp://"):] if coordinator.startswith(
        "tcp://") else coordinator
    host, sep, port = addr.rpartition(":")
    if not (sep and host and port.isdigit() and 0 < int(port) < 65536):
        raise ValueError(f"coordinator {coordinator!r} is not host:port")
    return f"tcp://{host}:{port}"


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device=None) -> bool:
    """Join the process group; returns whether one is running.

    * Explicit arguments (all three): a misconfiguration raises — a run
      that quietly fell back to one process would train on 1/N of the data.
    * None: torchrun's environment where ``RANK`` and ``WORLD_SIZE`` are
      set, else a single process (no group; the counterpart of the JAX
      package's soft auto-detect).

    ``device``: the card unless the CPU is asked for (``gloo``); on the card
    each process takes card ``LOCAL_RANK`` (torchrun) or ``process_id``
    modulo the cards present, and the group runs ``nccl``."""
    from ..device import resolve_device

    if dist.is_initialized():
        return True
    explicit = (coordinator, num_processes, process_id)
    if any(a is not None for a in explicit):
        if any(a is None for a in explicit):
            raise ValueError("--coordinator, --num-processes and "
                             "--process-id go together")
        if not (num_processes >= 1 and 0 <= process_id < num_processes):
            raise ValueError(f"process id {process_id} outside "
                             f"[0, {num_processes})")
        init, rank, world = _tcp(coordinator), process_id, num_processes
        local = process_id
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        init = "env://"
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
    else:
        return False
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(local % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world)
    return True


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def rank_world() -> tuple[int, int]:
    """(this process's rank, the group's size); (0, 1) without a group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_main() -> bool:
    return rank_world()[0] == 0


def local_device(device=None) -> torch.device:
    """The device this process computes on: the card
    ``torch.cuda.current_device()`` (set by ``init_distributed``) unless the
    CPU is asked for."""
    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(device_type: str = "cuda"):
    """A 1-D ``DeviceMesh`` over every process of the group, its one axis
    named ``data``; None without a group (a single process is its own
    mesh)."""
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=(DATA_AXIS,))


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def rank_rows(x, rank: int | None = None, world: int | None = None):
    """This rank's rows of a global batch (leading axis split evenly)."""
    if rank is None:
        rank, world = rank_world()
    if world == 1:
        return x
    n = x.shape[0]
    if n % world:
        raise ValueError(f"global batch of {n} does not split over {world} "
                         "processes")
    b = n // world
    return x[rank * b:(rank + 1) * b]


def shard_batch(batch, device=None):
    """A (nested dict / list of) host arrays or tensors holding the GLOBAL
    batch, which every rank builds identically → this rank's rows as
    tensors on ``device`` (the JAX package's ``device_put`` to a
    batch-sharded global array)."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, device) for v in batch)
    t = rank_rows(torch.as_tensor(batch))
    return t if device is None else t.to(device, non_blocking=True)


def global_proxy(x_local: torch.Tensor) -> torch.Tensor:
    """A CPU tensor of the GLOBAL batch's shape and ``x_local``'s dtype that
    holds no memory (stride 0): what a ``draw_loss_inputs`` reads (shape,
    dtype, device) to draw for the global batch."""
    _, world = rank_world()
    shape = (x_local.shape[0] * world, *x_local.shape[1:])
    return torch.zeros((), dtype=x_local.dtype).expand(shape)


def local_draws(draws, device) -> tuple:
    """Global draws (each batch-first) → this rank's rows on ``device``."""
    return tuple(rank_rows(d).to(device) for d in draws)


@torch.no_grad()
def all_reduce_grads(grads) -> None:
    """Average ``grads`` (tensors, in place) over the group, in one
    collective over a flat buffer. Without a group: nothing."""
    grads = [g for g in grads if g is not None]
    if not dist.is_initialized() or not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat.div_(dist.get_world_size())
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def mean_over_ranks(metrics: dict) -> dict:
    """{name: scalar tensor} → {name: float}, each averaged over the group
    (one collective; every rank must call it at the same step)."""
    names = sorted(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k]).detach().float()
                        .reshape(()) for k in names])
    if dist.is_initialized():
        if dist.get_backend() == "nccl":
            vals = vals.to(local_device())
        dist.all_reduce(vals)
        vals = vals / dist.get_world_size()
    return dict(zip(names, vals.cpu().tolist()))


def agree(flag: bool) -> bool:
    """True on every rank where it is True on any: the preemption latch,
    agreed once per step so that no rank stops while another enters a
    collective."""
    if not dist.is_initialized():
        return bool(flag)
    t = torch.tensor([int(bool(flag))])
    if dist.get_backend() == "nccl":
        t = t.to(local_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


class GlobalBatchNorm(torch.nn.Module):
    """A train-mode BatchNorm that normalises with the statistics of the
    GLOBAL batch, as the JAX package's BatchNorm under the data mesh does:
    the mean, then the biased variance, each a differentiable all-reduce of
    per-rank sums, so the backward carries the cross-rank terms. It shares
    ``bn``'s weight and bias (its ``state_dict`` keys are ``bn``'s). Works
    with ``gloo`` and ``nccl`` (``torch.nn.SyncBatchNorm`` refuses CPU
    tensors)."""

    def __init__(self, bn: torch.nn.modules.batchnorm._BatchNorm):
        super().__init__()
        self.weight, self.bias, self.eps = bn.weight, bn.bias, bn.eps

    def forward(self, x):
        from torch.distributed.nn.functional import all_reduce

        dims = [0, *range(2, x.ndim)]
        shape = [1, -1, *([1] * (x.ndim - 2))]
        n = x.numel() // x.shape[1] * dist.get_world_size()
        mean = all_reduce(x.sum(dims)) / n
        xc = x - mean.reshape(shape)
        var = all_reduce(xc.square().sum(dims)) / n
        y = xc * torch.rsqrt(var + self.eps).reshape(shape)
        return y * self.weight.reshape(shape) + self.bias.reshape(shape)


def globalise_batch_norms(module: torch.nn.Module) -> torch.nn.Module:
    """Every BatchNorm child of ``module`` replaced, in place, by a
    ``GlobalBatchNorm`` over the same parameters, where a group of more
    than one process runs; ``module`` as it is otherwise."""
    if rank_world()[1] == 1:
        return module
    for name, child in list(module.named_children()):
        if isinstance(child, torch.nn.modules.batchnorm._BatchNorm):
            setattr(module, name, GlobalBatchNorm(child))
        else:
            globalise_batch_norms(child)
    return module


def _to(batch, device, non_blocking):
    if isinstance(batch, dict):
        return {k: _to(v, device, non_blocking) for k, v in batch.items()}
    return torch.as_tensor(batch).to(device, non_blocking=non_blocking)


def device_prefetch(batch_iterator, device, depth: int = 2):
    """Host batches (dicts of tensors; pinned for an asynchronous copy) →
    device batches, the next ones' host-to-device copies issued on a side
    stream while the current step computes. On the CPU: a plain copy."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in batch_iterator:
            yield _to(batch, device, False)
        return
    side = torch.cuda.Stream(device)
    queue = collections.deque()

    def ready():
        dev, event = queue.popleft()
        main = torch.cuda.current_stream(device)
        main.wait_event(event)
        for t in (dev.values() if isinstance(dev, dict) else [dev]):
            t.record_stream(main)
        return dev

    for batch in batch_iterator:
        with torch.cuda.stream(side):
            dev = _to(batch, device, True)
            event = torch.cuda.Event()
            event.record(side)
        queue.append((dev, event))
        if len(queue) >= depth:
            yield ready()
    while queue:
        yield ready()
