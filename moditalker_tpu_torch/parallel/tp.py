"""Tensor-parallel primitives over a 2-D (data, model) process mesh (port
of ``moditalker_tpu/parallel/tp.py``).

The reference has no tensor parallelism; these are the optional
model-sharding path for a UNet or TimeSformer beyond one card's memory:

* ``column_parallel_dense``: W sharded on its output features, no
  collective (the output stays sharded on its feature axis);
* ``row_parallel_dense``: W sharded on its input features and x on its
  feature axis; the partial products are summed over the model group;
* ``head_parallel_attention``: the heads sharded over the model group,
  each rank's heads through the port's ``sdpa`` (on the card: the
  hand-written kernel its route picks; never
  ``F.scaled_dot_product_attention``).

The JAX package writes them with ``shard_map`` over a ``Mesh``; here each
process is one cell of the mesh and holds its shard as a local tensor, and
``torch.distributed`` process groups take the place of the mesh axes. Each
function takes and returns THIS rank's shards; ``shard`` cuts a rank's
shard out of a full tensor, and ``gather`` puts a sharded axis back
together (for tests and for the boundary of a model-parallel region).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.sharding import DATA_AXIS
from ..ops.attention import sdpa

MODEL_AXIS = "model"


def make_2d_mesh(data: int, model: int, device_type: str = "cuda"):
    """A ``DeviceMesh`` of shape (data, model) over the group's processes,
    axes named ``data`` and ``model``; the group must hold data·model
    processes."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if world != data * model:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"processes, the group has {world}")
    return init_device_mesh(device_type, (data, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def shard(x: torch.Tensor, mesh, axis_name: str, dim: int) -> torch.Tensor:
    """This rank's shard of the full tensor ``x`` along ``dim``, split
    evenly over the mesh axis ``axis_name``."""
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    i = mesh.get_local_rank(axis_name)
    return x.chunk(n, dim)[i].contiguous()


def gather(x: torch.Tensor, mesh, axis_name: str, dim: int) -> torch.Tensor:
    """The shards of every rank of ``axis_name`` concatenated along
    ``dim`` (an all-gather)."""
    group = mesh.get_group(axis_name)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def column_parallel_dense(mesh):
    """y = x @ W + b with W [I, O] sharded on O (and b on O): takes x's
    data shard [b, I], W's [I, O/m], b's [O/m]; returns y's [b, O/m]."""

    def fn(x, w, b):
        return x @ w + b

    return fn


def row_parallel_dense(mesh):
    """y = x @ W + b with W [I, O] sharded on I and x on its features:
    takes x's [b, I/m], W's [I/m, O], the whole b [O]; the partial
    products are summed over the model group; returns y's [b, O]."""
    group = mesh.get_group(MODEL_AXIS)

    def fn(x, w, b):
        partial = x @ w
        dist.all_reduce(partial, group=group)
        return partial + b

    return fn


def head_parallel_attention(mesh, num_heads: int):
    """Multi-head attention with the heads sharded over the model group:
    q/k/v are this rank's [b, N, H/m, D] (already projected, the head axis
    explicit); returns the same shard of the output. Embarrassingly
    parallel: no collective."""
    m = mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS))
    if num_heads % m:
        raise ValueError(f"{num_heads} heads do not split over {m} ranks")

    def fn(q, k, v):
        d = q.shape[-1]
        out = sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   scale=d**-0.5)
        return out.transpose(1, 2)

    return fn
