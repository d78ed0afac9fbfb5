"""Process groups and device meshes, port of ttts_tpu/parallel/mesh.py on
torch.distributed.

The JAX package runs one program over a global mesh: data parallelism is
batch sharding under jit, and XLA inserts the gradient psum. The port runs
one process per GPU (torchrun's convention): NCCL on the card, gloo on the
CPU. A mesh is a `torch.distributed.device_mesh.DeviceMesh` over every
process with the JAX package's axis rules: `data` (-1: every process not
claimed by the other axes), `model` (the innermost axis) and, with
`dcn > 1`, a slowest-varying `dcn` axis; a mesh may also name an `sp`
(sequence-parallel) axis, as the JAX tests build `Mesh(devices, ("sp",))`.
There are no global arrays: a rank holds its slice of the batch
(`shard_batch`), collectives outside the kernels put the pieces together
(`gather_batch`, `all_reduce`), and the parameters are copies that
`replicate` makes equal.

`WORLD_SIZE` and `RANK` count processes, one per GPU, where the JAX package
counts hosts (mesh.py:44-47); `LOCAL_RANK` picks `cuda:LOCAL_RANK`.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ttts_tpu_torch.config import MeshConfig

DEFAULT_TIMEOUT = datetime.timedelta(seconds=600)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device="cuda",
                           timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> Tuple[int, int]:
    """Join the process group: `dist.init_process_group` with NCCL for a
    CUDA `device` and gloo on the CPU. Each field comes from its argument,
    else from torchrun's environment (MASTER_ADDR[:MASTER_PORT], WORLD_SIZE
    → the number of processes, RANK → this process). On the card the
    process takes `cuda:LOCAL_RANK` as its current device. Idempotent. →
    (rank, world)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '1234')}")
    init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    world = num_processes if num_processes is not None else int(
        os.environ.get("WORLD_SIZE", "1"))
    rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world,
                            rank=rank, timeout=timeout)
    return dist.get_rank(), dist.get_world_size()


def multihost_requested() -> bool:
    """True when the environment asks for more than one process
    (TTTS_MULTIHOST=1 or WORLD_SIZE > 1): the training CLIs join the
    process group only then."""
    return (os.environ.get("TTTS_MULTIHOST", "0") == "1"
            or int(os.environ.get("WORLD_SIZE", "1")) > 1)


def is_primary() -> bool:
    """Process 0, or a run without a process group: the one process that
    writes TensorBoard events, checkpoints and runs the eval hooks."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_device(device="cuda") -> torch.device:
    """This process's device: `cuda` without an index becomes
    `cuda:LOCAL_RANK`; anything else is returned as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return device


def mesh_shape(cfg: Optional[MeshConfig], n: int) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The (shape, axis names) make_mesh builds over `n` processes: the JAX
    package's rule (mesh.py:89-113) and its ValueErrors."""
    cfg = cfg or MeshConfig()
    model = max(1, cfg.model)
    dcn = max(1, cfg.dcn)
    if n % (model * dcn) != 0:
        raise ValueError(f"{n} devices not divisible by dcn×model={dcn}×{model}")
    data = cfg.data if cfg.data != -1 else n // (model * dcn)
    if dcn * data * model != n:
        raise ValueError(f"mesh {dcn}x{data}x{model} != {n} devices")
    if dcn > 1:
        return (dcn, data, model), ("dcn",) + tuple(cfg.axis_names)
    return (data, model), tuple(cfg.axis_names)


def make_mesh(cfg: Optional[MeshConfig] = None):
    """A DeviceMesh over every process of the group (row-major, the dcn
    axis slowest), shaped by mesh_shape; on the card when the group is
    NCCL's, else on the CPU. Every process calls it, in the same order."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = mesh_shape(cfg, dist.get_world_size())
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def axis_size(mesh, name: str) -> int:
    """The size of axis `name` of `mesh` (1 when the mesh lacks it)."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(name)) if name in names else 1


def axis_group(mesh, name: str):
    """The process group of this rank along axis `name`, or None when the
    axis is missing or holds one rank."""
    return mesh.get_group(name) if axis_size(mesh, name) > 1 else None


def data_axis_size(mesh) -> int:
    """Total batch-sharding ways: dcn × data on a two-level mesh."""
    return axis_size(mesh, "data") * axis_size(mesh, "dcn")


def data_rank(mesh) -> int:
    """This rank's index along the batch axes (dcn-major, then data)."""
    names = mesh.mesh_dim_names or ()
    idx = mesh.get_local_rank("data") if "data" in names else 0
    if "dcn" in names:
        idx += mesh.get_local_rank("dcn") * axis_size(mesh, "data")
    return idx


def batch_groups(mesh) -> List:
    """The process groups of the batch axes the mesh has (data, then dcn),
    whatever their size: a gather or a sum over them in this order runs
    over dcn × data, crossing dcn once (the JAX package's gradient psum).
    No mesh: none."""
    if mesh is None:
        return []
    names = mesh.mesh_dim_names or ()
    return [mesh.get_group(a) for a in ("data", "dcn") if a in names]


def shard_batch(mesh, x: torch.Tensor, batch_axis: int = 0) -> torch.Tensor:
    """The rows of a global (B, ...) batch that this rank holds on the
    dcn × data axes: B / data_axis_size(mesh) contiguous rows. B must
    divide (api and the Trainer check first, as the JAX package does)."""
    n = data_axis_size(mesh)
    b = x.shape[batch_axis]
    if b % n:
        raise ValueError(f"batch of {b} rows does not divide over {n} data ranks")
    return x.narrow(batch_axis, data_rank(mesh) * (b // n), b // n)


def all_gather(x: torch.Tensor, group, dim: int = 0, autograd: bool = False) -> torch.Tensor:
    """Every rank's x of `group`, concatenated along `dim` in rank order, on
    every rank. With `autograd`, through the functional collective whose
    backward returns each rank the gradient of its own part, summed over
    the ranks."""
    if autograd:
        import torch.distributed._functional_collectives as fc

        gather = getattr(fc, "all_gather_single_autograd", None) or fc.all_gather_tensor_autograd
        y = gather(x.movedim(dim, 0).contiguous(), 0, group)
        return fc.wait_tensor(y).movedim(0, dim)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_batch(mesh, x: torch.Tensor, batch_axis: int = 0,
                 autograd: bool = False) -> torch.Tensor:
    """The inverse of shard_batch: every rank's rows, in rank order, on
    every rank. With `autograd`, through the functional collective whose
    backward returns each rank the gradient of its own rows, summed over
    the ranks."""
    for g in batch_groups(mesh):
        x = all_gather(x, g, batch_axis, autograd)
    return x


def all_reduce(tensors: Sequence[Optional[torch.Tensor]], groups: Sequence,
               mean: bool = True) -> List[Optional[torch.Tensor]]:
    """The sum (or the mean) over the ranks of `groups`, one after the
    other, of each tensor, in one coalesced f32 all-reduce per group: the
    tensors are flattened into one buffer and cut back to their shapes and
    dtypes. None stays None. With no group, the tensors come back as they
    are."""
    if not groups:
        return list(tensors)
    live = [t for t in tensors if t is not None]
    flat = torch.cat([t.detach().reshape(-1).float() for t in live])
    n = 1
    for g in groups:
        dist.all_reduce(flat, group=g)
        n *= dist.get_world_size(g)
    if mean:
        flat = flat / n
    out, i = [], 0
    for t in tensors:
        if t is None:
            out.append(None)
            continue
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


def replicate(module: torch.nn.Module, mesh) -> torch.nn.Module:
    """Make every rank's parameters and buffers equal to those of the
    mesh's first rank: a broadcast along each axis in turn, from the
    axis's rank 0 (the JAX package's replicated placement)."""
    names = mesh.mesh_dim_names or ()
    tensors = list(module.parameters()) + list(module.buffers())
    for name in reversed(names):
        if axis_size(mesh, name) == 1:
            continue
        group = mesh.get_group(name)
        src = dist.get_global_rank(group, 0)
        with torch.no_grad():
            for t in tensors:
                buf = t.data.contiguous()
                dist.broadcast(buf, src=src, group=group)
                if buf.data_ptr() != t.data_ptr():
                    t.data.copy_(buf)
    return module


def with_sharding(tensors: Dict[str, torch.Tensor], mesh, placements) -> Dict:
    """Every tensor of `tensors` as a DTensor on `mesh` with one list of
    `placements` (torch.distributed.tensor's Shard / Replicate)."""
    from torch.distributed.tensor import distribute_tensor

    return {k: distribute_tensor(v, mesh, placements) for k, v in tensors.items()}
