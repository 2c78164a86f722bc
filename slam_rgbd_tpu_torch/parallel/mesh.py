"""The (data, model) mesh over `torch.distributed`: the transport layer.

Counterpart of `slam_rgbd_tpu/parallel/mesh.py`. Where the JAX package runs
one process over many devices and lets `shard_map` insert the collectives,
here every rank is a process: `initialize_distributed` joins it to a process
group, `make_mesh` lays the ranks out as a `DeviceMesh` with the two named
axes, and the programs of `parallel/dist.py` call the collectives of the
axis they reduce over.

Mesh axes:
  * `data`  - concurrent sequences (the multi-sequence batch mode); frame
    batches shard over it.
  * `model` - parallelism inside one problem: observation columns in BA
    assembly, descriptor rows in matching, map blocks, pose-graph edges.

What `data_sharding` / `model_sharding` / `replicated` declare in JAX is
explicit here: `shard` cuts the rank's block out of a full array, `gather`
puts the blocks back together on every rank, and a replicated array is one
every rank holds whole.

The backend is explicit: NCCL is the default on the card, gloo when the
caller asks for the CPU, and `backend="gloo"` is allowed on the card (NCCL
refuses two ranks on one device). Nothing falls back: a failed
`init_process_group` raises, and so does a collective the backend refuses.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from dataclasses import dataclass

import torch
import torch.distributed as dist

from slam_rgbd_tpu_torch.core.config import MeshConfig

# how long a collective or the rendezvous waits for the other ranks
TIMEOUT = datetime.timedelta(minutes=10)
# how long a collective of the threaded sharded session's backend worker
# waits: a pass that fails on one rank then fails on the others within this,
# instead of holding their workers in an all-reduce
WORKER_TIMEOUT = datetime.timedelta(seconds=60)


def mesh_shape(world_size: int, cfg: MeshConfig = MeshConfig()) -> tuple[int, int]:
    """(data, model) axis sizes for `world_size` ranks.

    Axis sizes of 0 are inferred: `model` defaults to 1 and `data` takes
    every remaining rank, so one rank gives a 1x1 mesh and the same program
    runs unchanged. A factorization that does not cover the ranks raises.
    """
    data, model = cfg.data, cfg.model
    if model == 0 and data == 0:
        model, data = 1, world_size
    elif model == 0:
        model = world_size // data
    elif data == 0:
        data = world_size // model
    if data * model != world_size:
        raise ValueError(f"mesh {data}x{model} != {world_size} devices")
    return data, model


def make_mesh(cfg: MeshConfig = MeshConfig(), device_type: str = "cuda"):
    """A `DeviceMesh` of shape `mesh_shape(world size, cfg)` over the ranks of
    the initialized process group, with the axis names of `cfg`. Every rank
    must call it, in the same order as any other mesh it makes (each mesh
    creates the process groups of its axes)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call initialize_distributed first")
    shape = mesh_shape(dist.get_world_size(), cfg)
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=(cfg.data_axis, cfg.model_axis))


def initialize_distributed(init_method: str | None = None,
                           world_size: int | None = None,
                           rank: int | None = None,
                           backend: str | None = None,
                           device: str = "cuda") -> None:
    """Join this process to the process group (`torch.distributed`), the
    counterpart of the JAX package's `jax.distributed` bring-up.

    `init_method` names the rendezvous (`file:///path` for a store in a
    file, `tcp://host:port`), with this process's `rank` of `world_size`.
    Without an `init_method`, a single process (`world_size` None or 1)
    does nothing. On a CUDA device the rank first selects card `rank %
    device_count` (two ranks on one card share card 0). `backend` None is
    NCCL on a CUDA device and gloo on the CPU. Returns at once if the group
    already exists with this rank and size; a group of another layout, a
    CUDA device without a card and a failed rendezvous raise.
    """
    if init_method is None and (world_size is None or world_size <= 1):
        return
    if world_size is None or rank is None:
        raise ValueError("initialize_distributed needs world_size and rank")
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (world_size, rank):
            raise RuntimeError(
                f"a process group of rank {dist.get_rank()} of "
                f"{dist.get_world_size()} exists already, not {rank} of {world_size}")
        return
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} was asked for but torch sees no CUDA device")
        torch.cuda.set_device(rank % torch.cuda.device_count())
    elif backend != "gloo":
        raise ValueError(f"backend {backend!r} cannot run on the CPU; use gloo")
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=TIMEOUT)


def block(n: int, mesh, axis: str) -> slice:
    """This rank's block of a length-`n` axis sharded over mesh axis `axis`:
    n / size consecutive entries, the rank's index along the axis times that
    size from the start. A length that does not divide raises."""
    size = mesh.size(mesh.mesh_dim_names.index(axis))
    if n % size:
        raise ValueError(f"length {n} not divisible by mesh axis {axis!r} of {size}")
    step = n // size
    r = mesh.get_local_rank(axis)
    return slice(r * step, (r + 1) * step)


def shard(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's block of `x` along `dim`, sharded over mesh axis `axis`.

    A view into `x`, copied where its start is not 16-byte aligned (the
    Hamming kernels read rows in 16-byte pieces)."""
    s = block(x.shape[dim], mesh, axis)
    out = x.narrow(dim, s.start, s.stop - s.start)
    return out.clone() if out.data_ptr() % 16 else out


def gather(x: torch.Tensor, mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """Every rank's block of a sharded array put back together along `dim`,
    on every rank (the blocks in the order of the axis). A collective: each
    rank of the axis group calls it with a block of the same shape."""
    return gather_group(x, mesh.get_group(axis), dim)


def gather_group(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """`gather` over the ranks of `group`, in their order in the group."""
    n = dist.get_world_size(group)
    src = x.contiguous()
    as_bool = src.dtype == torch.bool
    if as_bool:
        src = src.to(torch.uint8)
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim=dim)
    return out.to(torch.bool) if as_bool else out


def axis_group(mesh, axis: str, backend: str | None = None,
               timeout: datetime.timedelta = TIMEOUT):
    """A new process group over this rank's row of mesh axis `axis` (the
    ranks that share its other coordinates), besides the mesh's own, so
    that two threads of a rank can run collectives over the same ranks
    without interleaving. `backend` None is the default group's. A
    collective over the whole world: every rank creates the group of every
    row, in the same order, and keeps its own."""
    dim = mesh.mesh_dim_names.index(axis)
    rows = mesh.mesh.movedim(dim, -1).reshape(-1, mesh.size(dim)).tolist()
    me = dist.get_rank()
    mine = None
    for ranks in rows:
        group = dist.new_group(ranks, timeout=timeout, backend=backend)
        if me in ranks:
            mine = group
    return mine


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """`x` summed over the ranks of `group` (in place, returned); `x` as it
    is when `group` is None. Every rank gets the same bits."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


@dataclass(frozen=True)
class Block:
    """This rank's block of a table of `total` rows sharded over one mesh
    axis: rows `start .. start + size - 1`, with the mesh, the axis's
    process group and this rank's `index` on the axis."""

    mesh: object
    axis: str
    start: int
    size: int
    total: int
    group: object
    index: int


def model_block(mesh, total: int, axis: str = "model") -> Block:
    """This rank's `Block` of a length-`total` table sharded over `axis`."""
    s = block(total, mesh, axis)
    return Block(mesh=mesh, axis=axis, start=s.start, size=s.stop - s.start,
                 total=total, group=mesh.get_group(axis),
                 index=mesh.get_local_rank(axis))


def exclusive_prefix(count: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor]:
    """(the sum of `count` over the ranks of `group` before this one, the sum
    over all of them) for a () integer count: one all-gather. Without a
    group, (0, count)."""
    if group is None:
        return torch.zeros_like(count), count
    one = count.reshape(1)
    parts = [torch.empty_like(one) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, one.contiguous(), group=group)
    counts = torch.cat(parts)
    rank = dist.get_rank(group)
    return counts[:rank].sum().to(count.dtype), counts.sum().to(count.dtype)


def _sum_exact(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over `group` of tensors of which at most one rank holds a
    non-zero entry at each place: integers as they are, booleans and int8
    widened to int32, float32 summed as its bits (int32), so a value comes
    through unchanged (a float sum would turn -0.0 into 0.0)."""
    if x.dtype == torch.float32:
        return all_sum(x.contiguous().view(torch.int32), group).view(torch.float32)
    if x.dtype in (torch.bool, torch.int8, torch.uint8):
        return all_sum(x.to(torch.int32), group).to(x.dtype)
    return all_sum(x.contiguous(), group)


def gather_rows(rows: torch.Tensor, ids: torch.Tensor, blk: Block | None) -> torch.Tensor:
    """`table[ids]` of a table of which this rank holds the block `rows`
    (`blk`; None: `rows` is the whole table), with zeros where an id lies
    outside the table (-1, or the pad index `total`). Each rank looks up
    the ids in its block and contributes zeros for the others; one
    all-reduce joins them, exactly (`_sum_exact`). Every rank of the group
    calls it with the same `ids` and gets the same result."""
    n = rows.shape[0]
    local = ids.long() - (0 if blk is None else blk.start)
    mine = (local >= 0) & (local < n)
    pad = torch.cat([rows, torch.zeros((1,) + rows.shape[1:], dtype=rows.dtype,
                                       device=rows.device)])
    out = pad[torch.where(mine, local, n)]
    return out if blk is None else _sum_exact(out, blk.group)


def scatter_rows(rows: torch.Tensor, ids: torch.Tensor, values: torch.Tensor,
                 blk: Block | None) -> torch.Tensor:
    """A copy of this rank's block `rows` with `values[i]` written at the
    global id `ids[i]` wherever that id lies in the block; no traffic.
    Ids outside the block, and repeated pad ids, go to a dump row."""
    n = rows.shape[0]
    local = ids.long() - (0 if blk is None else blk.start)
    mine = (local >= 0) & (local < n)
    pad = torch.cat([rows, torch.zeros((1,) + rows.shape[1:], dtype=rows.dtype,
                                       device=rows.device)])
    return pad.index_copy(0, torch.where(mine, local, n), values.to(rows.dtype))[:n]


def _rank_main(rank, fn, world_size, tmp, backend, device, threads, args):
    if threads:
        torch.set_num_threads(threads)
    initialize_distributed(f"file://{os.path.join(tmp, 'store')}", world_size, rank,
                           backend, device)
    try:
        result = fn(rank, world_size, *args)
    finally:
        dist.destroy_process_group()
    path = os.path.join(tmp, f"rank{rank}.pkl")
    with open(path + ".part", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".part", path)


def spawn(fn, world_size: int, args: tuple = (), backend: str | None = None,
          device: str = "cuda", threads: int | None = None) -> list:
    """Run `fn(rank, world_size, *args)` in `world_size` fresh processes
    joined in one process group, and return each rank's return value, in
    rank order.

    The processes start with the `spawn` method (nothing inherited but the
    arguments, pickled; `fn` must be importable), meet at a store in a file
    of a temporary directory (no port to collide on), and each calls
    `initialize_distributed` with `backend` and `device` and leaves the
    group when `fn` returns. `threads` sets the intra-op threads of each
    (and `OMP_NUM_THREADS` in their environment). A rank that raises stops
    the others and the error is raised here.
    """
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="slam_ranks_") as tmp:
        saved = os.environ.get("OMP_NUM_THREADS")
        if threads:
            os.environ["OMP_NUM_THREADS"] = str(threads)
        try:
            mp.start_processes(
                _rank_main, nprocs=world_size, join=True, start_method="spawn",
                args=(fn, world_size, tmp, backend, device, threads, args))
        finally:
            if saved is None:
                os.environ.pop("OMP_NUM_THREADS", None)
            else:
                os.environ["OMP_NUM_THREADS"] = saved
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
