"""Process meshes (port of qbn_tpu/parallel/mesh.py): one process per
device in a torch.distributed group plays the part of a device in a JAX
mesh.

`launch(fn, mesh_shape, *args)` starts prod(mesh_shape) processes (spawn),
each of which joins the group, takes its device (cuda:(rank % cards), or
the CPU with device='cpu') and calls fn(mesh, *args); it returns rank 0's
result and raises when a rank raises, when the group's collective timeout
passes, or at the join's deadline. Backends: NCCL when every rank has a
card of its own, gloo over CUDA tensors when ranks share a card (NCCL
refuses two ranks on one device), gloo over CPU tensors for device='cpu'.

Rank r of a (data, sample) mesh sits at (r // n_sample, r % n_sample), as
jax's Mesh lays out the devices of np.reshape(devices, shape); each axis
has its group (the ranks that differ only along it, in axis order). A
1-D mesh's one axis is the whole group.

The collectives of a sharded step are in ops/collectives.py.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import math
import os
import shutil
import socket
import tempfile
import time
import traceback
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


@dataclasses.dataclass
class Mesh:
    """This rank's view of the mesh: its shape and axis names, its rank
    and device, and one process group per axis."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    rank: int
    world: int
    device: torch.device
    groups: Dict[str, object]
    backend: str

    @property
    def size(self) -> int:
        """Devices in the mesh (qbn_tpu's mesh.devices.size)."""
        return self.world

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def _coords(self) -> Tuple[int, ...]:
        out, r = [], self.rank
        for n in reversed(self.shape):
            out.append(r % n)
            r //= n
        return tuple(reversed(out))

    def axis_size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def axis_index(self, axis: str) -> int:
        """This rank's position along `axis` (jax.lax.axis_index)."""
        return self._coords()[self.axis_names.index(axis)]

    def group(self, axis: str):
        return self.groups[axis]

    def barrier(self) -> None:
        dist.barrier()


def _prod(shape) -> int:
    return int(math.prod(shape))


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              device=None) -> Mesh:
    """The mesh of this process's group (every rank calls it, in the same
    order: it makes the per-axis groups): a 1-D ('data',) mesh over the
    whole group by default, or of `shape`, 2-D as ('data', 'sample').
    device: this rank's device (default cuda:(rank % cards), or the CPU
    without a card)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh runs inside a process group "
                           "(parallel.launch starts one)")
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = (world,) if shape is None else tuple(int(s) for s in shape)
    if _prod(shape) != world:
        raise ValueError(f"mesh_shape {shape} needs {_prod(shape)} devices, "
                         f"have {world}")
    if len(shape) > 2:
        raise ValueError(f"mesh_shape {shape}: 1 or 2 axes")
    axis_names = ("data",) if len(shape) == 1 else ("data", "sample")
    if device is None:
        device = (torch.device("cuda", rank % torch.cuda.device_count())
                  if torch.cuda.is_available() else torch.device("cpu"))
    groups = {}
    if len(shape) == 1:
        groups[axis_names[0]] = dist.group.WORLD
    else:
        ranks = torch.arange(world).reshape(shape)
        for a, name in enumerate(axis_names):
            # every line of ranks along axis a, each a group; this rank's
            # is the one it sits on
            lines = ranks.movedim(a, -1).reshape(-1, shape[a]).tolist()
            for line in lines:
                g = dist.new_group(line)
                if rank in line:
                    groups[name] = g
    return Mesh(shape, axis_names, rank, world, torch.device(device), groups,
                dist.get_backend())


_MESHES: dict = {}


def mesh_from_config(cfg) -> Optional[Mesh]:
    """The run's mesh: None for cfg.mesh_shape None (one device);
    otherwise a mesh of that shape over this process's group, 1-D
    ('data',) (training shards the batch, MC evaluation the sample axis
    over the same ranks) or 2-D ('data', 'sample'), made once per group
    and shape (its groups are collectives; a launched rank's own mesh is
    found here). Raises ValueError when the shape's product differs from
    the group's world size (1 outside a group)."""
    if cfg.mesh_shape is None:
        return None
    shape = tuple(int(s) for s in cfg.mesh_shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if _prod(shape) != world:
        raise ValueError(f"mesh_shape {shape} needs {_prod(shape)} devices, "
                         f"have {world}")
    if not dist.is_initialized():
        raise RuntimeError("a mesh runs inside a process group "
                           "(parallel.launch starts one)")
    group = id(dist.group.WORLD)
    if (shape, group) not in _MESHES:
        # on the device of the launch's mesh of this group, if any
        known = [m.device for (_s, g), m in _MESHES.items() if g == group]
        _MESHES[(shape, group)] = make_mesh(
            shape=shape, device=known[0] if known else None)
    return _MESHES[(shape, group)]


def shard_rows(n: int, mesh: Mesh, axis: str = "data") -> slice:
    """The rows of an n-row global batch that this rank holds along
    `axis` (n divisible by the axis size)."""
    size = mesh.axis_size(axis)
    if n % size:
        raise ValueError(f"{n} rows do not divide over {size} ranks")
    per = n // size
    i = mesh.axis_index(axis)
    return slice(i * per, (i + 1) * per)


def shard_batch(batch, mesh: Mesh, axis: str = "data"):
    """This rank's rows of a global batch (a tensor or a tuple of them,
    rows on axis 0) along the mesh axis `axis`."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, mesh, axis) for b in batch)
    return batch[shard_rows(len(batch), mesh, axis)]


# -- the launcher -----------------------------------------------------------

def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def pick_backend(n: int, device_type: str) -> str:
    """NCCL when each of n ranks has a card of its own, gloo otherwise."""
    if device_type == "cuda" and n <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def device_map(n: int, device_type: str):
    """The device of each of n ranks."""
    if device_type != "cuda":
        return ["cpu"] * n
    cards = torch.cuda.device_count()
    return [f"cuda:{r % cards}" for r in range(n)]


def _rank_main(rank, fn, shape, args, device_type, backend, init_method,
               timeout, out_dir):
    n = _prod(shape)
    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    dist.init_process_group(
        backend, init_method=init_method, world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=timeout),
        device_id=device if backend == "nccl" else None)
    try:
        mesh = make_mesh(shape=shape, device=device)
        _MESHES[(shape, id(dist.group.WORLD))] = mesh
        out = fn(mesh, *args)
        if rank == 0:
            torch.save(out, os.path.join(out_dir, "result.pt"))
        dist.barrier()
    except BaseException:
        # recorded before the group goes down, so that the first failure
        # is the first record (its peers then fail in their collectives)
        with open(os.path.join(out_dir, f"error_rank{rank}.txt"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def _rank_errors(out_dir: str) -> str:
    """The ranks' recorded failures, the first recorded first."""
    paths = sorted((os.path.join(out_dir, f) for f in os.listdir(out_dir)
                    if f.startswith("error_rank")), key=os.path.getmtime)
    out = []
    for p in paths:
        with open(p) as fh:
            out.append(f"-- {os.path.basename(p)[6:-4]}:\n{fh.read()}")
    return "\n".join(out)


def launch(fn, mesh_shape, *args, device="cuda",
           init_method: Optional[str] = None, timeout: float = 1800.0, deadline: Optional[float] = None):
    """Run fn(mesh, *args) in prod(mesh_shape) new processes, one per
    device, and return rank 0's result (fn and args must pickle; the
    result comes back through torch.save).

    init_method: the group's rendezvous (default tcp://127.0.0.1:<a free
    port>; a file:// store avoids port races). timeout: seconds a
    collective waits for its peers before the rank raises. deadline:
    seconds the whole launch may take (None: no limit). A rank that
    raises makes the launch raise (the other ranks are ended); so does
    the deadline."""
    shape = tuple(int(s) for s in ((mesh_shape,) if isinstance(
        mesh_shape, int) else mesh_shape))
    n = _prod(shape)
    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the ranks on the CPU")
    backend = pick_backend(n, device_type)
    init_method = init_method or f"tcp://127.0.0.1:{_free_port()}"
    log.info("launching %d ranks of mesh %s, backend %s, devices %s", n,
             shape, backend, device_map(n, device_type))
    out_dir = tempfile.mkdtemp(prefix="qbn_launch_")
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, shape, args, device_type, backend,
                          init_method, timeout, out_dir),
        nprocs=n, join=False, start_method="spawn")
    end = None if deadline is None else time.monotonic() + deadline
    try:
        try:
            while not ctx.join(timeout=0.5):
                if end is not None and time.monotonic() > end:
                    raise TimeoutError(f"the launch of {n} ranks passed its "
                                       f"deadline of {deadline} s")
        except torch.multiprocessing.ProcessRaisedException as e:
            errors = _rank_errors(out_dir)
            if not errors:
                raise
            raise RuntimeError(f"a rank of the launch failed; the ranks' "
                               f"failures, the first first:\n{errors}"
                               ) from e
        return torch.load(os.path.join(out_dir, "result.pt"),
                          map_location="cpu", weights_only=False)
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
        shutil.rmtree(out_dir, ignore_errors=True)
