"""Device groups for the row-sharded path (the port of the JAX package's
``repro.launch.mesh``).

The port's mesh is a `torch.distributed.device_mesh.DeviceMesh` whose
dims carry the reference's axis names: ``"model"`` (the row shards of
`repro_torch.kernels.shard_ops`), and ``"data"`` / ``"pod"`` where the
reference has them:

  single pod : (data=16, model=16)        = 256 ranks
  multi-pod  : (pod=2, data=16, model=16) = 512 ranks

The constructors are functions, never module-level constants, and run
inside an initialised process group (`torch.distributed.init_process_
group`): importing this module touches no process group and no card.

`spawn` starts ``k`` ranks on one host, each in a process of its own,
joins them in one process group over a `FileStore` in a temporary
directory, builds a one-dim ``"model"`` mesh and runs a function in
each rank: the counterpart of the reference's test mesh of 8 host
devices. The function must be importable by name in a fresh process (a
module-level function of an importable module). The ranks start with
the ``spawn`` method, since CUDA cannot be initialised again in a forked
child. On one card every rank runs on that card; NCCL refuses two ranks
on one GPU, so ranks that share a card use gloo, which takes CUDA tensors
and stages them through the host.
"""

from __future__ import annotations

import datetime
import math
import os
import pickle
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.kernels.pack import check_device


def _mesh(shape: tuple, axes: tuple, device_type: str) -> DeviceMesh:
    """A mesh over the first ``prod(shape)`` ranks of the world."""
    check_device(device_type)
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {tuple(shape)}, the process group "
            f"has {world}: initialise a process group of at least {n} "
            f"ranks (torch.distributed.init_process_group, or `spawn`)")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """The reference's production layout; raises when the process group
    is smaller than its shape."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return _mesh((16, 16), ("data", "model"), device_type)


def make_debug_mesh(shape=(2, 2), axes=("data", "model"),
                    device_type: str = "cuda") -> DeviceMesh:
    """Small mesh for tests, over the first ``prod(shape)`` ranks (pass
    ``device_type="cpu"`` for a gloo group without a card)."""
    return _mesh(tuple(shape), tuple(axes), device_type)


def _names(mesh) -> tuple:
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"a mesh is a torch DeviceMesh; got "
                        f"{type(mesh).__name__}")
    return tuple(mesh.mesh_dim_names or ())


def data_axis_names(mesh: DeviceMesh) -> tuple:
    return tuple(a for a in _names(mesh) if a in ("pod", "data"))


def data_axis_size(mesh: DeviceMesh) -> int:
    return math.prod(mesh.size(_names(mesh).index(a))
                     for a in data_axis_names(mesh))


def model_axis_size(mesh: DeviceMesh) -> int:
    """Ranks on the mesh's ``"model"`` dim (1 when it has none); anything
    but a `DeviceMesh` raises `TypeError`."""
    names = _names(mesh)
    return int(mesh.size(names.index("model"))) if "model" in names else 1


# ---------------------------------------------------------------------------
# ranks on one host
# ---------------------------------------------------------------------------

def _rank_main(rank: int, k: int, tmp: str, backend: str, device_type: str,
               timeout_s: float, fn, args) -> None:
    """One rank of `spawn`: joins the group, runs ``fn(mesh, *args)`` and
    writes its result to ``tmp/rank<rank>.pkl``."""
    # the ranks talk over the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"), k),
        rank=rank, world_size=k,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(make_debug_mesh((k,), ("model",), device_type), *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    path = Path(tmp, f"rank{rank}.pkl")
    path.with_suffix(".tmp").write_bytes(pickle.dumps(out))
    path.with_suffix(".tmp").rename(path)


def spawn(k: int, fn, *args, backend: str = "gloo",
          device_type: str = "cuda", timeout_s: float = 300.0) -> list:
    """Runs ``fn(mesh, *args)`` in ``k`` ranks, each a process of its own
    joined in one ``backend`` process group, where ``mesh`` is the ranks'
    one-dim ``"model"`` mesh on ``device_type`` (on ``"cuda"``, rank r
    runs on card r modulo the cards). Returns the ranks' results, rank 0
    first; they travel by pickle, so return host objects (numpy arrays,
    numbers), not device tensors. A rank that raises fails the call and
    the other ranks are stopped; a collective that waits longer than
    ``timeout_s`` raises in its rank. A ``"cuda"`` mesh without a card
    raises here, before any rank starts; pass ``device_type="cpu"`` for
    ranks on the host."""
    import torch.multiprocessing as mp
    if k < 1:
        raise ValueError(f"spawn needs at least 1 rank; got {k}")
    check_device(device_type)
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        mp.start_processes(_rank_main, args=(k, tmp, backend, device_type,
                                             float(timeout_s), fn, args),
                           nprocs=k, join=True, start_method="spawn")
        return [pickle.loads(Path(tmp, f"rank{r}.pkl").read_bytes())
                for r in range(k)]
