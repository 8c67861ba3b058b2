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

`MeshShape` is a mesh without ranks: its axis names and sizes, for the
sharding rules and the dry-run's reckoning of a 256- or 512-chip layout
(`abstract_production_mesh`), as the reference's tests use a
``FakeMesh``. The axis helpers take either kind. `fake_mesh` holds such a
layout as a real `DeviceMesh` over a fake process group, whose
collectives move nothing: the dry-run runs rank 0's share of a sharded
step on it.

`spawn` starts ``k`` ranks on one host, each in a process of its own,
joins them in one process group over a `FileStore` in a temporary
directory, builds a mesh over them (one ``"model"`` dim unless asked
otherwise) and runs a function in each rank: the counterpart of the
reference's test mesh of 8 host devices. The function must be importable by name in a fresh process (a
module-level function of an importable module). The ranks start with
the ``spawn`` method, since CUDA cannot be initialised again in a forked
child. On one card every rank runs on that card; NCCL refuses two ranks
on one GPU, so ranks that share a card use gloo, which takes CUDA tensors
and stages them through the host.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import os
import pickle
import tempfile
import traceback
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


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no ranks behind them."""
    axis_names: tuple
    sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{self.axis_names} against {self.sizes}")

    @property
    def shape(self) -> dict:
        """Axis name -> size, as a jax ``Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def ndevices(self) -> int:
        return math.prod(self.sizes)


def abstract_production_mesh(multi_pod: bool = False) -> MeshShape:
    """The production layout of `make_production_mesh`, without ranks."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


@contextlib.contextmanager
def fake_mesh(shape: tuple = (16, 16), axes: tuple = ("data", "model")):
    """A `DeviceMesh` of ``shape`` (the production layout by default; the
    multi-pod one is ``(2, 16, 16)`` over ``("pod", "data", "model")``)
    held by this process as rank 0 of a fake process group of every rank
    of the shape (torch's testing ``FakeStore`` backend): its collectives
    return at once and move nothing, so a step runs rank 0's share of a
    sharded program, as the reference lowers one for 512 placeholder
    devices. The group is destroyed on exit; a process holds one group at
    a time, so the single-pod and multi-pod meshes are opened in turn.
    Its device type is ``"cpu"``; a dry-run builds its tensors on
    ``meta``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    n = math.prod(shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield DeviceMesh("cpu", torch.arange(n).reshape(tuple(shape)),
                         mesh_dim_names=tuple(axes))
    finally:
        dist.destroy_process_group()


def is_fake(mesh) -> bool:
    """Whether ``mesh`` is a `DeviceMesh` over a fake process group
    (`fake_mesh`)."""
    return isinstance(mesh, DeviceMesh) and \
        dist.get_backend(mesh.get_group(0)) == "fake"


def mesh_shape(mesh) -> dict:
    """Axis name -> size of a `DeviceMesh` or a `MeshShape`; anything else
    raises `TypeError`."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"a mesh is a torch DeviceMesh or a MeshShape; got "
                        f"{type(mesh).__name__}")
    names = tuple(mesh.mesh_dim_names or ())
    return {a: int(mesh.size(i)) for i, a in enumerate(names)}


def data_axis_names(mesh) -> tuple:
    return tuple(a for a in mesh_shape(mesh) if a in ("pod", "data"))


def data_axis_size(mesh) -> int:
    shape = mesh_shape(mesh)
    return math.prod(shape[a] for a in data_axis_names(mesh))


def model_axis_size(mesh) -> int:
    """Size of the mesh's ``"model"`` axis (1 when it has none); anything
    but a `DeviceMesh` or a `MeshShape` raises `TypeError`."""
    return mesh_shape(mesh).get("model", 1)


# ---------------------------------------------------------------------------
# ranks on one host
# ---------------------------------------------------------------------------

def _rank_main(rank: int, k: int, tmp: str, backend: str, device_type: str,
               timeout_s: float, shape: tuple, axes: tuple, fn,
               args) -> None:
    """One rank of `spawn`: joins the group, runs ``fn(mesh, *args)`` and
    writes its result to ``tmp/rank<rank>.pkl``."""
    # the ranks talk over the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:   # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // k))
    dist.init_process_group(
        backend, store=dist.FileStore(os.path.join(tmp, "store"), k),
        rank=rank, world_size=k,
        timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "gloo" and device_type == "cuda":
        # DTensor's collectives over gloo on the card (torch 2.11 crashes
        # in their wait): through torch.distributed's own
        from repro_torch.launch import gloo_route
        gloo_route.install()
    try:
        out = fn(make_debug_mesh(shape, axes, device_type), *args)
        dist.barrier()
    except BaseException:
        # noted before this rank leaves the group: a rank that then fails
        # in a collective with it must not hide the first failure
        Path(tmp, f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    path = Path(tmp, f"rank{rank}.pkl")
    path.with_suffix(".tmp").write_bytes(pickle.dumps(out))
    path.with_suffix(".tmp").rename(path)


def spawn(k: int, fn, *args, backend: str = "gloo",
          device_type: str = "cuda", timeout_s: float = 300.0,
          axes: tuple = ("model",), shape: tuple | None = None) -> list:
    """Runs ``fn(mesh, *args)`` in ``k`` ranks, each a process of its own
    joined in one ``backend`` process group, where ``mesh`` is the ranks'
    mesh on ``device_type``: dims ``axes`` of sizes ``shape`` (default: one
    dim of all ``k`` ranks) over the first ranks of the world (on
    ``"cuda"``, rank r runs on card r modulo the cards). Returns the
    ranks' results, rank 0 first; they travel by pickle, so return host objects (numpy arrays,
    numbers), not device tensors. A rank that raises fails the call (a
    `RuntimeError` carrying the traceback of every rank that raised) and
    the other ranks are stopped; a collective that waits longer than
    ``timeout_s`` raises in its rank. A ``"cuda"`` mesh without a card
    raises here, before any rank starts; pass ``device_type="cpu"`` for
    ranks on the host."""
    import torch.multiprocessing as mp
    if k < 1:
        raise ValueError(f"spawn needs at least 1 rank; got {k}")
    check_device(device_type)
    shape = (k,) if shape is None else tuple(shape)
    if len(shape) != len(axes) or math.prod(shape) > k:
        raise ValueError(f"a mesh {shape} of axes {axes} over {k} ranks")
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        try:
            mp.start_processes(_rank_main,
                               args=(k, tmp, backend, device_type,
                                     float(timeout_s), shape, tuple(axes),
                                     fn, args),
                               nprocs=k, join=True, start_method="spawn")
        except Exception as exc:
            notes = [f"rank {r}:\n{Path(tmp, f'rank{r}.err').read_text()}"
                     for r in range(k) if Path(tmp, f"rank{r}.err").exists()]
            if not notes:
                raise
            raise RuntimeError("ranks failed; each failing rank's "
                               "traceback:\n" + "\n".join(notes)) from exc
        return [pickle.loads(Path(tmp, f"rank{r}.pkl").read_bytes())
                for r in range(k)]
