"""Engine: the data-parallel process group every rank trains in.

Counterpart of ``bigdl_tpu/utils/engine.py``.  The reference builds a
``jax.sharding.Mesh`` over every visible device, with a ``data`` axis that
the Optimizer, the distributed DataSet and sync-BN reduce over.  PyTorch
runs one process per card, so here the data axis is one
``torch.distributed`` process group over the ranks:

- ``Engine.init()`` runs on ``cuda:<local rank>`` with NCCL and raises when
  no CUDA device is available; ``Engine.init(device="cpu")`` runs on the
  host with gloo.  ``backend=`` overrides the choice (two ranks sharing one
  card need gloo: NCCL refuses two ranks on one GPU).
- :meth:`Engine.init_distributed` reads the launcher's env contract,
  mirroring ``BIGDL_TPU_*``:

    BIGDL_TORCH_COORDINATOR    host:port of rank 0 (or an init URL such
                               as ``file:///shared/path``)
    BIGDL_TORCH_NUM_PROCESSES  world size
    BIGDL_TORCH_PROCESS_ID     this process's rank

  Without a coordinator the group is a world of one process over an
  in-process store.  Every group has a finite timeout
  (:data:`DIST_TIMEOUT`), so a rank that never arrives fails the run
  instead of hanging it.
- :meth:`Engine.all_reduce`, :meth:`Engine.reduce_scatter` and
  :meth:`Engine.all_gather` are where the port sums or gathers a tensor
  over the group.  Each counts its calls by kind (``Engine.all_reduces``,
  ``Engine.reduce_scatters``, ``Engine.all_gathers``), so a run can show
  which collectives its steps issued.  ``all_reduce(..., async_op=True)``
  returns the work handle (the gradient buckets launched from the
  backward, ``parallel/sharding.py``).  ZeRO's slices go through
  ``reduce_scatter_tensor`` and ``all_gather_into_tensor`` (named
  ``reduce_scatter_single`` and ``all_gather_single`` from torch 2.13) on
  every backend: NCCL has both, and gloo has both for CPU tensors and for
  CUDA tensors (checked with two gloo ranks on one H100 under torch 2.11
  with CUDA 12.8, and on the CPU under torch 2.13), so there is one
  route.

Elastic topology (the reference's ``:230-330``): :meth:`world` and
:meth:`rank` are the LOGICAL topology the elastic protocol speaks in
(``parallel/elastic.py``): the survivors after a :meth:`reform`, else the
``BIGDL_TORCH_ELASTIC_WORLD`` / ``_ELASTIC_RANK`` declaration of separate
processes coordinated only through files, else the group's.  A rank keeps
its original id across a shrink; :meth:`is_writer` is the lowest
survivor, :meth:`data_shard_info` the rank's index among the survivors.
Under a logical world without a group each process trains its own shard
on its own; nothing is summed over the logical world.  So the code that
sums, divides or slices over the ``torch.distributed`` group reads
:meth:`group_size` and :meth:`group_rank`, never :meth:`world`.  A live
group of several processes cannot shrink in place: :meth:`reform` raises
:class:`GroupReformError` there (the survivors restart into the smaller
world, as in the reference).

One named axis besides ``data`` (the reference's ``Engine.init(
mesh_shape=...)``): ``Engine.init(mesh_shape={"pipe": n})`` (or
``{"seq": n}``) forms a 1-D ``DeviceMesh`` over the group, named by that
axis, which :meth:`mesh` returns and ``parallel/pipeline.py`` and
``parallel/ring_attention.py`` reach their ranks through.  On such a mesh the
data axis is one wide: :meth:`group` is None (no data group: the
Optimizer takes no ``DataParallel`` and averages no gradient), every
rank feeds the whole batch (:meth:`data_shard_info` is (0, 1)), every
rank seeds its Dropout generator alike, and the process of rank 0 of the
mesh is the only writer.  Two axes wider than one (a data x pipe mesh,
say) need the mesh layouts and raise (ROADMAP.md queue A item 8).
"""

from __future__ import annotations

import collections
import datetime
import logging
import math
import threading
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from . import config

__all__ = ["Engine", "GroupReformError"]

#: the axes a 1-D mesh besides ``data`` may be named by (the pipeline's
#: and the sequence-parallel attention's)
MESH_AXES = ("pipe", "seq")

logger = logging.getLogger("bigdl_torch")

#: how long a rendezvous or a collective waits for every rank
DIST_TIMEOUT = datetime.timedelta(seconds=300)

# torch 2.13 renamed the single-tensor collectives (the old names warn);
# both forms take (output, input, ...) alike
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)
_ALL_GATHER = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)


class GroupReformError(RuntimeError):
    """:meth:`Engine.reform` over a live group of several processes: the
    group cannot shrink or grow in place; the survivors restart into the
    new world."""


class Engine:
    """Process-wide singleton holding the data group (BigDL:
    utils/Engine.scala:36)."""

    #: the reference's name of the data-parallel mesh axis; the port's
    #: ``sync_axis`` takes it to mean the Engine's group
    DATA_AXIS = "data"

    _group = None
    _device: Optional[torch.device] = None
    #: True between init() and reset()
    _initialized = False
    #: the 1-D DeviceMesh of mesh_shape={axis: n}, else None
    _mesh = None
    #: the topology a reform() installed: {"rank", "survivors"}
    _elastic: Optional[dict] = None
    _lock = threading.Lock()
    #: all-reduce calls since the last reset, by kind
    all_reduces = collections.Counter()
    #: reduce-scatter calls since the last reset, by kind
    reduce_scatters = collections.Counter()
    #: all-gather calls since the last reset, by kind
    all_gathers = collections.Counter()

    @classmethod
    def init_distributed(cls, backend: str) -> None:
        """Join (or form) the default process group from the
        ``BIGDL_TORCH_*`` env contract (module docstring)."""
        coord = config.get_str("COORDINATOR", "")
        world = config.get_int("NUM_PROCESSES", 1)
        rank = config.get_int("PROCESS_ID", 0)
        if not 0 <= rank < world:
            raise ValueError(f"Engine: process id {rank} outside a world "
                             f"of {world}")
        kw = dict(backend=backend, world_size=world, rank=rank,
                  timeout=DIST_TIMEOUT)
        if coord:
            kw["init_method"] = coord if "://" in coord else f"tcp://{coord}"
        elif world == 1:
            kw["store"] = dist.HashStore()
        else:
            raise ValueError(f"Engine: a world of {world} processes needs "
                             "BIGDL_TORCH_COORDINATOR")
        dist.init_process_group(**kw)

    @classmethod
    def init(cls, device=None, backend: Optional[str] = None,
             mesh_shape: Optional[dict] = None):
        """Form the group and pick this rank's device (module docstring).
        ``mesh_shape`` is ``{"data": world}`` by default; ``{axis: world}``
        for one axis of :data:`MESH_AXES` forms the 1-D ``DeviceMesh`` of
        that axis instead of a data group.  Returns the data group, or the
        mesh where one was formed; a second call returns what the first
        formed."""
        with cls._lock:
            if cls._initialized:
                return cls.mesh()
            axis = cls._mesh_axis(mesh_shape)
            if device is None:
                if not torch.cuda.is_available():
                    raise RuntimeError("Engine.init: no CUDA device is "
                                       "available; pass device='cpu' to "
                                       "train on the host over gloo")
                rank = config.get_int("PROCESS_ID", 0)
                device = torch.device("cuda",
                                      rank % torch.cuda.device_count())
            device = torch.device(device)
            if device.type == "cuda":
                if device.index is None:
                    device = torch.device("cuda", torch.cuda.current_device())
                torch.cuda.set_device(device)
            backend = backend or ("nccl" if device.type == "cuda" else "gloo")
            world = (dist.get_world_size() if dist.is_initialized()
                     else config.get_int("NUM_PROCESSES", 1))
            if mesh_shape is not None and \
                    math.prod(int(v) for v in mesh_shape.values()) != world:
                raise ValueError(f"Engine.init: mesh_shape {mesh_shape} "
                                 f"needs {math.prod(mesh_shape.values())} "
                                 f"processes, the world has {world}")
            if not dist.is_initialized():
                cls.init_distributed(backend)
            cls._device = device
            if axis is None:
                cls._group = dist.group.WORLD
            else:
                from torch.distributed.device_mesh import DeviceMesh
                cls._mesh = DeviceMesh(device.type, list(range(world)),
                                       mesh_dim_names=(axis,))
            cls._initialized = True
            cls.clear_counts()
            logger.info("Engine.init: rank %d of %d on %s over %s%s",
                        dist.get_rank(), world, device, backend,
                        f", a {axis!r} mesh" if axis else "")
            return cls.mesh()

    @classmethod
    def _mesh_axis(cls, mesh_shape: Optional[dict]) -> Optional[str]:
        """The named axis of ``mesh_shape`` that forms a 1-D mesh, None
        for a data group; raises on what needs the mesh layouts."""
        if mesh_shape is None:
            return None
        wide = [a for a, n in mesh_shape.items() if int(n) > 1]
        unknown = [a for a in mesh_shape
                   if a != cls.DATA_AXIS and a not in MESH_AXES]
        if unknown:
            raise NotImplementedError(
                f"Engine.init: mesh axes {unknown} wait for the mesh "
                f"layouts (ROADMAP.md queue A item 8); the port forms one "
                f"of {(cls.DATA_AXIS,) + MESH_AXES}")
        if len(wide) > 1:
            raise NotImplementedError(
                f"Engine.init: mesh_shape {mesh_shape} has {len(wide)} "
                "axes wider than one; meshes of several axes wait for the "
                "mesh layouts (ROADMAP.md queue A item 8)")
        named = [a for a in mesh_shape if a != cls.DATA_AXIS]
        if not named:
            return None
        if len(named) > 1:
            raise NotImplementedError(
                f"Engine.init: mesh_shape {mesh_shape} names several axes; "
                "meshes of several axes wait for the mesh layouts "
                "(ROADMAP.md queue A item 8)")
        return named[0]

    @classmethod
    def group(cls):
        """The data group, or None before :meth:`init` and on a mesh of
        another axis (where the data axis is one wide)."""
        return cls._group

    @classmethod
    def mesh(cls):
        """The 1-D ``DeviceMesh`` of ``mesh_shape={axis: n}``; else the
        data group (the reference's mesh is the port's data group), None
        before :meth:`init`."""
        return cls._mesh if cls._mesh is not None else cls._group

    @classmethod
    def device(cls) -> Optional[torch.device]:
        """This rank's device, or None before :meth:`init`."""
        return cls._device

    @classmethod
    def reset(cls) -> None:
        """Destroy the group and forget the device and the counts."""
        with cls._lock:
            if cls._initialized and dist.is_initialized():
                dist.destroy_process_group()
            cls._group = None
            cls._mesh = None
            cls._initialized = False
            cls._device = None
            cls._elastic = None
            cls.clear_counts()

    @classmethod
    def clear_counts(cls) -> None:
        """Set every collective count to zero."""
        cls.all_reduces.clear()
        cls.reduce_scatters.clear()
        cls.all_gathers.clear()

    @classmethod
    def collectives(cls) -> dict:
        """Every collective count by operation, then kind:
        ``{"all_reduce": {...}, "reduce_scatter": {...},
        "all_gather": {...}}``."""
        return {"all_reduce": dict(cls.all_reduces),
                "reduce_scatter": dict(cls.reduce_scatters),
                "all_gather": dict(cls.all_gathers)}

    @classmethod
    def all_reduce(cls, t: torch.Tensor, kind: str, group=None,
                   async_op: bool = False):
        """Sum ``t`` in place over ``group`` (default: the data group);
        ``kind`` names the collective in :attr:`all_reduces`.  Returns
        ``t``, or with ``async_op`` the work handle, whose ``wait()`` must
        come before anything reads ``t``."""
        work = dist.all_reduce(t, op=dist.ReduceOp.SUM,
                               group=cls._group if group is None else group,
                               async_op=async_op)
        cls.all_reduces[kind] += 1
        return work if async_op else t

    @classmethod
    def reduce_scatter(cls, out: torch.Tensor, inp: torch.Tensor,
                       kind: str) -> torch.Tensor:
        """``out`` (n elements) = the sum over the group of each rank's
        ``inp`` chunk ``rank`` (``inp`` holds world x n elements, chunk r
        at [r·n, (r+1)·n)); counted in :attr:`reduce_scatters`."""
        _REDUCE_SCATTER(out, inp, op=dist.ReduceOp.SUM, group=cls._group)
        cls.reduce_scatters[kind] += 1
        return out

    @classmethod
    def all_gather(cls, out: torch.Tensor, inp: torch.Tensor,
                   kind: str) -> torch.Tensor:
        """``out`` (world x n elements) = every rank's ``inp`` (n
        elements), rank r's at [r·n, (r+1)·n); counted in
        :attr:`all_gathers`."""
        _ALL_GATHER(out, inp, group=cls._group)
        cls.all_gathers[kind] += 1
        return out

    @classmethod
    def slice_route(cls) -> str:
        """The collectives ZeRO's slices go through, with the group's
        backend: ``"<backend>: <reduce-scatter> / <all-gather>"``."""
        backend = (dist.get_backend(cls._group) if cls._group is not None
                   else None)
        return (f"{backend}: {_REDUCE_SCATTER.__name__} / "
                f"{_ALL_GATHER.__name__}")

    # -- the group (what collectives run over) ------------------------

    @classmethod
    def group_size(cls) -> int:
        """Processes of the ``torch.distributed`` group, 1 without one:
        what a sum over the group is divided by and ZeRO slices over."""
        return (dist.get_world_size(cls._group) if cls._group is not None
                else 1)

    @classmethod
    def group_rank(cls) -> int:
        """This process's rank in the group, 0 without one."""
        return dist.get_rank(cls._group) if cls._group is not None else 0

    # -- the elastic topology (parallel/elastic.py) ---------------------

    @classmethod
    def _env_elastic_world(cls) -> int:
        return config.get_int("ELASTIC_WORLD", 0)

    @classmethod
    def world(cls) -> int:
        """The logical world: the survivors after a :meth:`reform`, the
        ``BIGDL_TORCH_ELASTIC_WORLD`` topology, else the group's size."""
        if cls._elastic is not None:
            return len(cls._elastic["survivors"])
        w = cls._env_elastic_world()
        return w if w > 1 else cls.group_size()

    @classmethod
    def rank(cls) -> int:
        """This process's logical rank: its original id, kept across
        shrinks; else the group's rank."""
        if cls._elastic is not None:
            return cls._elastic["rank"]
        if cls._env_elastic_world() > 1:
            return config.get_int("ELASTIC_RANK", cls.group_rank())
        return cls.group_rank()

    @classmethod
    def survivors(cls) -> tuple:
        """The surviving original rank ids, sorted (every rank before a
        fault)."""
        if cls._elastic is not None:
            return cls._elastic["survivors"]
        return tuple(range(cls.world()))

    @classmethod
    def elastic_active(cls) -> bool:
        """True where a logical topology overrides the group's."""
        return cls._elastic is not None or cls._env_elastic_world() > 1

    @classmethod
    def is_writer(cls) -> bool:
        """True on the rank that writes to the shared store (checkpoints):
        the lowest survivor, rank 0 until a reform removes it."""
        if cls.process_rank() != cls.rank():
            return False   # every rank of a mesh holds the same state
        return cls.rank() == min(cls.survivors() or (0,))

    @classmethod
    def process_rank(cls) -> int:
        """This process's rank on the Engine's mesh (``mesh_shape={axis:
        n}``), where every rank has data rank 0; else :meth:`rank`.  Names
        a process's own files (its trace)."""
        if cls._mesh is not None:
            return dist.get_rank()
        return cls.rank()

    @classmethod
    def reform(cls, world: Optional[int] = None, rank: Optional[int] = None,
               survivors: Optional[Sequence[int]] = None,
               devices: Optional[Sequence] = None):
        """Re-form the logical topology over a new rank set: a shrink after
        a host loss or a grow when a returning host is admitted.
        ``survivors`` are original rank ids (default: the first ``world``
        current survivors, a shrink only); ``rank`` is this process's
        (default: unchanged).  ``devices`` may name this process's one
        device (the port runs one device per process); more raise.  A live
        group of several processes raises :class:`GroupReformError`.
        Returns the group (the reference's mesh), None without one."""
        if cls.group_size() > 1 or config.get_int("NUM_PROCESSES", 1) > 1:
            raise GroupReformError(
                f"Engine.reform: the torch.distributed group of "
                f"{max(cls.group_size(), config.get_int('NUM_PROCESSES', 1))}"
                " processes cannot re-form in place; restart the survivors "
                "into the new world")
        devs = None if devices is None else list(devices)
        if devs is not None and len(devs) > 1:
            raise ValueError(f"Engine.reform: {len(devs)} devices; a port "
                             "process runs on one device")
        cur = cls.survivors()
        if survivors is None:
            if world is None:
                raise ValueError("Engine.reform: need world or survivors")
            if int(world) > len(cur):
                raise ValueError(
                    f"Engine.reform: world={world} > current {len(cur)}: "
                    "growing needs an explicit survivor set (original rank "
                    "ids cannot be invented)")
            survivors = cur[:int(world)]
        survivors = tuple(sorted(int(r) for r in survivors))
        if not survivors:
            raise ValueError("Engine.reform: empty survivor set")
        if world is not None and int(world) != len(survivors):
            raise ValueError(f"Engine.reform: world={world} disagrees with "
                             f"survivors {survivors}")
        rank = cls.rank() if rank is None else int(rank)
        if rank not in survivors:
            raise ValueError(f"Engine.reform: rank {rank} not in survivors "
                             f"{survivors}")
        if devs:
            cls._device = torch.device(devs[0])
        cls._elastic = {"rank": rank, "survivors": survivors}
        logger.warning("Engine.reform: world -> %d (rank %d, survivors %s)",
                       len(survivors), rank, list(survivors))
        return cls._group

    # -- topology accessors (BigDL: Engine.nodeNumber / Engine.coreNumber) --

    @classmethod
    def data_shard_info(cls) -> tuple:
        """(shard_index, shard_count) of this process's input rows: under
        a logical topology its index among the survivors and their count,
        else its rank in the group and the group's size (one process per
        device)."""
        if cls.elastic_active():
            surv = cls.survivors()
            return surv.index(cls.rank()), len(surv)
        return cls.group_rank(), cls.group_size()

    @classmethod
    def node_number(cls) -> int:
        """The processes of the data group, 1 without one
        (Engine.nodeNumber)."""
        return cls.group_size()

    @classmethod
    def core_number(cls) -> int:
        """The CUDA devices this process sees (Engine.coreNumber); 1, the
        host, where it sees none."""
        return torch.cuda.device_count() if torch.cuda.is_available() else 1

    @classmethod
    def data_parallel_size(cls) -> int:
        return cls.group_size()

    @classmethod
    def device_count(cls) -> int:
        """Devices in the data group: one per rank."""
        return cls.group_size()
