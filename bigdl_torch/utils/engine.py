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
mesh is the only writer.

The mesh layouts (``parallel/layout.py``): ``mesh_shape`` over the
canonical axes (``data``, ``fsdp``, ``tp``, and ``pipe`` / ``expert``),
naming ``fsdp`` or ``tp`` (``MeshLayout.install()`` does the same), forms
the multi-axis ``DeviceMesh`` of the layout, row-major in the canonical
order; the reference's tensor-parallel ``{"model": m, "data": d}`` forms
one in the order given.  :meth:`set_mesh` installs a mesh built by hand.
On such a mesh :meth:`group` is the BATCH group: the ranks of ``data x
fsdp`` (of ``data`` on the ``model`` mesh) that share this rank's other
coordinates, so :meth:`data_shard_info`, the distributed ``DataSet``,
sync-BN and the Dropout seed follow the batch shard, and the ranks of one
tp group hold the same rows.  :meth:`axis_group` gives the process group
of any set of the mesh's axes (every such group is formed when the mesh
is installed: ``new_group`` is collective).  ``pipe`` and ``expert``
stand beside the other three and beside each other (a 5-axis layout
such as (2,1,1,2,1), (1,1,2,2,1), (1,1,2,1,2) or (1,1,1,2,2)): like
``tp`` they replicate the batch, so the batch group stays ``data x
fsdp``; every set of the wide axes gets its group, row-major with this
rank's other coordinates fixed (``("tp", "pipe")`` as any other, in one
order on every rank).  ``{"data": d, "seq": s}`` forms a 2-D ``(data,
seq)`` mesh whose batch group is the ``data`` axis.  Each of these still
raises, naming ROADMAP.md queue A item 8: ``seq`` beside any axis but
``data``, and axes of no mesh.
:meth:`reform` over a multi-axis mesh raises the reference's typed
``MeshReformError`` where the new rank count cannot keep the non-data
block intact, before the live group's :class:`GroupReformError`.

Meshes over a subset of the ranks (the topology router's members,
``serve/router.py``; any ``MeshLayout.build_mesh(ranks)``): building one
registers it (:meth:`register_mesh`, collective: every rank of the
world builds every such mesh, in one order), which forms the process
group of every set of its wide axes and its lead group (every rank of
the mesh, over gloo: a follower waits there for its leader's next
message, ``serve/lead.py``).  Inside
``with Engine.pinned(mesh):`` the calling THREAD reads that mesh as the
Engine's: :meth:`mesh`, :meth:`mesh_coordinate`, :meth:`axis_group`,
:meth:`group` (its batch group), :meth:`group_size` and
:meth:`group_rank`, so the layouts' plans, scoring and decoding run on
the member's ranks while another thread of the same process serves
another mesh.  The Engine's own mesh is registered when installed.

Besides the three kinds of :meth:`collectives`, the ring's hops and the
all-to-alls of the sequence-parallel attentions are counted
(:attr:`permutes`, :attr:`all_to_alls`), and listed there once any ran.
"""

from __future__ import annotations

import collections
import contextlib
import datetime
import itertools
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
#: the mesh layouts' canonical axes, in mesh order
LAYOUT_AXES = ("data", "fsdp", "tp", "pipe", "expert")
#: the reference's tensor-parallel mesh axes
LEGACY_TP_AXES = ("model", "data")
#: the axes a batch splits over on a multi-axis mesh
BATCH_AXES = ("data", "fsdp")

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


class _MeshState:
    """A registered multi-axis mesh as this rank sees it: the process group
    of every set of its wide axes and its batch group (None off the mesh),
    this rank's coordinate (None off the mesh), and its lead group (the
    mesh's ranks, over gloo)."""

    def __init__(self, mesh, groups: dict, lead):
        self.mesh, self.groups, self.lead = mesh, groups, lead
        self.names = tuple(mesh.mesh_dim_names)
        c = mesh.get_coordinate()
        self.coord = None if c is None else dict(zip(self.names, c))
        self.ranks = [int(r) for r in mesh.mesh.reshape(-1).tolist()]
        batch = BATCH_AXES if "model" not in self.names else ("data",)
        self.batch = self.axis_group(batch) if self.coord is not None \
            else None

    def axis_group(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        key = tuple(a for a in self.names if a in axes and
                    int(self.mesh.shape[self.names.index(a)]) > 1)
        return self.groups[key]


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
    #: the DeviceMesh of mesh_shape (1-D or a layout's), else None
    _mesh = None
    #: the topology a reform() installed: {"rank", "survivors"}
    _elastic: Optional[dict] = None
    _lock = threading.Lock()
    #: the installed multi-axis mesh's state, else None
    _state: Optional[_MeshState] = None
    #: id(mesh) -> _MeshState of every registered mesh
    _registered: dict = {}
    #: the mesh a thread pinned (:meth:`pinned`)
    _local = threading.local()
    #: all-reduce calls since the last reset, by kind
    all_reduces = collections.Counter()
    #: reduce-scatter calls since the last reset, by kind
    reduce_scatters = collections.Counter()
    #: all-gather calls since the last reset, by kind
    all_gathers = collections.Counter()
    #: point-to-point hops around a ring (``parallel/hops.py``) since the
    #: last reset, by kind: the reference's collective-permutes
    permutes = collections.Counter()
    #: all-to-alls since the last reset, by kind
    all_to_alls = collections.Counter()

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
            kind, axis = cls._mesh_kind(mesh_shape)
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
            from torch.distributed.device_mesh import DeviceMesh
            if kind == "group":
                cls._group = dist.group.WORLD
            elif kind == "axis":
                cls._mesh = DeviceMesh(device.type, list(range(world)),
                                       mesh_dim_names=(axis,))
            elif kind == "layout":
                cls._install(axis.build_mesh(range(world)))
            else:
                names = axis
                cls._install(DeviceMesh(
                    device.type, torch.arange(world).reshape(
                        [int(mesh_shape[a]) for a in names]),
                    mesh_dim_names=names))
            cls._initialized = True
            cls.clear_counts()
            logger.info("Engine.init: rank %d of %d on %s over %s%s",
                        dist.get_rank(), world, device, backend,
                        "" if cls._mesh is None else ", a %s mesh" % dict(
                            zip(cls._mesh.mesh_dim_names, cls._mesh.shape)))
            return cls.mesh()

    @classmethod
    def _mesh_kind(cls, mesh_shape: Optional[dict]):
        """What ``mesh_shape`` forms: ("group", None) the data group,
        ("axis", name) a 1-D mesh of one named axis, ("layout",
        MeshLayout) a layout's mesh, ("legacy", names) the reference's
        tensor-parallel mesh in the order given, ("named", names) the
        ``data x seq`` mesh; raises on what waits for the rest of the mesh
        layouts (a seq axis beside another than data, an axis of no
        mesh), one message a combination."""
        if mesh_shape is None:
            return "group", None
        shape = {a: int(n) for a, n in mesh_shape.items()}
        keys = set(shape)

        def refuse(why):
            raise NotImplementedError(
                f"Engine.init: mesh_shape {mesh_shape}: {why} wait(s) for "
                "the rest of the mesh layouts (ROADMAP.md queue A item 8)")
        known = set(LAYOUT_AXES) | set(MESH_AXES) | set(LEGACY_TP_AXES)
        if keys - known:
            refuse(f"mesh axes {sorted(keys - known)}")
        if "seq" in keys:
            rest = sorted(keys - {"seq", cls.DATA_AXIS})
            if rest:
                refuse(f"a seq axis beside {rest}")
            if shape.get(cls.DATA_AXIS, 1) > 1:
                return "named", (cls.DATA_AXIS, "seq")
            return "axis", "seq"
        if "model" in keys:
            if keys - set(LEGACY_TP_AXES):
                refuse("a model axis beside the layout axes")
            return "legacy", tuple(mesh_shape)
        if keys <= {cls.DATA_AXIS}:
            return "group", None
        if keys <= {cls.DATA_AXIS, "pipe"} and \
                shape.get(cls.DATA_AXIS, 1) == 1:
            return "axis", "pipe"
        from ..parallel.layout import MeshLayout
        return "layout", MeshLayout(**shape)

    @classmethod
    def _install(cls, mesh) -> None:
        """Make ``mesh`` (several named axes) the Engine's: its batch
        group and the process group of every set of its wide axes
        (formed here unless the mesh is registered already)."""
        st = cls._registered.get(id(mesh))
        if st is None or st.mesh is not mesh:
            st = cls.register_mesh(mesh)
        cls._mesh = mesh
        cls._state = st
        cls._group = st.batch

    @classmethod
    def register_mesh(cls, mesh) -> _MeshState:
        """Form the process groups of a multi-axis ``DeviceMesh`` (over all
        the ranks or a subset of them): one a set of its wide axes and a
        row of the others, and its lead group.  Collective: every rank of
        the world registers every mesh, in one order (``new_group``
        forms a group on every rank, members or not).  Returns its state;
        :meth:`pinned` reads it."""
        names = tuple(mesh.mesh_dim_names)
        sizes = [int(n) for n in mesh.shape]
        ranks = mesh.mesh.reshape(sizes)
        wide = [a for a, n in zip(names, sizes) if n > 1]
        me = dist.get_rank()
        whole = math.prod(sizes) == dist.get_world_size()
        groups = {}
        for k in range(len(wide) + 1):
            for axes in itertools.combinations(wide, k):
                if len(axes) == len(wide) and whole:
                    groups[axes] = dist.group.WORLD
                    continue
                dims = [names.index(a) for a in axes]
                rest = [d for d in range(len(names)) if d not in dims]
                rows = ranks.permute(rest + dims).reshape(
                    -1, math.prod(sizes[d] for d in dims))
                for row in rows.tolist():
                    g = dist.new_group(row)
                    if me in row:
                        groups[axes] = g
        members = sorted(int(r) for r in ranks.reshape(-1).tolist())
        lead = dist.new_group(members, timeout=DIST_TIMEOUT, backend="gloo")
        st = _MeshState(mesh, groups if me in members else {},
                        lead if me in members else None)
        cls._registered[id(mesh)] = st
        return st

    @classmethod
    def mesh_state(cls, mesh=None) -> Optional[_MeshState]:
        """The state of a registered mesh (the Engine's own included);
        an unregistered one raises.  ``mesh`` None: the thread's pinned
        mesh's, else the installed multi-axis mesh's, else None."""
        if mesh is None:
            return cls._pin() or cls._state
        st = cls._registered.get(id(mesh))
        if st is None or st.mesh is not mesh:
            raise ValueError("the mesh is not registered: build it with "
                             "parallel/layout.MeshLayout.build_mesh on every "
                             "rank (or install it as the Engine's)")
        return st

    @classmethod
    @contextlib.contextmanager
    def pinned(cls, mesh):
        """Inside the block this thread reads ``mesh`` (registered, with
        this rank on it) as the Engine's mesh (module docstring); blocks
        nest."""
        st = cls.mesh_state(mesh)
        if st.coord is None:
            raise ValueError(f"rank {dist.get_rank()} is not on the mesh of "
                             f"ranks {st.ranks}")
        prev = getattr(cls._local, "pin", None)
        cls._local.pin = st
        try:
            yield st
        finally:
            cls._local.pin = prev

    @classmethod
    def _pin(cls) -> Optional[_MeshState]:
        return getattr(cls._local, "pin", None)

    @classmethod
    def set_mesh(cls, mesh) -> None:
        """Install a multi-axis ``DeviceMesh`` over the whole group (a
        layout's, ``MeshLayout.build_mesh``) as the Engine's mesh; the
        group must be formed (:meth:`init`) and every rank calls this."""
        if not cls._initialized:
            raise RuntimeError("Engine.set_mesh: call Engine.init() first")
        with cls._lock:
            cls._install(mesh)
            cls.clear_counts()

    @classmethod
    def axis_group(cls, axes):
        """This rank's process group over the mesh axes ``axes`` (one name
        or several; one-wide and absent axes count for nothing: an empty
        set is this rank alone).  None where no multi-axis mesh is
        installed."""
        st = cls._pin() or cls._state
        if st is None or not st.groups:
            return None
        return st.axis_group(axes)

    @classmethod
    def mesh_coordinate(cls) -> dict:
        """{axis: this rank's index on it} of the Engine's mesh ({} without
        one)."""
        pin = cls._pin()
        if pin is not None:
            return dict(pin.coord)
        if cls._mesh is None:
            return {}
        return dict(zip(cls._mesh.mesh_dim_names,
                        cls._mesh.get_coordinate()))

    @classmethod
    def group(cls):
        """The data group (on a multi-axis mesh the batch group), or None
        before :meth:`init` and on a 1-D mesh of another axis (where the
        data axis is one wide)."""
        pin = cls._pin()
        return pin.batch if pin is not None else cls._group

    @classmethod
    def mesh(cls):
        """The ``DeviceMesh`` of ``mesh_shape`` (or :meth:`set_mesh`); else the
        data group (the reference's mesh is the port's data group), None
        before :meth:`init`."""
        pin = cls._pin()
        if pin is not None:
            return pin.mesh
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
            cls._state = None
            cls._registered = {}
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
        cls.permutes.clear()
        cls.all_to_alls.clear()

    @classmethod
    def collectives(cls) -> dict:
        """Every collective count by operation, then kind:
        ``{"all_reduce": {...}, "reduce_scatter": {...},
        "all_gather": {...}}``, with ``"permute"`` and ``"all_to_all"``
        once any of those ran."""
        out = {"all_reduce": dict(cls.all_reduces),
               "reduce_scatter": dict(cls.reduce_scatters),
               "all_gather": dict(cls.all_gathers)}
        if cls.permutes:
            out["permute"] = dict(cls.permutes)
        if cls.all_to_alls:
            out["all_to_all"] = dict(cls.all_to_alls)
        return out

    @classmethod
    def all_reduce(cls, t: torch.Tensor, kind: str, group=None,
                   async_op: bool = False):
        """Sum ``t`` in place over ``group`` (default: the data group);
        ``kind`` names the collective in :attr:`all_reduces`.  Returns
        ``t``, or with ``async_op`` the work handle, whose ``wait()`` must
        come before anything reads ``t``."""
        work = dist.all_reduce(t, op=dist.ReduceOp.SUM,
                               group=cls.group() if group is None else group,
                               async_op=async_op)
        cls.all_reduces[kind] += 1
        return work if async_op else t

    @classmethod
    def reduce_scatter(cls, out: torch.Tensor, inp: torch.Tensor,
                       kind: str, group=None) -> torch.Tensor:
        """``out`` (n elements) = the sum over ``group`` (default: the data
        group) of each rank's ``inp`` chunk ``rank`` (``inp`` holds world x
        n elements, chunk r at [r·n, (r+1)·n)); counted in
        :attr:`reduce_scatters`."""
        _REDUCE_SCATTER(out, inp, op=dist.ReduceOp.SUM,
                        group=cls.group() if group is None else group)
        cls.reduce_scatters[kind] += 1
        return out

    @classmethod
    def all_gather(cls, out: torch.Tensor, inp: torch.Tensor,
                   kind: str, group=None) -> torch.Tensor:
        """``out`` (world x n elements) = every rank's ``inp`` (n
        elements) over ``group`` (default: the data group), rank r's at
        [r·n, (r+1)·n); counted in :attr:`all_gathers`."""
        _ALL_GATHER(out, inp, group=cls.group() if group is None else group)
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
        group = cls.group()
        return dist.get_world_size(group) if group is not None else 1

    @classmethod
    def group_rank(cls) -> int:
        """This process's rank in the group, 0 without one."""
        group = cls.group()
        return dist.get_rank(group) if group is not None else 0

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
        Returns the group (the reference's mesh), None without one.  On
        a multi-axis mesh the new rank count must keep the non-data block
        (:meth:`_reform_data_axis`)."""
        if cls._mesh is not None and len(cls._mesh.mesh_dim_names) > 1:
            n = (len(set(survivors)) if survivors is not None
                 else None if world is None else int(world))
            if n is not None:
                cls._reform_data_axis(n)
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

    @classmethod
    def _reform_data_axis(cls, n: int) -> dict:
        """The mesh shape after re-forming the multi-axis mesh over ``n``
        ranks by resizing its ``data`` axis, every other axis kept (the
        reference's check, with its messages): raises
        ``MeshReformError`` where there is no ``data`` axis or ``n`` is
        not a multiple of the non-data block."""
        from ..parallel.layout import MeshReformError
        names = tuple(cls._mesh.mesh_dim_names)
        shape = dict(zip(names, (int(s) for s in cls._mesh.shape)))
        if cls.DATA_AXIS not in names:
            raise MeshReformError(
                f"cannot re-form mesh {shape} over {n} rank(s): no "
                f"'{cls.DATA_AXIS}' axis to resize — rebuild the layout via "
                "Engine.init")
        rest = {a: s for a, s in shape.items() if a != cls.DATA_AXIS}
        block = math.prod(rest.values())
        if n < block or n % block:
            raise MeshReformError(
                f"cannot re-form mesh {shape} over {n} rank(s): the "
                f"non-data block ({rest} = {block} ranks) must divide the "
                "rank count to keep the fsdp/tp/pipe/expert shard groups "
                f"intact; re-form to a multiple of {block} ranks or re-init "
                "a different layout")
        return {**shape, cls.DATA_AXIS: n // block}

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
