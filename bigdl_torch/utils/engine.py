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

Not ported: elasticity (``reform``, survivors, the simulated topologies)
and multi-axis meshes.
"""

from __future__ import annotations

import collections
import datetime
import logging
import threading
from typing import Optional

import torch
import torch.distributed as dist

from . import config

__all__ = ["Engine"]

logger = logging.getLogger("bigdl_torch")

#: how long a rendezvous or a collective waits for every rank
DIST_TIMEOUT = datetime.timedelta(seconds=300)

# torch 2.13 renamed the single-tensor collectives (the old names warn);
# both forms take (output, input, ...) alike
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)
_ALL_GATHER = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)


class Engine:
    """Process-wide singleton holding the data group (BigDL:
    utils/Engine.scala:36)."""

    #: the reference's name of the data-parallel mesh axis; the port's
    #: ``sync_axis`` takes it to mean the Engine's group
    DATA_AXIS = "data"

    _group = None
    _device: Optional[torch.device] = None
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
    def init(cls, device=None, backend: Optional[str] = None):
        """Form the data group and pick this rank's device (module
        docstring); returns the group.  A second call returns the group
        already formed."""
        with cls._lock:
            if cls._group is not None:
                return cls._group
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
            if not dist.is_initialized():
                cls.init_distributed(backend)
            cls._device = device
            cls._group = dist.group.WORLD
            cls.clear_counts()
            logger.info("Engine.init: rank %d of %d on %s over %s",
                        cls.rank(), cls.world(), device, backend)
            return cls._group

    @classmethod
    def group(cls):
        """The data group, or None before :meth:`init`."""
        return cls._group

    #: the reference's mesh is the port's data group
    mesh = group

    @classmethod
    def device(cls) -> Optional[torch.device]:
        """This rank's device, or None before :meth:`init`."""
        return cls._device

    @classmethod
    def reset(cls) -> None:
        """Destroy the group and forget the device and the counts."""
        with cls._lock:
            if cls._group is not None and dist.is_initialized():
                dist.destroy_process_group()
            cls._group = None
            cls._device = None
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

    # -- topology accessors (BigDL: Engine.nodeNumber / Engine.coreNumber) --

    @classmethod
    def rank(cls) -> int:
        return dist.get_rank(cls._group) if cls._group is not None else 0

    @classmethod
    def world(cls) -> int:
        return (dist.get_world_size(cls._group) if cls._group is not None
                else 1)

    @classmethod
    def data_shard_info(cls) -> tuple:
        """(shard_index, shard_count) of this process's input rows: its
        rank and the world size (one process per device)."""
        return cls.rank(), cls.world()

    @classmethod
    def node_number(cls) -> int:
        """The processes of the data group, 1 without one
        (Engine.nodeNumber)."""
        return cls.world()

    @classmethod
    def core_number(cls) -> int:
        """The CUDA devices this process sees (Engine.coreNumber); 1, the
        host, where it sees none."""
        return torch.cuda.device_count() if torch.cuda.is_available() else 1

    @classmethod
    def data_parallel_size(cls) -> int:
        return cls.world()

    @classmethod
    def device_count(cls) -> int:
        """Devices in the data group: one per rank."""
        return cls.world()
