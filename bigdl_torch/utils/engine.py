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
- :meth:`Engine.all_reduce` is the one place the port sums a tensor over
  the group; it counts its calls by kind (``Engine.all_reduces``), so a run
  can show which collectives its steps issued.

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
            cls.all_reduces.clear()
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
            cls.all_reduces.clear()

    @classmethod
    def all_reduce(cls, t: torch.Tensor, kind: str,
                   group=None) -> torch.Tensor:
        """Sum ``t`` in place over ``group`` (default: the data group);
        ``kind`` names the collective in :attr:`all_reduces`."""
        dist.all_reduce(t, op=dist.ReduceOp.SUM,
                        group=cls._group if group is None else group)
        cls.all_reduces[kind] += 1
        return t

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
    def data_parallel_size(cls) -> int:
        return cls.world()

    @classmethod
    def device_count(cls) -> int:
        """Devices in the data group: one per rank."""
        return cls.world()
