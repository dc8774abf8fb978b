"""Device-memory accounting for the smoke and benchmark records.

Counterpart of ``bigdl_tpu/utils/memstats.py``:

- :func:`device_memory_stats`: the CUDA caching allocator's own ledger
  (``torch.cuda.memory_stats``), with the reference's ``bytes_in_use``
  (current allocated bytes) and ``peak_bytes_in_use`` (their peak since
  the last ``torch.cuda.reset_peak_memory_stats``); None on a CPU, which
  keeps no ledger.
- :func:`live_device_bytes`: the sum of the tensors alive on one device
  (found through the garbage collector), the stand-in on a CPU.
- :func:`tree_device_bytes`, :func:`tree_total_bytes`: a tree's bytes on
  one device and in all.  A tree is a tensor, a module (its parameters and
  buffers), or a list, tuple or dict of them.  Under the mesh layouts a
  rank holds shards: the first counts this rank's shard bytes, the second
  the whole leaves' (the reference's per device and in all).
- :func:`memory_record`: the record's block, with the reference's keys.

- :func:`pipeline_stage_bytes`: each pipeline's stacked stage bytes.  On
  a 1-D pipe mesh every pipe rank holds the whole stack (the reference's
  replicated branch); under ``LayoutSharding`` on a layout with ``pipe``
  = p a rank holds 1/p of it.
- :func:`embedding_table_bytes`: each ``embedding_row`` table's bytes in
  all and on one device, the fraction a rank holds (1/n under a layout
  that splits its rows n ways, 1.0 replicated) and its rows.

The reference's ``compiled_memory_analysis`` reads an XLA executable,
which the port does not have.
"""

from __future__ import annotations

import gc
import math
import warnings
from typing import Optional

import torch

__all__ = ["device_memory_stats", "live_device_bytes", "tree_device_bytes",
           "tree_total_bytes", "memory_record", "pipeline_stage_bytes",
           "embedding_table_bytes"]


def _device(device) -> torch.device:
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def device_memory_stats(device=None) -> Optional[dict]:
    """``torch.cuda.memory_stats`` of a CUDA device with the reference's
    ``bytes_in_use`` and ``peak_bytes_in_use`` added; None on a CPU."""
    dev = _device(device)
    if dev.type != "cuda":
        return None
    stats = dict(torch.cuda.memory_stats(dev))
    stats["bytes_in_use"] = int(stats.get("allocated_bytes.all.current", 0))
    stats["peak_bytes_in_use"] = int(stats.get("allocated_bytes.all.peak",
                                               0))
    return stats


def _leaves(tree):
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def live_device_bytes(device=None) -> int:
    """Bytes of every distinct storage alive on one device."""
    dev = _device(device)
    seen, total = set(), 0
    with warnings.catch_warnings():
        # isinstance() on a deprecated module attribute warns
        warnings.simplefilter("ignore")
        tensors = [o for o in gc.get_objects()
                   if isinstance(o, torch.Tensor)]
    for obj in tensors:
        try:
            if obj.device != dev:
                continue
            st = obj.untyped_storage()
            key = st.data_ptr()
            if key in seen:
                continue
            seen.add(key)
            total += st.nbytes()
        except Exception:  # noqa: BLE001 — a tensor without a storage
            continue
    return total


def tree_device_bytes(tree, device=None) -> int:
    """A tree's bytes that live on ``device``."""
    dev = _device(device)
    return sum(_nbytes(t) for t in _leaves(tree) if t.device == dev)


def tree_total_bytes(tree) -> int:
    """A tree's bytes wherever they live: a mesh shard counts its whole
    leaf (``_layout_whole``, ``parallel/mesh_plan.py``), which the ranks
    hold between them."""
    total = 0
    for t in _leaves(tree):
        whole = getattr(t, "_layout_whole", None)
        n = t.numel() if whole is None else math.prod(whole)
        total += n * t.element_size()
    return total


def memory_record(params=None, opt_state=None, device=None) -> dict:
    """The record's memory block: the allocator's ledger where there is
    one (``source: memory_stats``), else the live tensors' sum
    (``source: live_buffer_sum``), plus the bytes of ``params`` and
    ``opt_state`` on the device and in all."""
    dev = _device(device)
    rec: dict = {}
    stats = device_memory_stats(dev)
    if stats is not None:
        rec["source"] = "memory_stats"
        rec["bytes_in_use"] = stats["bytes_in_use"]
        rec["peak_bytes_in_use"] = stats["peak_bytes_in_use"]
    else:
        rec["source"] = "live_buffer_sum"
        rec["bytes_in_use"] = live_device_bytes(dev)
    if params is not None:
        rec["param_bytes_per_device"] = tree_device_bytes(params, dev)
        rec["param_bytes_total"] = tree_total_bytes(params)
    if opt_state is not None:
        rec["slot_bytes_per_device"] = tree_device_bytes(opt_state, dev)
        rec["slot_bytes_total"] = tree_total_bytes(opt_state)
    return rec


def pipeline_stage_bytes(model, params=None, device=None):
    """Per-stage parameter accounting for every ``GPipeSequential`` in
    ``model`` (``parallel/pipeline.py``): the stacked stage parameters'
    bytes, bytes per stage, and the bytes resident on ``device`` (the
    whole stack on a 1-D pipe mesh, where every pipe rank holds it; 1/p
    of it under ``LayoutSharding`` on a layout with ``pipe`` = p).  ``params`` is accepted for
    the reference's signature; the module holds its own.  A list of one
    dict per pipeline, or None when the model has no pipelined region."""
    from ..parallel.pipeline import GPipeSequential
    out = []
    for mod in model.unique_modules():
        if isinstance(mod, GPipeSequential):
            stack = list(mod.stage.parameters())
            total = tree_total_bytes(stack)
            n = mod.num_stages
            out.append({"stages": n,
                        "stage_param_bytes": total // max(n, 1),
                        "stacked_param_bytes": total,
                        "param_bytes_per_device": tree_device_bytes(
                            stack, device)})
    return out or None


def embedding_table_bytes(model, params=None, device=None):
    """One dict a parameter whose module's roles place it under
    ``embedding_row`` (``LookupTable``, the positional table), in the
    reference's tree order: its ``module`` and ``param`` names, ``rows``
    (the whole table's), ``table_bytes`` (the whole table's),
    ``table_bytes_per_device`` (this rank's shard on ``device``) and
    ``device_fraction`` (their ratio, rounded to 6 places: 1/n where a
    layout splits the rows n ways, 1.0 replicated).  A pipeline's stacked
    stages hold ``pipeline_stage`` leaves and are not walked.  ``params``
    is accepted for the reference's signature; the module holds its own.
    None when the model has no such table."""
    from ..nn.module import Container
    from .convert import _stacked
    out = []

    def walk(mod):
        if isinstance(mod, Container):
            if not _stacked(mod):
                for _, child in mod.tree_children():
                    walk(child)
            return
        roles = mod.param_roles() if hasattr(mod, "param_roles") else None
        if not roles:
            return
        for name, leaf in mod.named_parameters(recurse=False):
            if roles.get(name, roles.get("*")) != "embedding_row":
                continue
            whole = getattr(leaf, "_layout_whole", None) or leaf.shape
            total = tree_total_bytes(leaf)
            per_dev = tree_device_bytes(leaf, device)
            out.append({"module": type(mod).__name__, "param": name,
                        "rows": int(whole[0]) if len(whole) else 0,
                        "table_bytes": total,
                        "table_bytes_per_device": per_dev,
                        "device_fraction": round(per_dev / total, 6)
                        if total else 0.0})

    walk(model)
    return out or None
