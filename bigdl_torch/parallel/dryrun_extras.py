"""Dry run of the sequence- and pipeline-parallel paths over a mesh's ranks.

Counterpart of ``bigdl_tpu/parallel/dryrun_extras.py``: on a small
problem over the ranks of ``mesh`` (any ``DeviceMesh``; its ranks in mesh
order form a 1-D ``seq`` and a 1-D ``pipe`` mesh), ring attention and
Ulysses attention against the plain attention
(``ops/attention.py`` ``mha_reference``), and ``pipeline_apply`` against
the sequential stack of its stages, so the collectives of these paths
(the ring's hops, the all-to-alls, the pipeline's hops) run over real
ranks.  Ulysses runs with twice as many heads as ranks (the reference
skips it where its two heads do not divide among the devices).  The
reference's LM step on the driver's mesh and its expert-parallel FFN are
covered by ``tests/test_torch_port_layout_train.py`` and
``tests/test_torch_port_moe.py``.

Every rank of the world calls :func:`run` with the same mesh (building
the 1-D meshes is collective); the ranks off ``mesh`` return ``{}``.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["run"]

TOL = 2e-5


def _gather_seq(ax, t: torch.Tensor) -> torch.Tensor:
    """Every rank's [B, H, T/n, D] shard, [B, H, T, D] in rank order."""
    return ax.all_gather(t, dim=2)


def run(mesh) -> dict:
    """The dry run (module docstring) on this rank; returns the largest
    errors against the plain versions, and raises ``AssertionError``
    beyond :data:`TOL`."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ..ops.attention import mha_reference
    from ..utils.engine import Engine
    from .hops import axis_group
    from .pipeline import pipeline_apply, stack_stage_params
    from .ring_attention import ring_attention, ulysses_attention

    ranks = [int(r) for r in mesh.mesh.reshape(-1).tolist()]
    n = len(ranks)
    kind = mesh.device_type
    seq_mesh = DeviceMesh(kind, ranks, mesh_dim_names=("seq",))
    pipe_mesh = DeviceMesh(kind, ranks, mesh_dim_names=("pipe",))
    if dist.get_rank() not in ranks:
        return {}
    device = Engine.device() or torch.device("cpu")
    out = {}

    # --- ring and Ulysses attention over a 'seq' axis ---------------------
    ax = axis_group(seq_mesh, "seq")
    rs = np.random.RandomState(0)
    B, H, T, D = 2, 2 * n, 4 * n, 8
    q, k, v = (torch.from_numpy(rs.standard_normal((B, H, T, D))
                                .astype(np.float32)).to(device)
               for _ in range(3))
    ref = mha_reference(q, k, v, causal=True)
    t = T // n

    def shard(x):
        return x[:, :, ax.rank * t:(ax.rank + 1) * t].contiguous()

    got = _gather_seq(ax, ring_attention(shard(q), shard(k), shard(v),
                                         mesh=seq_mesh, causal=True))
    out["ring_max_abs_err"] = float((got - ref).abs().max())
    got = _gather_seq(ax, ulysses_attention(shard(q), shard(k), shard(v),
                                            mesh=seq_mesh, causal=True))
    out["ulysses_max_abs_err"] = float((got - ref).abs().max())

    # --- pipeline parallelism over a 'pipe' axis ---------------------------
    F = 16
    stages = [{"w": torch.from_numpy(np.random.RandomState(1 + i)
                                     .standard_normal((F, F))
                                     .astype(np.float32) * 0.1).to(device),
               "b": torch.zeros(F, device=device)} for i in range(n)]

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    x = torch.from_numpy(np.random.RandomState(2).standard_normal((8, F))
                         .astype(np.float32)).to(device)
    y = pipeline_apply(stage_fn, stack_stage_params(stages), x,
                       mesh=pipe_mesh, num_microbatches=4)
    y_ref = x
    for p in stages:
        y_ref = stage_fn(p, y_ref)
    out["pipeline_max_abs_err"] = float((y - y_ref).abs().max())
    out["pipeline_loss_err"] = abs(float((y ** 2).mean())
                                   - float((y_ref ** 2).mean()))
    bad = {k: e for k, e in out.items() if not e <= TOL}
    assert not bad, f"dryrun_extras on ranks {ranks}: {bad} beyond {TOL}"
    return out
