"""MeshLayout: the named data/fsdp/tp/pipe/expert mesh axes and the
role-based partition specs.

Counterpart of ``bigdl_tpu/parallel/layout.py``.  The reference names
three canonical axes, ``data x fsdp x tp`` (plus ``pipe`` and ``expert``,
which stay out of the mesh while they are one wide), and resolves every
parameter leaf to a ``PartitionSpec`` through a table of per-ROLE specs:
modules declare roles (``Module.PARAM_ROLES``), never specs, and a leaf
whose module declared none raises :class:`UnannotatedParameterError`.

Here the mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
default process group, one rank a mesh position, its ``mesh_dim_names``
the layout's :attr:`MeshLayout.axis_names` in order
(:meth:`MeshLayout.build_mesh`).  A spec is a plain tuple, one entry per
dimension of the leaf: None, an axis name, or a tuple of names, equal
entry for entry to the reference's ``PartitionSpec``.  A dimension split
over several axes is split major-first in the tuple's order (the
reference's row-major device order): under ``(fsdp, tp)`` rank ``(f, t)``
holds block ``f * tp + t``.  :func:`assign_shardings` gives the same
placement as DTensor placements, one per mesh dimension; two ``Shard(0)``
on the fsdp and tp dimensions split dim 0 in mesh-dimension order, which
is that block order.

What the axes mean (``parallel/sharding.py`` ``LayoutSharding`` runs
them): ``data`` splits the batch and replicates the parameters; ``fsdp``
splits the batch too and keeps each leaf's 1/n shard, gathered at use;
``tp`` replicates the batch, and a tp-split Linear or attention layer
computes its own slice of the output features; ``pipe`` and ``expert``
shard the stacked stage and expert tables.  A layout with pipe = expert
= 1 builds the 3-axis ``(data, fsdp, tp)`` mesh; any other the 5-axis
one, its one-wide axes present so that specs may name them.

``BIGDL_TORCH_FSDP_MIN_SIZE`` (4096, the reference's
``BIGDL_TPU_FSDP_MIN_SIZE``): leaves of fewer elements stay replicated
(no min-size gate on ``kv_cache``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

from ..utils import config as _config

__all__ = ["MeshLayout", "UnannotatedParameterError", "MeshReformError",
           "assign_specs", "assign_shardings", "role_tree", "ROLES",
           "fsdp_min_size"]

#: canonical axis names, in mesh order
DATA_AXIS = "data"
FSDP_AXIS = "fsdp"
TP_AXIS = "tp"
PIPE_AXIS = "pipe"
EXPERT_AXIS = "expert"

#: role -> (tp axis index, fsdp axis index) into the leaf's shape; None:
#: the role never uses that mesh axis; negative indices count from the
#: end.  ``embedding_row``, ``pipeline_stage``, ``expert_table`` and
#: ``kv_cache`` are special cases of :meth:`MeshLayout.spec_for`.
ROLES: Dict[str, Tuple[Optional[int], Optional[int]]] = {
    # out-major kernels, Linear's (out, in): tp splits the output
    # features, fsdp the trailing axis
    "kernel_out": (0, -1),
    # in-major kernels, the attention and RNN (in, out): tp on the
    # trailing output axis, fsdp on the axis before it
    "kernel_in": (-1, -2),
    # (.., cin, cout) conv kernels: tp on cout, fsdp on cin
    "conv_kernel": (-1, -2),
    # (vocab, emb) tables: rows over fsdp x tp together
    "embedding_row": (None, 0),
    # small per-feature vectors: replicated everywhere
    "bias": (None, None),
    "norm_scale": (None, None),
    "elementwise": (None, None),
    "scalar": (None, None),
    # stacked per-stage params [n_stages, ...]: the leading axis over pipe
    "pipeline_stage": (None, None),
    # stacked per-expert tables [E, ...]: the leading axis over expert,
    # fsdp on the largest free axis
    "expert_table": (None, None),
    # decode caches [slots, heads, cache_len, head_dim]: slots over
    # data x fsdp like batch rows, heads over tp like the q/k/v kernels
    "kv_cache": (None, None),
}


class UnannotatedParameterError(TypeError):
    """A parameter leaf reached the layout assigner without a declared
    role: its module neither sets ``PARAM_ROLES`` nor overrides
    ``param_roles()``.  Loud on purpose: a silently replicated leaf
    defeats the memory claim of FSDP and TP."""


class MeshReformError(RuntimeError):
    """An elastic re-form cannot keep the layout's ``fsdp x tp`` (x pipe
    x expert) block intact over the new rank count (not a multiple of
    the non-data block), or the mesh has no ``data`` axis to resize."""


def fsdp_min_size() -> int:
    """``BIGDL_TORCH_FSDP_MIN_SIZE``: leaves of fewer elements stay
    replicated instead of fsdp-sharded."""
    return _config.get_int("FSDP_MIN_SIZE", 2 ** 12)


def _dim_names(mesh) -> Tuple[str, ...]:
    return tuple(getattr(mesh, "mesh_dim_names", None) or ())


@dataclass(frozen=True)
class MeshLayout:
    """Axis sizes of the canonical ``data x fsdp x tp x pipe x expert``
    mesh (module docstring)."""

    data: int = 1
    fsdp: int = 1
    tp: int = 1
    pipe: int = 1
    expert: int = 1

    AXES = (DATA_AXIS, FSDP_AXIS, TP_AXIS, PIPE_AXIS, EXPERT_AXIS)
    LEGACY_AXES = (DATA_AXIS, FSDP_AXIS, TP_AXIS)

    @property
    def sizes(self) -> Tuple[int, ...]:
        """Sizes matching :attr:`axis_names` (3-tuple at pipe = expert =
        1, else all five)."""
        if self.pipe == 1 and self.expert == 1:
            return (self.data, self.fsdp, self.tp)
        return (self.data, self.fsdp, self.tp, self.pipe, self.expert)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.LEGACY_AXES if len(self.sizes) == 3 else self.AXES

    @property
    def size(self) -> int:
        return self.data * self.fsdp * self.tp * self.pipe * self.expert

    def __post_init__(self):
        if min(self.data, self.fsdp, self.tp, self.pipe, self.expert) < 1:
            raise ValueError(f"MeshLayout axis sizes must be >= 1: {self}")

    def shape(self) -> Dict[str, int]:
        """{axis name: size} in mesh order (the Engine's ``mesh_shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    @classmethod
    def parse(cls, text: str) -> "MeshLayout":
        """'2,2,1' or '1x2x2' (data, fsdp, tp), or 5 ints (with pipe and
        expert) -> MeshLayout."""
        parts = [int(p) for p in str(text).replace("x", ",").split(",")]
        if len(parts) not in (3, 5):
            raise ValueError(
                f"layout {text!r}: expected 'data,fsdp,tp' (3 ints) or "
                "'data,fsdp,tp,pipe,expert' (5 ints)")
        return cls(*parts)

    @classmethod
    def of_mesh(cls, mesh) -> Optional["MeshLayout"]:
        """The layout of a mesh whose dimension names are the canonical
        triple or quintuple; None for any other mesh (or object)."""
        names = _dim_names(mesh)
        if names not in (cls.AXES, cls.LEGACY_AXES):
            return None
        return cls(*(int(s) for s in mesh.shape))

    def build_mesh(self, devices: Optional[Sequence[int]] = None):
        """The ``DeviceMesh`` of the ranks ``devices`` of the default
        process group (default: every rank; one device a rank), the first
        :attr:`size` of them reshaped to :attr:`sizes` (row-major), on the
        Engine's device type, registered with the Engine
        (``Engine.register_mesh``: its axis groups and lead group).
        Collective: every rank of the world builds it, members or not, in
        the same order as every other mesh.  Fewer ranks than :attr:`size`
        raise ``ValueError``."""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        from ..utils.engine import Engine
        if devices is None:
            devices = range(dist.get_world_size()
                            if dist.is_initialized() else 1)
        ranks = [int(r) for r in devices]
        if len(ranks) < self.size:
            raise ValueError(f"MeshLayout {self.sizes} needs {self.size} "
                             f"ranks, have {len(ranks)}")
        device = Engine.device()
        kind = device.type if device is not None else "cpu"
        mesh = DeviceMesh(kind, torch.tensor(ranks[:self.size]).reshape(
            self.sizes), mesh_dim_names=self.axis_names)
        Engine.register_mesh(mesh)
        return mesh

    def install(self, devices: Optional[Sequence[int]] = None, device=None,
                backend: Optional[str] = None):
        """Make this layout's mesh the Engine's: ``Engine.init(mesh_shape=
        ...)`` on ``device`` over ``backend`` where no group is formed yet,
        else the mesh built over ``devices`` (the ranks) and set with
        ``Engine.set_mesh``.  Returns the mesh."""
        from ..utils.engine import Engine
        if Engine.device() is None:
            return Engine.init(device=device, backend=backend,
                               mesh_shape=self.shape())
        mesh = self.build_mesh(devices)
        Engine.set_mesh(mesh)
        return mesh

    # -- spec resolution ------------------------------------------------

    def batch_spec(self) -> tuple:
        """Batch rows split over data x fsdp; tp, pipe and expert
        replicate the batch."""
        return ((DATA_AXIS, FSDP_AXIS),)

    def spec_for(self, role: str, shape: Sequence[int],
                 min_size: Optional[int] = None) -> tuple:
        """The spec of one leaf: the role's table entry, each axis that
        does not divide its dimension dropped (the reference's
        ``spec_for``, entry for entry)."""
        if role not in ROLES:
            raise KeyError(
                f"unknown parameter role {role!r}; known roles: "
                f"{sorted(ROLES)} (extend parallel/layout.ROLES)")
        shape = tuple(int(d) for d in shape)
        ndim = len(shape)
        size = math.prod(shape) if shape else 1
        if min_size is None:
            min_size = fsdp_min_size()
        parts: list = [None] * ndim

        def norm(ax: Optional[int]) -> Optional[int]:
            if ax is None or ndim == 0:
                return None
            ax = ax if ax >= 0 else ndim + ax
            return ax if 0 <= ax < ndim else None

        tp_ax, fsdp_ax = ROLES[role]
        if role == "pipeline_stage" and ndim >= 1:
            if self.pipe > 1 and shape[0] % self.pipe == 0:
                parts[0] = PIPE_AXIS
            return tuple(parts)
        if role == "expert_table" and ndim >= 1:
            if self.expert > 1 and shape[0] % self.expert == 0 and \
                    size >= min_size:
                parts[0] = EXPERT_AXIS
            if self.fsdp > 1 and size >= min_size:
                for ax in sorted(range(ndim), key=lambda i: -shape[i]):
                    if parts[ax] is None and shape[ax] % self.fsdp == 0:
                        parts[ax] = FSDP_AXIS
                        break
            return tuple(parts)
        if role == "kv_cache" and ndim >= 2:
            if self.data * self.fsdp > 1:
                if shape[0] % (self.data * self.fsdp) == 0:
                    parts[0] = (DATA_AXIS, FSDP_AXIS)
                elif self.data > 1 and shape[0] % self.data == 0:
                    parts[0] = DATA_AXIS
                elif self.fsdp > 1 and shape[0] % self.fsdp == 0:
                    parts[0] = FSDP_AXIS
            if self.tp > 1 and shape[1] % self.tp == 0:
                parts[1] = TP_AXIS
            return tuple(parts)
        if role == "embedding_row" and ndim >= 1:
            if self.fsdp * self.tp > 1 and size >= min_size:
                if self.expert > 1 and \
                        shape[0] % (self.fsdp * self.tp * self.expert) == 0:
                    parts[0] = (FSDP_AXIS, TP_AXIS, EXPERT_AXIS)
                elif shape[0] % (self.fsdp * self.tp) == 0:
                    parts[0] = (FSDP_AXIS, TP_AXIS)
                elif shape[0] % self.fsdp == 0 and self.fsdp > 1:
                    parts[0] = FSDP_AXIS
                elif shape[0] % self.tp == 0 and self.tp > 1:
                    parts[0] = TP_AXIS
            return tuple(parts)
        tp_ax = norm(tp_ax)
        if tp_ax is not None and self.tp > 1 and \
                shape[tp_ax] % self.tp == 0 and size >= min_size:
            parts[tp_ax] = TP_AXIS
        # roles without a designated fsdp axis replicate by contract; a
        # kernel whose designated axis does not divide falls back to the
        # largest free axis that does
        if fsdp_ax is not None and self.fsdp > 1 and size >= min_size:
            fsdp_ax = norm(fsdp_ax)
            candidates = ([fsdp_ax] if fsdp_ax is not None else []) + \
                sorted(range(ndim), key=lambda i: -shape[i])
            for ax in candidates:
                if parts[ax] is None and shape[ax] % self.fsdp == 0:
                    parts[ax] = FSDP_AXIS
                    break
        return tuple(parts)


# ---------------------------------------------------------------------------
# the role assigner: module tree -> role tree -> spec tree
# ---------------------------------------------------------------------------

def _leaf_roles(mod, sub, path):
    """``sub`` (a leaf module's dict of leaves, possibly nested) with the
    role of every leaf, by its innermost name; ``"*"`` is a wildcard."""
    from ..utils.convert import whole_shape
    roles = mod.param_roles() if hasattr(mod, "param_roles") else None

    def walk(t, name, p):
        if isinstance(t, dict):
            return {k: walk(v, k, p + [k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v, name, p + [i]) for i, v in enumerate(t)]
        if roles is not None:
            if name in roles:
                return roles[name]
            if "*" in roles:
                return roles["*"]
        raise UnannotatedParameterError(
            f"{type(mod).__name__} parameter {name or p!r} (shape "
            f"{whole_shape(t)}) has no declared role: set PARAM_ROLES on "
            "the module class (e.g. {'weight': 'kernel_out', 'bias': "
            "'bias'}) or override param_roles(). Refusing to guess: a "
            "silently replicated leaf defeats the FSDP/TP memory claim.")
    return walk(sub, "", path)


def role_tree(module, params=None):
    """The reference-shaped tree of ``params`` (default: the module's own,
    ``utils/convert.py``'s tree) with the role of every leaf.  The walk
    follows ``Container.layers`` (``tree_children`` where the tree is a
    dict); a pipeline's stacked tree takes its own roles (``"*"``)."""
    from ..nn.module import Container
    from ..utils.convert import _param_tree, _stacked
    if params is None:
        params = _param_tree(module, getattr)

    def walk(mod, p, path):
        if isinstance(mod, Container) and not _stacked(mod):
            kids = mod.tree_children()
            if mod.TREE_KEYS is None and isinstance(p, (list, tuple)) \
                    and len(p) == len(kids):
                return [walk(c, cp, path + [i])
                        for (i, c), cp in zip(kids, p)]
            if mod.TREE_KEYS is not None and isinstance(p, dict):
                return {k: walk(c, p[k], path + [k]) for k, c in kids}
        return _leaf_roles(mod, p, path)
    return walk(module, params, [])


def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return [_tree_map(fn, *(x[i] for x in trees)) for i in range(len(t))]
    return fn(*trees)


def assign_specs(module, params=None, layout: Optional[MeshLayout] = None,
                 min_size: Optional[int] = None):
    """The params-shaped tree of specs (the role table applied to each
    leaf's whole shape); ``params`` defaults to the module's own tree."""
    from ..utils.convert import _param_tree, whole_shape
    if layout is None:
        raise ValueError("assign_specs: a MeshLayout is needed")
    if params is None:
        params = _param_tree(module, getattr)
    roles = role_tree(module, params)
    return _tree_map(lambda leaf, role: layout.spec_for(
        role, whole_shape(leaf), min_size=min_size), params, roles)


def placements(spec: tuple, names: Sequence[str]) -> tuple:
    """DTensor placements (one per mesh dimension ``names``) of a spec:
    ``Shard(d)`` on each mesh dimension that splits leaf dimension d,
    ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in ((entry,) if isinstance(entry, str) else entry or ()):
            out[list(names).index(a)] = Shard(d)
    return tuple(out)


def assign_shardings(module, params=None, mesh=None,
                     layout: Optional[MeshLayout] = None,
                     min_size: Optional[int] = None):
    """The params-shaped tree of DTensor placements over ``mesh`` (default:
    the Engine's).  The layout is read off the mesh's canonical axes
    where not given; a mesh without them replicates every leaf."""
    from ..utils.convert import _param_tree
    if mesh is None:
        from ..utils.engine import Engine
        mesh = Engine.mesh()
    names = _dim_names(mesh)
    if params is None:
        params = _param_tree(module, getattr)
    if layout is None:
        layout = MeshLayout.of_mesh(mesh)
    if layout is None:
        from torch.distributed.tensor import Replicate
        rep = tuple(Replicate() for _ in names)
        return _tree_map(lambda _: rep, params)
    specs = assign_specs(module, params, layout, min_size=min_size)
    return _tree_map(lambda _, s: placements(s, names), params, specs)
