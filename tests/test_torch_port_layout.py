"""The mesh layouts' tables (``bigdl_torch/parallel/layout.py``) against the
JAX package's (``bigdl_tpu/parallel/layout.py``).

- ``MeshLayout.parse``, ``sizes``, ``axis_names`` and ``size`` equal to
  the reference's.
- ``spec_for`` equal to the reference's ``PartitionSpec`` entry for
  entry over a grid: every role of ``ROLES``; shapes of 0 to 4 dims with
  and without divisible axes; layouts from (1,1,1) to (2,2,2), 5-axis
  ones with pipe or expert of 2, and wider ones; ``min_size`` 0, the
  default and large; ``batch_spec`` and the knob.
- ``role_tree`` of the zoo's eight models (LeNet-5, ResNet-50,
  Inception-v1, the PTB LSTM, Wide & Deep, ViT, ``transformer_lm`` and
  its MoE variant) equal to the reference's leaf for leaf: the
  reference's walk over the port's reference-shaped tree.
- ``assign_specs`` and ``assign_shardings`` (DTensor placements, two
  ``Shard(0)`` where a dim splits over fsdp and tp).
- ``UnannotatedParameterError`` (a ``TypeError``, the reference's
  message) and the ``"*"`` wildcard.
- The Engine's mesh kinds: what forms a layout mesh and what still
  raises; ``MeshReformError``'s cases on a stand-in multi-axis mesh.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

import bigdl_tpu.nn as jnn
from bigdl_tpu.parallel import layout as jlay

import bigdl_torch.nn as tnn
from bigdl_torch.parallel import layout as tlay
from bigdl_torch.utils.convert import to_reference_tree
from bigdl_torch.utils.engine import Engine

LAYOUTS = [(d, f, t) for d in (1, 2) for f in (1, 2) for t in (1, 2)] + [
    (1, 1, 1, 2, 1), (1, 2, 1, 2, 1), (1, 1, 1, 1, 2), (1, 2, 2, 1, 2),
    (2, 1, 2, 1, 2), (4, 1, 1), (1, 4, 1), (1, 1, 4), (2, 4, 1),
    (1, 2, 4), (3, 2, 1), (1, 3, 3)]
SHAPES = [(), (7,), (8,), (6,), (64, 32), (63, 32), (64, 31), (33, 35),
          (8, 6, 4), (3, 3, 16, 32), (3, 3, 15, 33), (16, 8, 4, 2),
          (32000, 512), (4096, 1), (2, 4096), (4, 8, 512, 64),
          (6, 3, 9, 64), (8, 6, 10, 4), (12, 2048)]
MIN_SIZES = [0, None, 10 ** 9, 100]


def _spec(p) -> tuple:
    return tuple(p)


@pytest.mark.parametrize("text", ["2,2,1", "1x2x2", "1,1,1,2,1",
                                  "2x1x2x1x2", "4,1,1"])
def test_parse_sizes_axis_names(text):
    j, t = jlay.MeshLayout.parse(text), tlay.MeshLayout.parse(text)
    assert (t.data, t.fsdp, t.tp, t.pipe, t.expert) == (
        j.data, j.fsdp, j.tp, j.pipe, j.expert)
    assert t.sizes == j.sizes and t.axis_names == tuple(j.axis_names)
    assert t.size == j.size
    assert list(t.shape()) == list(t.axis_names)


def test_parse_and_sizes_refuse_as_the_reference():
    for bad in ("1,2", "1,2,3,4"):
        with pytest.raises(ValueError):
            jlay.MeshLayout.parse(bad)
        with pytest.raises(ValueError, match="3 ints"):
            tlay.MeshLayout.parse(bad)
    with pytest.raises(ValueError):
        tlay.MeshLayout(0, 1, 1)
    assert tlay.MeshLayout.of_mesh(object()) is None
    assert sorted(tlay.ROLES) == sorted(jlay.ROLES)
    assert tlay.ROLES == jlay.ROLES


@pytest.mark.parametrize("role", sorted(jlay.ROLES))
@pytest.mark.parametrize("sizes", LAYOUTS,
                         ids=["x".join(map(str, s)) for s in LAYOUTS])
def test_spec_for_equals_reference(sizes, role):
    j, t = jlay.MeshLayout(*sizes), tlay.MeshLayout(*sizes)
    for shape in SHAPES:
        for m in MIN_SIZES:
            want = _spec(j.spec_for(role, shape, min_size=m))
            got = t.spec_for(role, shape, min_size=m)
            assert got == want, (sizes, role, shape, m, got, want)
            assert isinstance(got, tuple) and len(got) == len(shape)


def test_spec_for_unknown_role_and_knob(monkeypatch):
    with pytest.raises(KeyError, match="unknown parameter role"):
        tlay.MeshLayout(1, 2, 2).spec_for("kernel", (4, 4))
    assert tlay.fsdp_min_size() == jlay.fsdp_min_size() == 4096
    monkeypatch.setenv("BIGDL_TORCH_FSDP_MIN_SIZE", "10")
    assert tlay.fsdp_min_size() == 10
    lay = tlay.MeshLayout(1, 2, 1)
    assert lay.spec_for("kernel_out", (4, 4)) == (None, "fsdp")
    assert lay.batch_spec() == _spec(jlay.MeshLayout(1, 2, 1).batch_spec())


def _zoo():
    """(name, port model, reference model) of the zoo's eight models; the
    port's built on the CPU, the reference's unbuilt (its walk reads the
    module tree and the roles only)."""
    from bigdl_tpu.dataset.recsys import FeatureSpec as JSpec
    from bigdl_tpu.models import inception as jinc
    from bigdl_tpu.models import lenet as jlenet
    from bigdl_tpu.models import resnet as jres
    from bigdl_tpu.models import rnn as jrnn
    from bigdl_tpu.models import transformer_lm as jlm
    from bigdl_tpu.models import vit as jvit
    from bigdl_tpu.models import widedeep as jwd

    from bigdl_torch.dataset.recsys import FeatureSpec as TSpec
    from bigdl_torch.models import inception as tinc
    from bigdl_torch.models import lenet as tlenet
    from bigdl_torch.models import resnet as tres
    from bigdl_torch.models import rnn as trnn
    from bigdl_torch.models import transformer_lm as tlm
    from bigdl_torch.models import vit as tvit
    from bigdl_torch.models import widedeep as twd
    vit = dict(image_size=16, patch_size=4, class_num=5, d_model=32,
               num_heads=2, num_layers=2)
    lm = dict(vocab_size=50, max_len=16, d_model=32, num_heads=4,
              num_layers=2)
    return [
        ("lenet5", lambda: tlenet.LeNet5(10), lambda: jlenet.LeNet5(10)),
        ("resnet50", lambda: tres.ResNet(50, class_num=1000,
                                         dataset="imagenet"),
         lambda: jres.ResNet(50, class_num=1000, dataset="imagenet")),
        ("inception_v1", lambda: tinc.Inception_v1(1000),
         lambda: jinc.Inception_v1(1000)),
        ("ptb_lstm", lambda: trnn.PTBModel(61, 12, 16),
         lambda: jrnn.PTBModel(61, 12, 16)),
        ("wide_deep", lambda: twd.WideDeep.from_spec(
            TSpec(), embed_dim=8, hidden=(16, 8)),
         lambda: jwd.WideDeep.from_spec(JSpec(), embed_dim=8,
                                        hidden=(16, 8))),
        ("vit", lambda: tvit.ViT(**vit), lambda: jvit.ViT(**vit)),
        ("transformer_lm", lambda: tlm.TransformerLM(**lm),
         lambda: jlm.TransformerLM(**lm)),
        ("transformer_moe", lambda: tlm.TransformerLM(**lm, num_experts=4),
         lambda: jlm.TransformerLM(**lm, num_experts=4))]


@pytest.mark.parametrize("name", [z[0] for z in _zoo()])
def test_role_tree_of_the_zoo_equals_reference(name):
    _, make_t, make_j = next(z for z in _zoo() if z[0] == name)
    tm = make_t().build("cpu", torch.Generator().manual_seed(0))
    params, _ = to_reference_tree(tm, fetch=lambda t: np.zeros(
        tuple(t.shape), np.float32))
    want = jlay.role_tree(make_j(), params)
    got = tlay.role_tree(tm)
    assert got == jax.tree.map(lambda r: r, want)
    assert jax.tree.leaves(got) and all(
        r in tlay.ROLES for r in jax.tree.leaves(got))
    # the specs of every leaf at a layout with every axis wide
    for sizes in ((1, 2, 2), (2, 2, 1)):
        jspecs = jlay.assign_specs(make_j(), params,
                                   jlay.MeshLayout(*sizes))
        tspecs = tlay.assign_specs(tm, None, tlay.MeshLayout(*sizes))
        flat_j = jax.tree.leaves(jspecs, is_leaf=lambda x: isinstance(x, P))
        flat_t = jax.tree.leaves(tspecs,
                                 is_leaf=lambda x: isinstance(x, tuple))
        assert [_spec(s) for s in flat_j] == flat_t


def test_bench_lm_local_elements_by_the_role_table():
    """The bench LM's 134 leaves (58,282,240 elements): a rank's elements
    under (1,2,2) and (2,2,1) by the reference's table, the port's the
    same."""
    from bigdl_tpu.models import transformer_lm as jlm

    from bigdl_torch.models import transformer_lm as tlm
    cfg = dict(vocab_size=32000, max_len=512, d_model=512, num_heads=8,
               num_layers=8)
    tm = tlm.TransformerLM(**cfg)
    with torch.device("meta"):
        tm._build(torch.Generator())
    params, _ = to_reference_tree(tm, fetch=lambda t: np.broadcast_to(
        np.float32(0), tuple(t.shape)))
    leaves = jax.tree.leaves(params)
    assert len(leaves) == 134 and sum(x.size for x in leaves) == 58282240
    for sizes, want in (((1, 2, 2), 14635264), ((2, 2, 1), 29184256)):
        local = []
        for which, lay in ((jlay, jlay.MeshLayout(*sizes)),
                           (tlay, tlay.MeshLayout(*sizes))):
            specs = which.assign_specs(jlm.TransformerLM(**cfg), params,
                                       lay) if which is jlay else \
                tlay.assign_specs(tm, params, lay)
            flat = jax.tree.leaves(
                specs, is_leaf=lambda x: isinstance(x, (P, tuple)))
            n = 0
            for x, s in zip(leaves, flat):
                div = 1
                for e in s:
                    for a in ((e,) if isinstance(e, str) else e or ()):
                        div *= lay.shape()[a] if which is tlay else \
                            dict(zip(lay.axis_names, lay.sizes))[a]
                n += x.size // div
            local.append(n)
        assert local == [want, want]


def test_assign_shardings_placements():
    from torch.distributed.tensor import Replicate, Shard
    names = ("data", "fsdp", "tp")
    assert tlay.placements((("fsdp", "tp"), None), names) == (
        Replicate(), Shard(0), Shard(0))
    assert tlay.placements((None, "fsdp"), names) == (
        Replicate(), Shard(1), Replicate())
    assert tlay.placements((), names) == (Replicate(),) * 3

    class Mesh:
        mesh_dim_names = names
        shape = (1, 2, 2)
    m = tnn.Sequential(tnn.LookupTable(64, 8),
                       tnn.Linear(8, 4)).build("cpu")
    got = tlay.assign_shardings(m, None, Mesh(), min_size=0)
    assert got == [{"weight": (Replicate(), Shard(0), Shard(0))},
                   {"weight": (Replicate(), Shard(1), Shard(0)),
                    "bias": (Replicate(),) * 3}]

    class Legacy:
        mesh_dim_names = ("model", "data")
        shape = (2, 2)
    assert tlay.assign_shardings(m, None, Legacy()) == [
        {"weight": (Replicate(),) * 2},
        {"weight": (Replicate(),) * 2, "bias": (Replicate(),) * 2}]


class _Bare(tnn.Module):
    def _init(self, generator):
        return {"w": torch.zeros((4, 4))}


class _Wild(tnn.Module):
    PARAM_ROLES = {"*": "elementwise", "w": "kernel_in"}

    def _init(self, generator):
        return {"w": torch.zeros((4, 4)), "extra": torch.zeros((4,))}


class _JBare(jnn.Module):
    """The reference's module without roles."""


def test_unannotated_parameter_and_wildcard():
    m = tnn.Sequential(tnn.Linear(4, 4), _Bare()).build("cpu")
    with pytest.raises(tlay.UnannotatedParameterError,
                       match="has no declared role") as e:
        tlay.role_tree(m)
    assert isinstance(e.value, TypeError) and "_Bare" in str(e.value)
    with pytest.raises(jlay.UnannotatedParameterError,
                       match="has no declared role"):
        jlay.role_tree(jnn.Sequential(jnn.Linear(4, 4), _JBare()),
                       [{"weight": np.zeros((4, 4)), "bias": np.zeros(4)},
                        {"w": np.zeros((4, 4))}])
    w = tnn.Sequential(_Wild()).build("cpu")
    assert tlay.role_tree(w) == [{"w": "kernel_in", "extra": "elementwise"}]
    assert tlay.assign_specs(w, None, tlay.MeshLayout(1, 2, 2),
                             min_size=0) == [{"w": ("fsdp", "tp"),
                                              "extra": (None,)}]


@pytest.mark.parametrize("shape,kind", [
    ({"data": 1, "fsdp": 2, "tp": 2}, "layout"),
    ({"data": 2, "fsdp": 2, "tp": 1}, "layout"),
    ({"tp": 4}, "layout"), ({"fsdp": 2, "pipe": 1, "expert": 1}, "layout"),
    ({"model": 2, "data": 2}, "legacy"), ({"data": 4}, "group"),
    ({"pipe": 2}, "axis"), ({"seq": 2}, "axis")])
def test_engine_mesh_kinds(shape, kind):
    got, arg = Engine._mesh_kind(shape)
    assert got == kind
    if kind == "layout":
        assert arg.shape() == tlay.MeshLayout(**shape).shape()


@pytest.mark.parametrize("shape,what", [
    ({"data": 2, "fsdp": 2, "pipe": 2}, "pipe"),
    ({"fsdp": 2, "expert": 2}, "expert"),
    ({"data": 2, "seq": 2}, "seq"), ({"tp": 2, "seq": 1}, "seq"),
    ({"model": 2, "tp": 2}, "model"), ({"rows": 2}, "rows")])
def test_engine_refuses_what_waits_for_the_rest(shape, what):
    """What still waits raises typed, naming item 8; the pipe and expert
    axes beside the batch axes and ``data x seq`` now pass the mesh check
    and, in one process, want their processes."""
    Engine.reset()
    n = int(np.prod(list(shape.values())))
    if what in ("pipe", "expert") or shape == {"data": 2, "seq": 2}:
        with pytest.raises(ValueError,
                           match=f"needs {n} processes") as e:
            Engine.init(device="cpu", mesh_shape=shape)
    else:
        with pytest.raises(NotImplementedError, match="item 8") as e:
            Engine.init(device="cpu", mesh_shape=shape)
    assert what in str(e.value)
    assert Engine.mesh() is None


class _StandIn:
    """A multi-axis mesh's names and shape, as ``Engine.reform`` reads
    them (a real one needs a process a position)."""

    def __init__(self, names, sizes):
        self.mesh_dim_names, self.shape = tuple(names), tuple(sizes)


@pytest.mark.parametrize("case", ["keeps_block", "block_breaks",
                                  "fewer_than_block", "no_data_axis"])
def test_mesh_reform_error_cases(case, monkeypatch):
    """tests/test_layout.py's three cases: a data axis resized with the
    fsdp x tp block intact; the typed error where the block cannot
    survive (a count it does not divide, fewer ranks than the block);
    the typed error without a data axis.  The port's live group then
    refuses to re-form in place (GroupReformError)."""
    from bigdl_torch.utils.engine import GroupReformError
    Engine.reset()
    names = ("fsdp", "tp") if case == "no_data_axis" else \
        ("data", "fsdp", "tp")
    sizes = (2, 2) if case == "no_data_axis" else (2, 2, 1)
    monkeypatch.setattr(Engine, "_mesh", _StandIn(names, sizes))
    if case == "keeps_block":
        assert Engine._reform_data_axis(2) == {"data": 1, "fsdp": 2,
                                               "tp": 1}
        monkeypatch.setenv("BIGDL_TORCH_NUM_PROCESSES", "4")
        with pytest.raises(GroupReformError):
            Engine.reform(world=2, rank=0, survivors=[0, 1])
        return
    n = {"block_breaks": 3, "fewer_than_block": 1, "no_data_axis": 2}[case]
    match = "no 'data' axis" if case == "no_data_axis" else \
        "shard groups intact"
    with pytest.raises(tlay.MeshReformError, match=match):
        Engine.reform(world=n, rank=0, survivors=list(range(n)))
