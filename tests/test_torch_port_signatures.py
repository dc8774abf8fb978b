"""Parameter lists of the port against the JAX package's.

For every public callable that both packages define (a module's function,
a class's ``__init__`` and its public methods, matched by module path and
name), a call written for the reference must mean the same in the port:

- the reference's positional parameters are a prefix of the port's (the
  port may add its own, ``device`` say, only after them);
- every keyword-only parameter of the reference is accepted by the port;
- a port callable that takes ``*args`` (one that raises, naming the
  ROADMAP item that ports it) accepts any call.

The reference's parameters that name JAX machinery with no torch
counterpart are left out before comparing where the port does not take
them (``EXEMPT``), ``rng`` reads as the port's ``generator``
(``ALIASES``), and ``WAIVED`` lists per callable the parameters of work
not ported yet, each with its ROADMAP item, and the functions whose tree
arguments are the port's tensor lists.
"""

import importlib
import inspect
import pkgutil

import pytest

import bigdl_torch

#: JAX-only parameters, dropped from the reference's lists where the port
#: does not take them
EXEMPT = {
    "mesh", "rng", "interpret", "block_r", "axis_name", "constraint",
    "expert_k", "expert_axis",
    # the reference's functional param tree: a port module owns its
    # parameters (``Cell.step(params, x_t, hidden)`` -> ``step(x_t,
    # hidden)``)
    "params",
    # a Pallas-or-jnp route switch: the port routes by the tensor's device
    "use_pallas",
}

#: the reference's name -> the port's, at the same position
ALIASES = {"rng": "generator"}

_ALL = "*"

#: callable -> (the reference's parameters the port does not take yet, or
#: ``_ALL``, and why)
WAIVED = {
    # tree-of-tensor-list functions: the reference takes pytrees, the
    # port lists of tensors in ``model.parameters()`` order
    "optim.fused:fuse": (_ALL, "tree of tensors"),
    "optim.regularizer:apply_regularizer_grads": (_ALL, "tree of tensors"),
    "parallel.wire:bucket_count": (_ALL, "tree of tensors"),
    "parallel.sharding:ShardingStrategy.opt_state_sharding": (
        _ALL, "tree of tensors and its JAX shardings"),
    "parallel.wire:measure_collective_seconds": ({"axis"},
                                                 "a JAX mesh axis"),
    # the JAX key has no torch counterpart: the port's first argument is
    # the device (an entry point runs on the CUDA device unless given one)
    "nn.module:Module.build": ({"rng"}, "the device comes first"),
    # the JAX mesh and runtime: the port's group comes from the
    # BIGDL_TORCH_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID contract
    "utils.engine:Engine.init": (_ALL, "JAX mesh and runtime"),
    "utils.engine:Engine.init_distributed": (_ALL, "JAX runtime"),
    "utils.engine:Engine.data_shard_info": (_ALL, "a JAX mesh axis"),
}

_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY,
               inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _pairs():
    """(key, port callable, reference callable) of every public callable
    that both packages define."""
    out = []
    for info in pkgutil.walk_packages(bigdl_torch.__path__, "bigdl_torch."):
        port = importlib.import_module(info.name)
        rel = info.name[len("bigdl_torch."):]
        try:
            ref = importlib.import_module("bigdl_tpu." + rel)
        except ImportError:
            continue
        for name, pobj in vars(port).items():
            if name.startswith("_") or \
                    getattr(pobj, "__module__", None) != port.__name__:
                continue
            robj = getattr(ref, name, None)
            if robj is None:
                continue
            if inspect.isclass(pobj) and inspect.isclass(robj):
                for attr in sorted(set(vars(pobj)) | {"__init__"}):
                    if attr.startswith("_") and attr != "__init__":
                        continue
                    pa, ra = getattr(pobj, attr, None), getattr(robj, attr,
                                                                None)
                    if callable(pa) and callable(ra):
                        out.append((f"{rel}:{name}.{attr}", pa, ra))
            elif callable(pobj) and callable(robj):
                out.append((f"{rel}:{name}", pobj, robj))
    return out


PAIRS = _pairs()


def _signature(fn):
    try:
        return inspect.signature(fn)
    except (TypeError, ValueError):
        return None


def mismatch(key, port_fn, ref_fn):
    """None where a call written for the reference means the same in the
    port, else why not."""
    ps, rs = _signature(port_fn), _signature(ref_fn)
    if ps is None or rs is None or key.endswith(".forward"):
        # ``forward`` is torch.nn.Module's, whose one argument every
        # caller passes by position (``module(x)``)
        return None
    pparams = list(ps.parameters.values())
    if any(p.kind == p.VAR_POSITIONAL for p in pparams):
        return None
    waived, _ = WAIVED.get(key, (set(), ""))
    if waived == _ALL:
        return None
    drop = (EXEMPT - {p.name for p in pparams}) | set(waived)

    def keep(p):
        return p.name not in drop or (p.name in ALIASES
                                      and p.name not in waived)

    ref_pos = [ALIASES.get(p.name, p.name) for p in rs.parameters.values()
               if p.kind in _POSITIONAL and keep(p)]
    port_pos = [p.name for p in pparams if p.kind in _POSITIONAL]
    if port_pos[:len(ref_pos)] != ref_pos:
        return f"positional: reference {ref_pos}, port {port_pos}"
    ref_kw = {ALIASES.get(p.name, p.name) for p in rs.parameters.values()
              if p.kind == p.KEYWORD_ONLY and keep(p)}
    missing = ref_kw - {p.name for p in pparams}
    if missing and not any(p.kind == p.VAR_KEYWORD for p in pparams):
        return f"keyword-only {sorted(missing)} missing"
    return None


def test_pairs_cover_the_port():
    """The scan reaches the modules this slice changed."""
    keys = {k for k, _, _ in PAIRS}
    for k in ("optim.optimizer:Optimizer.__init__",
              "optim.optimizer:Predictor.predict",
              "nn.embedding:LookupTable.__init__",
              "dataset.prefetch:PrefetchIterator.__init__",
              "dataset:DistributedDataSet.__init__",
              "nn.recurrent:LSTM.__init__",
              "nn.criterion:MultiMarginCriterion.__init__",
              # slice 17: the rest of the layer library and its zoo
              "nn.conv:SpatialFullConvolution.__init__",
              "nn.conv:SpatialConvolutionMap.random",
              "nn.conv:VolumetricConvolution.__init__",
              "nn.normalization:SpatialDivisiveNormalization.__init__",
              "nn.pooling:RoiPooling.__init__",
              "nn.recurrent:ConvLSTMPeephole.__init__",
              "nn.recurrent:ConvLSTMPeephole.init_hidden",
              "nn.graph:Graph.__init__", "nn.graph:Input",
              "nn.tree:BinaryTreeLSTM.__init__", "nn.detection:nms",
              "utils.graph:DirectedGraph.topology_sort",
              "models.inception:Inception_Layer_v2",
              "models.textclassifier:TextClassifier",
              "models.treelstm_sentiment:encode_tree",
              "models.vgg:VggForCifar10", "models.alexnet:AlexNet",
              # the zoo's last models and the data half
              "models.vit:ViT", "models.widedeep:WideDeep.__init__",
              "models.widedeep:WideDeep.from_spec",
              "dataset.recsys:FeatureSpec.__init__",
              "dataset.recsys:hash_bucket", "dataset.recsys:cross_bucket",
              "dataset.recsys:synthetic_criteo_records",
              "dataset.recsys:write_criteo_shards",
              "dataset.text:Dictionary.__init__",
              "dataset.text:LabeledSentenceToSample.__init__",
              "dataset.providers:load_mnist",
              "dataset.providers:load_labeled_text_dir",
              "dataset.providers:fetch_file",
              "dataset.seqfile:write_seq_file",
              "dataset.seqfile:read_byte_records",
              "dataset.seqfile:SeqFileDataSet.__init__",
              "dataset.seqfile:seq_file_folder",
              "dataset:DataSet.seq_file_folder",
              "quantize:quantize_array", "quantize:quantize",
              "quantize:QuantLinear.__init__",
              "quantize:QuantSpatialConvolution.__init__",
              "quantize:QuantLookupTable.__init__",
              "serve.batcher:predict_in_fixed_batches",
              "serving:UDFPredictor.__init__",
              "serving:TextClassifierUDF.__init__",
              "ml:DLEstimator.__init__", "ml:DLEstimator.fit",
              "ml:DLModel.__init__", "ml:DLClassifierModel.score",
              "tools.perf:run", "tools.record_generator:convert_seq"):
        assert k in keys, k
    assert len(PAIRS) > 300


@pytest.mark.parametrize("key", sorted(WAIVED))
def test_waivers_are_live(key):
    """Every waiver names a callable both packages define."""
    assert key in {k for k, _, _ in PAIRS}, key


@pytest.mark.parametrize("module", sorted({k.split(":")[0] for k, _, _ in
                                           PAIRS}))
def test_parameter_lists_match_reference(module):
    bad = [f"{k}: {why}" for k, p, r in PAIRS if k.split(":")[0] == module
           for why in [mismatch(k, p, r)] if why]
    assert not bad, "\n".join(bad)


def test_reference_calls_mean_the_same():
    """The calls of ROADMAP queue C's fault, written for the reference."""
    import numpy as np
    import torch

    import bigdl_torch.nn as tnn
    from bigdl_torch.optim import Optimizer
    from bigdl_torch.parallel import DataParallel
    from bigdl_torch.dataset import Sample
    # the sixth is should_scale_grad_by_freq (ignored), not one_based
    m = tnn.LookupTable(5, 3, None, None, 2.0, True).build("cpu")
    assert not m.one_based
    out = m(torch.tensor([[0, 4]]))
    assert torch.equal(out[0, 0], m.weight[0])
    # a strategy in sixth place is the strategy: without the Engine's
    # group it is refused as one, not read as a device
    samples = [Sample(np.zeros(4, np.float32), np.float32(0))] * 2
    with pytest.raises(RuntimeError, match="data group"):
        Optimizer(tnn.Linear(4, 2), samples, tnn.CrossEntropyCriterion(),
                  2, None, DataParallel())
