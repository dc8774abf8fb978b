"""The port's BigDL format for the sequence and embedding zoo against the
JAX package.

The cases of ``tests/test_bigdl_seq.py`` on the port: streams hand-built
in the reference's structure (``nn/RNN.scala:46-80``, ``nn/LSTM.scala:74-
184``, ``nn/GRU.scala:79-180``, ``nn/LSTMPeephole.scala``) load, and their
forwards meet the reference cell equations computed in numpy (1e-4
relative, 1e-5 absolute); every class of the zoo round-trips twice
(1e-4 and 1e-6); the canonical ``simple_rnn_canonical.bigdl`` fixture
meets its golden output (1e-5); a migrated SimpleRNN fine-tunes on the
CPU.  Weights come from numpy seeds; models are built from a seeded
generator on the CPU and loaded with ``device="cpu"``.

Beside them, the port is held to the JAX package on the canonical RNN:
the SimpleRNN shape given the reference's built weights, and the fixture
loaded by each package, are written by both as byte-identical streams,
each package loads the other's, and the eval forwards of one numpy batch
agree within 1e-5.
"""

import os
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_torch.nn as nn
import bigdl_tpu.nn as rnn
from bigdl_torch.interop import bigdl as bigdl_fmt
from bigdl_torch.interop.bigdl import _DescCache, _w_tensor, load_bytes
from bigdl_torch.interop.bigdl_seq import (_container,
                                           _hiddens_shape, _linear, _obj,
                                           _seq, _simple, _time_distributed)
from bigdl_torch.interop.javaser import JavaWriter
from bigdl_torch.utils.convert import load_reference_tree

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "interop",
                       "simple_rnn_canonical.bigdl")


def _rand(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(
        np.float32)


def _stream_bytes(root):
    from bigdl_torch.interop.bigdl import _fill_base_fields
    _fill_base_fields(root)  # inherited AbstractModule defaults
    w = JavaWriter()
    w.write_object(root)
    return w.getvalue()


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _forward(model, x):
    model.eval()
    with torch.no_grad():
        if isinstance(x, (tuple, list)):
            x = [torch.from_numpy(np.asarray(v)) for v in x]
        else:
            x = torch.from_numpy(np.asarray(x, np.float32))
        return model(x).numpy()


# ---------------------------------------------------------------------------
# the reader against the reference equations (hand-built streams)
# ---------------------------------------------------------------------------

def test_reader_rnncell_matches_reference_equations():
    I, H, B, T = 3, 4, 2, 5
    wi, bi = _rand((H, I), 0) * 0.3, _rand((H,), 1) * 0.1
    wh, bh = _rand((H, H), 2) * 0.3, _rand((H,), 3) * 0.1
    dc = _DescCache()
    pre = _time_distributed(dc, _linear(dc, wi, bi))
    h2h = _linear(dc, wh, bh)
    from bigdl_torch.interop.bigdl_seq import _parallel_table
    pt = _parallel_table(dc)  # structure placeholder (empty container)
    cell_seq = _seq(dc, pt, _obj(dc, "CAddTable", [], []),
                    _simple(dc, "Tanh"),
                    _simple(dc, "Identity"))
    topo = _obj(dc, "RnnCell", [],
                [("hiddensShape", "[I", _hiddens_shape(dc, [H])),
                 ("h2h", "Lx;", h2h), ("cell", "Lx;", cell_seq)])
    rec = _container(dc, "Recurrent", [pre, topo])
    model = load_bytes(_stream_bytes(rec), "cpu")

    x = _rand((B, T, I), 4)
    # reference recurrence: h_t = tanh(Wi x_t + bi + Wh h_{t-1} + bh)
    h = np.zeros((B, H), np.float32)
    expect = []
    for t in range(T):
        h = np.tanh(x[:, t] @ wi.T + bi + h @ wh.T + bh)
        expect.append(h)
    np.testing.assert_allclose(_forward(model, x), np.stack(expect, 1),
                               rtol=1e-4, atol=1e-5)


def test_reader_lstm_matches_reference_equations():
    """Gate chunk order on the wire is [input, gain(tanh), forget, output]
    (LSTM.scala:124-133); the reader permutes it into the port's."""
    I, H, B, T = 3, 4, 2, 4
    wi, bi = _rand((4 * H, I), 0) * 0.3, _rand((4 * H,), 1) * 0.1
    wh = _rand((4 * H, H), 2) * 0.3
    dc = _DescCache()
    pre = _time_distributed(dc, _linear(dc, wi, bi))
    cell_seq = _seq(dc, _linear(dc, wh, None))  # h2g, found by subtree scan
    topo = _obj(dc, "LSTM",
                [("I", "inputSize", I), ("I", "hiddenSize", H),
                 ("D", "p", 0.0)],
                [("hiddensShape", "[I", _hiddens_shape(dc, [H, H])),
                 ("cell", "Lx;", cell_seq)])
    rec = _container(dc, "Recurrent", [pre, topo])
    model = load_bytes(_stream_bytes(rec), "cpu")

    x = _rand((B, T, I), 3)
    h = np.zeros((B, H), np.float32)
    c = np.zeros((B, H), np.float32)
    expect = []
    for t in range(T):
        pre_t = x[:, t] @ wi.T + bi + h @ wh.T
        ig = _sigmoid(pre_t[:, 0:H])            # input
        g = np.tanh(pre_t[:, H:2 * H])          # gain ("hidden")
        fg = _sigmoid(pre_t[:, 2 * H:3 * H])    # forget
        og = _sigmoid(pre_t[:, 3 * H:4 * H])    # output
        c = ig * g + fg * c
        h = og * np.tanh(c)
        expect.append(h)
    np.testing.assert_allclose(_forward(model, x), np.stack(expect, 1),
                               rtol=1e-4, atol=1e-5)


def test_reader_gru_matches_reference_equations():
    """The reference's h' = (1-z)*cand + z*h (GRU.scala:155-172); the
    port's h' = (1-u)*h + u*cand with u = 1-z: the z weights are negated
    on the way in, exactly."""
    I, O, B, T = 3, 4, 2, 4
    wi, bi = _rand((3 * O, I), 0) * 0.3, _rand((3 * O,), 1) * 0.1
    wh2g = _rand((2 * O, O), 2) * 0.3
    whh = _rand((O, O), 3) * 0.3
    dc = _DescCache()
    pre = _time_distributed(dc, _linear(dc, wi, bi))
    cell_seq = _seq(dc, _linear(dc, wh2g, None), _linear(dc, whh, None))
    topo = _obj(dc, "GRU",
                [("I", "inputSize", I), ("I", "outputSize", O),
                 ("D", "p", 0.0)],
                [("hiddensShape", "[I", _hiddens_shape(dc, [O])),
                 ("cell", "Lx;", cell_seq)])
    rec = _container(dc, "Recurrent", [pre, topo])
    model = load_bytes(_stream_bytes(rec), "cpu")

    x = _rand((B, T, I), 4)
    h = np.zeros((B, O), np.float32)
    expect = []
    for t in range(T):
        xt = x[:, t]
        r = _sigmoid(xt @ wi[:O].T + bi[:O] + h @ wh2g[:O].T)
        z = _sigmoid(xt @ wi[O:2 * O].T + bi[O:2 * O] + h @ wh2g[O:].T)
        cand = np.tanh(xt @ wi[2 * O:].T + bi[2 * O:] + (r * h) @ whh.T)
        h = (1 - z) * cand + z * h
        expect.append(h)
    np.testing.assert_allclose(_forward(model, x), np.stack(expect, 1),
                               rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# round trips
# ---------------------------------------------------------------------------

def _roundtrip(m, x, tmp_path, rtol=1e-4, atol=1e-5):
    m.build("cpu", torch.Generator().manual_seed(0))
    y0 = _forward(m, x)
    p = str(tmp_path / "model.bigdl")
    bigdl_fmt.save(m, p)
    m2 = bigdl_fmt.load(p, device="cpu")
    y1 = _forward(m2, x)
    np.testing.assert_allclose(y1, y0, rtol=rtol, atol=atol)
    # and a second generation: save(load(x)) is stable
    p2 = str(tmp_path / "model2.bigdl")
    bigdl_fmt.save(m2, p2)
    m3 = bigdl_fmt.load(p2, device="cpu")
    np.testing.assert_allclose(_forward(m3, x), y1, rtol=1e-6, atol=1e-6)
    return m2


@pytest.mark.parametrize("cell_ctor", [
    lambda: nn.RnnCell(6, 8),
    lambda: nn.LSTM(6, 8),
    lambda: nn.GRU(6, 8),
])
def test_recurrent_roundtrip(cell_ctor, tmp_path):
    m = nn.Sequential()
    m.add(nn.Recurrent(cell_ctor()))
    m.add(nn.TimeDistributed(nn.Linear(8, 5)))
    _roundtrip(m, _rand((3, 7, 6), 11), tmp_path)


def test_simple_rnn_migrates_and_fine_tunes(tmp_path):
    """The SimpleRNN shape (models/rnn/SimpleRNN.scala:29-31): through the
    wire format, then the migrated model fine-tunes and its loss drops."""
    from bigdl_torch.dataset import DataSet, Sample, SampleToMiniBatch
    from bigdl_torch.optim import SGD, Optimizer, Trigger

    I, H, O = 10, 12, 4
    m = nn.Sequential()
    m.add(nn.Recurrent(nn.RnnCell(I, H, torch.tanh)))
    m.add(nn.TimeDistributed(nn.Linear(H, O)))
    m.build("cpu", torch.Generator().manual_seed(1))
    p = str(tmp_path / "simple_rnn.bigdl")
    bigdl_fmt.save(m, p)
    model = bigdl_fmt.load(p, device="cpu")

    rng = np.random.RandomState(0)
    xs = rng.randn(64, 6, I).astype(np.float32)
    ys = (rng.rand(64, 6) * O).astype(np.int32)
    samples = [Sample(x, y) for x, y in zip(xs, ys)]
    ds = DataSet.array(samples).transform(
        SampleToMiniBatch(16, drop_last=True))
    crit = nn.TimeDistributedCriterion(nn.CrossEntropyCriterion())

    def loss_of(mdl):
        out = torch.from_numpy(_forward(mdl, xs))
        return float(crit.forward(out, torch.from_numpy(ys)))

    before = loss_of(model)
    opt = (Optimizer(model, ds, crit, device="cpu")
           .set_optim_method(SGD(learning_rate=0.05))
           .set_end_when(Trigger.max_epoch(3)))
    tuned = opt.optimize()
    assert loss_of(tuned) < before


def test_lookup_temporal_textclassifier_roundtrip(tmp_path):
    """The text classifier's front half: embedding + temporal conv."""
    m = nn.Sequential()
    m.add(nn.LookupTable(20, 8, one_based=True))
    m.add(nn.TemporalConvolution(8, 6, 3))
    m.add(nn.ReLU())
    x = np.random.RandomState(3).randint(1, 21, (2, 9)).astype(np.float32)
    _roundtrip(m, x, tmp_path)


def test_graph_dag_roundtrip(tmp_path):
    """A diamond DAG through the Node wire graph (utils/DirectedGraph.scala
    Node element/nexts/prevs; Graph.scala inputs/outputs)."""
    inp = nn.Input()
    h = nn.Linear(10, 16)(inp)
    a = nn.ReLU()(h)
    b = nn.Tanh()(h)
    out = nn.CAddTable()([a, b])
    m = nn.Graph(inp, out)
    m2 = _roundtrip(m, _rand((4, 10), 7), tmp_path)
    assert isinstance(m2, nn.Graph)
    assert len(m2.layers) == len(m.layers)


def test_unsupported_cell_variant_fails_loud(tmp_path):
    """A p != 0 LSTM restructures the reference graph (per-gate dropout
    stacks, no preTopology): refused, not mis-loaded."""
    dc = _DescCache()
    topo = _obj(dc, "LSTM",
                [("I", "inputSize", 3), ("I", "hiddenSize", 4),
                 ("D", "p", 0.25)],
                [("hiddensShape", "[I", _hiddens_shape(dc, [4, 4])),
                 ("cell", "Lx;", _seq(dc))])
    rec = _container(dc, "Recurrent", [topo])
    with pytest.raises(ValueError, match="p!=0|preTopology"):
        load_bytes(_stream_bytes(rec), "cpu")


@pytest.mark.parametrize("merge", ["sum", "concat"])
def test_birecurrent_roundtrip(merge, tmp_path):
    """BiRecurrent (BiRecurrent.scala:33): independent forward and reverse
    weights, CAddTable or JoinTable merge."""
    m = nn.Sequential()
    m.add(nn.BiRecurrent(nn.LSTM(5, 7), merge))
    m2 = _roundtrip(m, _rand((2, 6, 5), 13), tmp_path)
    bi = m2.layers[0]
    assert isinstance(bi, nn.BiRecurrent) and bi.merge == merge
    # the two directions' weights stay independent through the wire
    fwd_k = bi.layers[0].layers[0].kernel.detach().numpy()
    rev_k = bi.layers[1].layers[0].kernel.detach().numpy()
    assert not np.allclose(fwd_k, rev_k)


def test_frozen_canonical_fixture_loads_and_predicts():
    """A frozen stream of the JVM-canonical writer (super chains,
    AbstractModule base fields, JOS field order): the bytes are the
    contract."""
    raw = open(FIXTURE, "rb").read()
    assert struct.unpack(">HH", raw[:4]) == (0xACED, 5)
    assert b"com.intel.analytics.bigdl.nn.Recurrent" in raw
    assert b"abstractnn.AbstractModule" in raw      # real super chain
    assert b"com.intel.analytics.bigdl.nn.Container" in raw

    model = bigdl_fmt.load(FIXTURE, device="cpu")
    assert model.layers[0].layers[0].scale_w == 1.5  # base field survived
    x = np.fromfile(FIXTURE + ".x", dtype=np.float32).reshape(2, 5, 6)
    golden = np.fromfile(FIXTURE + ".y", dtype=np.float32).reshape(2, 5, 4)
    np.testing.assert_allclose(_forward(model, x), golden, rtol=1e-5,
                               atol=1e-5)


def test_lstmpeephole_roundtrip(tmp_path):
    """LSTMPeephole (LSTMPeephole.scala:50): gate chunks [i,f,g,o] keyed by
    Narrow offsets, CMul peephole weights."""
    m = nn.Sequential()
    m.add(nn.Recurrent(nn.LSTMPeephole(5, 7)))
    _roundtrip(m, _rand((2, 6, 5), 17), tmp_path)


def test_reader_lstmpeephole_matches_reference_equations():
    """A hand-built reference-structure stream -> the port's cell
    equations (chunk order [i, f, g, o], offsets 1, 1+H, 1+2H, 1+3H)."""
    from bigdl_torch.interop.bigdl_seq import _cadd, _parallel_table

    I, H, B, T = 3, 4, 2, 4
    wi, bi = _rand((4 * H, I), 0) * 0.3, _rand((4 * H,), 1) * 0.1
    whs = [_rand((H, H), 2 + c) * 0.3 for c in range(4)]
    peeps = {0: _rand((H,), 11) * 0.2, 1: _rand((H,), 12) * 0.2,
             3: _rand((H,), 13) * 0.2}
    dc = _DescCache()
    pre = _seq(dc, _obj(dc, "Dropout", [("D", "initP", 0.0)], []),
               _time_distributed(dc, _linear(dc, wi, bi)))

    def gate(chunk):
        members = [
            _obj(dc, "Narrow",
                 [("I", "dimension", 2), ("I", "offset", 1 + chunk * H),
                  ("I", "length", H)], []),
            _seq(dc, _linear(dc, whs[chunk], None)),
        ]
        if chunk in peeps:
            members.append(_obj(dc, "CMul", [],
                                [("weight", "Lx;",
                                  _w_tensor(dc, peeps[chunk]))]))
        return _seq(dc, _parallel_table(dc, *members), _cadd(dc, False),
                    _simple(dc, "Sigmoid" if chunk != 2 else "Tanh"))

    cell_seq = _seq(dc, gate(0), gate(1), gate(2), gate(3))
    topo = _obj(dc, "LSTMPeephole",
                [("I", "inputSize", I), ("I", "hiddenSize", H),
                 ("D", "p", 0.0)],
                [("cell", "Lx;", cell_seq)])
    topo.fields["hiddensShape"] = _hiddens_shape(dc, [H, H])
    rec = _container(dc, "Recurrent", [pre, topo])
    model = load_bytes(_stream_bytes(rec), "cpu")

    x = _rand((B, T, I), 4)
    h = np.zeros((B, H), np.float32)
    c = np.zeros((B, H), np.float32)
    expect = []
    for t in range(T):
        pre_t = x[:, t] @ wi.T + bi
        i_pre = pre_t[:, 0:H] + h @ whs[0].T + peeps[0] * c
        f_pre = pre_t[:, H:2 * H] + h @ whs[1].T + peeps[1] * c
        g_pre = pre_t[:, 2 * H:3 * H] + h @ whs[2].T
        ig, fg = _sigmoid(i_pre), _sigmoid(f_pre)
        g = np.tanh(g_pre)
        c = fg * c + ig * g
        o_pre = pre_t[:, 3 * H:4 * H] + h @ whs[3].T + peeps[3] * c
        og = _sigmoid(o_pre)
        h = og * np.tanh(c)
        expect.append(h)
    np.testing.assert_allclose(_forward(model, x), np.stack(expect, 1),
                               rtol=1e-4, atol=1e-5)


def _trees():
    inputs = _rand((2, 3, 6), 21)
    children = np.tile(np.array([[-1, -1], [-1, -1], [0, 1], [-1, -1]],
                                np.int32), (2, 1, 1))
    leaf_ids = np.tile(np.array([0, 1, -1, -1], np.int32), (2, 1))
    return inputs, children, leaf_ids


def test_binarytreelstm_roundtrip(tmp_path):
    """BinaryTreeLSTM (BinaryTreeLSTM.scala:36, withGraph=true): the ten
    composer gate Linears re-home into the fused (2H, 5H) kernel by their
    role in the graph, and back out into the reference-shaped leaf and
    composer Graphs."""
    m = nn.Sequential()
    m.add(nn.BinaryTreeLSTM(6, 5))
    m.build("cpu", torch.Generator().manual_seed(3))
    x = _trees()
    y0 = _forward(m, x)

    p = str(tmp_path / "tree.bigdl")
    bigdl_fmt.save(m, p)
    raw = open(p, "rb").read()
    assert b"BinaryTreeLSTM" in raw and b"TreeLSTM" in raw
    m2 = bigdl_fmt.load(p, device="cpu")
    assert isinstance(m2.layers[0], nn.BinaryTreeLSTM)
    y1 = _forward(m2, x)
    np.testing.assert_allclose(y1, y0, rtol=1e-4, atol=1e-5)
    # second generation stability
    p2 = str(tmp_path / "tree2.bigdl")
    bigdl_fmt.save(m2, p2)
    m3 = bigdl_fmt.load(p2, device="cpu")
    np.testing.assert_allclose(_forward(m3, x), y1, rtol=1e-6, atol=1e-6)


# ----------------------------------------------- the port vs the JAX package

def _simple_rnn(pkg, act):
    m = pkg.Sequential()
    m.add(pkg.Recurrent(pkg.RnnCell(6, 8, act)))
    m.add(pkg.TimeDistributed(pkg.Linear(8, 4)))
    return m


def _ref_forward(model, x):
    out, _ = model.apply(model.params, model.state, jnp.asarray(x))
    return np.asarray(out)


def _both_ways(tmp_path, ref, port, x):
    """Both packages write byte-identical streams, each loads the other's,
    and the forwards agree with the reference model's within 1e-5."""
    from bigdl_tpu.interop import bigdl as ref_fmt
    want = _ref_forward(ref, x)
    np.testing.assert_allclose(_forward(port, x), want, rtol=1e-5,
                               atol=1e-5)
    ref_fmt.save(ref, str(tmp_path / "ref.bigdl"))
    bigdl_fmt.save(port, str(tmp_path / "port.bigdl"))
    a = (tmp_path / "ref.bigdl").read_bytes()
    assert a[:2] == b"\xac\xed" and a == (tmp_path / "port.bigdl").read_bytes()
    back = bigdl_fmt.load(str(tmp_path / "ref.bigdl"), device="cpu")
    rback = ref_fmt.load(str(tmp_path / "port.bigdl"))
    np.testing.assert_allclose(_forward(back, x), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_ref_forward(rback, x), want, rtol=1e-5,
                               atol=1e-5)


def test_simple_rnn_streams_are_the_references(tmp_path):
    ref = _simple_rnn(rnn, jnp.tanh)
    ref.build(jax.random.PRNGKey(5))
    ref.modules[0].modules[0].scale_w = 1.5
    port = _simple_rnn(nn, torch.tanh).build("cpu")
    port.layers[0].layers[0].scale_w = 1.5
    load_reference_tree(port, jax.tree_util.tree_map(np.asarray, ref.params),
                        jax.tree_util.tree_map(np.asarray, ref.state))
    _both_ways(tmp_path, ref, port, _rand((2, 5, 6), 22))


def test_canonical_fixture_streams_are_the_references(tmp_path):
    from bigdl_tpu.interop import bigdl as ref_fmt
    x = np.fromfile(FIXTURE + ".x", dtype=np.float32).reshape(2, 5, 6)
    _both_ways(tmp_path, ref_fmt.load(FIXTURE),
               bigdl_fmt.load(FIXTURE, device="cpu"), x)
