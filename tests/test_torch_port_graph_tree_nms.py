"""The port's ``Graph`` (with ``Input`` and ``ModuleNode``), tree LSTMs
(``TreeLSTM``, ``BinaryTreeLSTM``, ``models.TreeLSTMSentiment``,
``encode_tree``) and ``Nms`` against the JAX package.

``Graph``: a DAG of several branches and two inputs and outputs, built the
same way in both packages; its children (and so its parameter list) in
the reference's execution order, the ``Input`` nodes' empty entries
included; forward and gradients within 1e-5.  ``BinaryTreeLSTM`` on a
batch of two trees of different shapes (padding rows included), with and
without its output gate.  ``TreeLSTMSentiment``: 3 SGD steps on the root's
negative log-likelihood in both packages from the reference's weights,
losses within 1e-5 and the weights after within 2e-5.  ``nms``: a numpy
greedy oracle, tied scores (the first index wins, as ``jnp.argmax``),
``max_output`` below the box count, the strict IoU comparison.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import bigdl_tpu.nn as jnn
from bigdl_tpu.models import TreeLSTMSentiment as JTreeSentiment
from bigdl_tpu.models import encode_tree as jencode_tree
from bigdl_tpu.nn.detection import nms as jnms

import bigdl_torch.nn as tnn
from bigdl_torch.models import TreeLSTMSentiment, encode_tree
from bigdl_torch.nn.detection import nms
from bigdl_torch.utils.convert import load_reference_tree, to_reference_tree
from torch_port_harness import close, module_bf16, module_parity, x


def dag(nn):
    """Two inputs, a diamond (Linear -> ReLU | Tanh -> Linear each ->
    CAddTable), a side branch joining it, two outputs."""
    a, b = nn.Input(), nn.Input()
    h = nn.Linear(4, 6)(a)
    left = nn.Linear(6, 3)(nn.ReLU()(h))
    right = nn.Linear(6, 3)(nn.Tanh()(h))
    s = nn.CAddTable()([left, right])
    g = nn.Linear(2, 3)(b)
    joined = nn.CMulTable()([s, g])
    side = nn.Sigmoid()(nn.Linear(6, 2)(h))
    return nn.Graph([a, b], [joined, side])


def diamond(nn):
    inp = nn.Input()
    h = nn.Linear(5, 4)(inp)
    out = nn.CAddTable()([nn.ReLU()(h), nn.Tanh()(h)])
    return nn.Graph(inp, out)


def test_graph_order_is_the_reference_order():
    jg, tg = dag(jnn), dag(tnn)
    assert [type(m).__name__ for m in tg.layers] == \
        [type(n.element).__name__ for n in jg.exec_order]
    jg.build(jax.random.key(0))
    tg.build("cpu")
    params, _ = to_reference_tree(tg)
    ref = jax.tree.map(np.asarray, jg.params)
    assert [sorted((k, v.shape) for k, v in p.items()) for p in params] == \
        [sorted((k, v.shape) for k, v in p.items()) for p in ref]
    assert params[0] == {} and params[1] == {}   # the two Input nodes


def test_graph_matches_reference():
    module_parity(dag(jnn), dag(tnn), [x((3, 4)), x((3, 2), seed=1)])


def test_graph_diamond_matches_reference():
    module_parity(diamond(jnn), diamond(tnn), x((3, 5)))
    module_bf16(diamond(jnn), diamond(tnn), x((3, 5)))


def test_module_call_on_nodes_builds_edges():
    inp = tnn.Input()
    lin = tnn.Linear(2, 2)
    node = lin(inp)
    assert isinstance(node, tnn.ModuleNode) and node.element is lin
    assert node.prev_nodes == [inp] and inp.next_nodes == [node]
    both = tnn.CAddTable()([node, inp])
    assert both.prev_nodes == [node, inp]
    # a plain call still runs the forward
    lin.build("cpu")
    assert tuple(lin(torch.zeros((1, 2))).shape) == (1, 2)


def _two_trees(n_nodes=7):
    """Two trees of different shapes, padded to ``n_nodes``."""
    c0, l0, _ = encode_tree(((0, 1), 2), n_nodes)
    c1, l1, _ = encode_tree((0, (1, (2, 3))), n_nodes)
    return np.stack([c0, c1]), np.stack([l0, l1])


@pytest.mark.parametrize("gate_output", [True, False])
def test_binary_tree_lstm_matches_reference(gate_output):
    children, leaf_ids = _two_trees()
    inputs = [x((2, 4, 5)), children, leaf_ids]
    module_parity(jnn.BinaryTreeLSTM(5, 6, gate_output),
                  tnn.BinaryTreeLSTM(5, 6, gate_output), inputs)
    module_bf16(jnn.BinaryTreeLSTM(5, 6, gate_output),
                tnn.BinaryTreeLSTM(5, 6, gate_output), inputs)


def test_tree_lstm_base_and_padding_rows():
    assert (tnn.TreeLSTM(3, 4).input_size,
            tnn.TreeLSTM(3, 4).hidden_size) == (3, 4)
    children, leaf_ids = _two_trees()
    m = tnn.BinaryTreeLSTM(5, 6).build("cpu")
    out = m([torch.from_numpy(x((2, 4, 5))), children, leaf_ids])
    pad = (children[..., 0] < 0) & (leaf_ids < 0)
    assert bool(pad.any())
    assert torch.equal(out[torch.from_numpy(pad)],
                       torch.zeros((int(pad.sum()), 6)))


def test_encode_tree_matches_reference():
    for tree, n in ((((0, 1), 2), 5), ((0, (1, (2, 3))), 9), (3, 1)):
        for a, b in zip(encode_tree(tree, n), jencode_tree(tree, n)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        encode_tree(((0, 1), 2), 4)


def test_tree_sentiment_trains_like_reference():
    """Three SGD steps (lr 0.1) on the roots' negative log-likelihood."""
    jm = JTreeSentiment(vocab_size=20, embed_dim=8, hidden_size=6,
                        class_num=3)
    params, _ = jm.init(jax.random.key(0))
    tm = TreeLSTMSentiment(20, 8, 6, 3).build("cpu")
    load_reference_tree(tm, jax.tree.map(np.asarray, params), {})
    children, leaf_ids = _two_trees()
    tokens = np.array([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
    target = np.array([1, 2])
    root = children.shape[1] - 1

    def jloss(p):
        out, _ = jm.apply(p, {}, (jnp.asarray(tokens), jnp.asarray(children),
                                  jnp.asarray(leaf_ids)))
        return -jnp.mean(out[jnp.arange(2), root, target])

    jgrad = jax.jit(jax.value_and_grad(jloss))
    for step in range(3):
        jl, g = jgrad(params)
        params = jax.tree.map(lambda w, d: w - 0.1 * d, params, g)
        out = tm((torch.from_numpy(tokens), children, leaf_ids))
        tl = -out[torch.arange(2), root, torch.from_numpy(target)].mean()
        tm.zero_grad()
        tl.backward()
        tl = tl.detach()
        with torch.no_grad():
            for p in tm.parameters():
                p -= 0.1 * p.grad
        assert abs(tl.item() - float(jl)) <= 1e-5, (step, tl.item(),
                                                     float(jl))
    got = jax.tree.leaves(to_reference_tree(tm)[0])
    ref = jax.tree.leaves(jax.tree.map(np.asarray, params))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        close(a, b, 2e-5, "weights after 3 steps")
    assert to_reference_tree(tm)[1] == {}


def _oracle(boxes, scores, thr):
    """Plain numpy greedy NMS, ties to the lower index."""
    order = sorted(range(len(scores)), key=lambda i: (-scores[i], i))
    area = np.maximum(boxes[:, 2] - boxes[:, 0], 0) * \
        np.maximum(boxes[:, 3] - boxes[:, 1], 0)
    keep, dead = [], set()
    for i in order:
        if i in dead:
            continue
        keep.append(i)
        for j in order:
            ix1, iy1 = np.maximum(boxes[i, :2], boxes[j, :2])
            ix2, iy2 = np.minimum(boxes[i, 2:], boxes[j, 2:])
            inter = max(ix2 - ix1, 0) * max(iy2 - iy1, 0)
            union = area[i] + area[j] - inter
            if j != i and union > 0 and inter / union > thr:
                dead.add(j)
    return keep


def _boxes(n, seed, ties):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 10, (n, 2))
    wh = rng.uniform(1, 5, (n, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    if ties:
        scores = np.round(scores * 4) / 4   # five distinct values
    return boxes, scores


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("max_output", [None, 4])
def test_nms_matches_reference(ties, max_output):
    boxes, scores = _boxes(30, 0, ties)
    idx, count = nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5,
                     max_output)
    jidx, jcount = jnms(jnp.asarray(boxes), jnp.asarray(scores), 0.5,
                        max_output)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx.dtype == torch.int32 and int(count) == int(jcount)
    want = _oracle(boxes, scores, 0.5)[:max_output]
    assert [int(i) for i in idx if i >= 0] == want
    if max_output is not None:
        assert int(count) == max_output < len(_oracle(boxes, scores, 0.5))


def test_nms_first_of_tied_scores_and_strict_threshold():
    # boxes 0 and 1 overlap with IoU exactly 0.5: kept under ">" at 0.5,
    # suppressed at 0.4; box 2 ties box 0's score and comes after it
    boxes = torch.tensor([[0, 0, 2, 2], [0, 0, 2, 4], [5, 5, 6, 6]],
                         dtype=torch.float32)
    scores = torch.tensor([0.9, 0.5, 0.9])
    assert nms(boxes, scores, 0.5, 5)[0].tolist() == [0, 2, 1, -1, -1]
    assert nms(boxes, scores, 0.4, 5)[0].tolist() == [0, 2, -1, -1, -1]
    idx, count = nms(boxes, scores, 0.5, 2, score_threshold=0.6)
    assert idx.tolist() == [0, 2] and int(count) == 2


def test_nms_module_matches_reference():
    boxes, scores = _boxes(12, 3, True)
    jm = jnn.Nms(0.3, 6)
    jout, _ = jm.apply({}, {}, (jnp.asarray(boxes), jnp.asarray(scores)))
    tm = tnn.Nms(0.3, 6).build("cpu")
    tout = tm((torch.from_numpy(boxes), torch.from_numpy(scores)))
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
