"""The ``Graph`` container: models over any DAG of modules.

Counterpart of ``bigdl_tpu/nn/graph.py`` (BigDL ``nn/Graph.scala:58``,
run in topological order over ``utils/DirectedGraph.scala``; ``Input``
placeholders, ``nn/Input.scala``)::

    inp = Input()
    h = Linear(10, 20)(inp)
    out = CAddTable()([ReLU()(h), Tanh()(h)])
    model = Graph(inp, out)

Calling a module on a node, or on a list of nodes, builds the edges: the
port's ``Module.__call__`` hands such a call to :func:`_node` and every
other call to ``torch.nn.Module.__call__`` (the reference patches
``Module.__call__`` when its graph module is imported).  ``Graph`` is a
container whose children are its nodes' modules in execution order, the
``Input`` nodes' included, so its parameter and state trees are lists in
that order, with the ``Input`` nodes' empty entries, as in the reference.
"""

from __future__ import annotations

from typing import List, Sequence, Union

from ..utils.graph import DirectedGraph, Node
from .module import Container, Module

__all__ = ["ModuleNode", "Input", "Graph"]


class ModuleNode(Node):
    """A node whose element is a module."""

    def __init__(self, module: Module):
        super().__init__(module)


class _InputModule(Module):
    def forward(self, x):
        return x


def Input() -> ModuleNode:
    """A placeholder input node (nn/Input.scala)."""
    return ModuleNode(_InputModule())


def is_node_call(args, kwargs) -> bool:
    """Whether a module call's arguments are a node or a non-empty list of
    nodes (an edge-building call)."""
    if len(args) != 1 or kwargs:
        return False
    a = args[0]
    if isinstance(a, ModuleNode):
        return True
    return (isinstance(a, (list, tuple)) and bool(a)
            and all(isinstance(n, ModuleNode) for n in a))


def _node(module: Module, inputs) -> ModuleNode:
    n = ModuleNode(module)
    for i in (inputs if isinstance(inputs, (list, tuple)) else [inputs]):
        i.point_to(n)
    return n


class Graph(Container):
    """A DAG of modules (nn/Graph.scala:58), run in the topological order
    of everything reachable from ``inputs``.  The input is one tensor, or
    a list of them for several ``Input`` nodes; a node with one
    predecessor gets its value, one with several the list of theirs in
    edge order.  Several output nodes give a list."""

    def __init__(self, inputs: Union[ModuleNode, Sequence[ModuleNode]],
                 outputs: Union[ModuleNode, Sequence[ModuleNode]]):
        ins = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
        # the topological order of everything reachable from the inputs,
        # through a virtual source taken out again afterwards
        source = Node(None)
        for i in ins:
            source.point_to(i)
        order = DirectedGraph(source).topology_sort()
        for i in ins:
            i.prev_nodes.remove(source)
        order = [n for n in order if n is not source]
        super().__init__(*[n.element for n in order])
        self.exec_order: List[ModuleNode] = order
        self.input_nodes: List[ModuleNode] = ins
        self.output_nodes: List[ModuleNode] = (
            list(outputs) if isinstance(outputs, (list, tuple))
            else [outputs])

    def forward(self, input):
        values = {}
        inputs = input if isinstance(input, (list, tuple)) else [input]
        for node, x in zip(self.input_nodes, inputs):
            values[id(node)] = x
        for n in self.exec_order:
            if id(n) in values:  # an Input node
                continue
            preds = n.prev_nodes
            x = (values[id(preds[0])] if len(preds) == 1
                 else [values[id(p)] for p in preds])
            values[id(n)] = n.element(x)
        outs = [values[id(o)] for o in self.output_nodes]
        return outs[0] if len(outs) == 1 else outs
