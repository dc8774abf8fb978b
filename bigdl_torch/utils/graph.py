"""DirectedGraph / Node: the DAG under the ``Graph`` container.

Counterpart of ``bigdl_tpu/utils/graph.py`` (BigDL
``utils/DirectedGraph.scala:34, 135``): ``Node`` with its edge operation
(``->``, :155), ``topology_sort`` (:52), ``dfs`` (:85) and ``bfs``
(:108).  A copy, not an import: ``Graph``'s parameter list is in this
sort's order, so it must be the reference's order for the two packages'
trees to line up.
"""

from __future__ import annotations

from collections import deque
from typing import Any, List

__all__ = ["Node", "DirectedGraph"]


class Node:
    """A graph node holding an ``element`` (DirectedGraph.scala:135)."""

    def __init__(self, element: Any):
        self.element = element
        self.prev_nodes: List["Node"] = []
        self.next_nodes: List["Node"] = []

    def point_to(self, other: "Node") -> "Node":
        """Add the edge self -> other (the reference's ``->``)."""
        self.next_nodes.append(other)
        other.prev_nodes.append(self)
        return other

    __gt__ = point_to  # a > b adds the edge a -> b

    def __repr__(self):
        return f"Node({self.element!r})"


class DirectedGraph:
    """The DAG reachable from ``source``; ``reverse=True`` walks the edges
    backwards (DirectedGraph.scala:34)."""

    def __init__(self, source: Node, reverse: bool = False):
        self.source = source
        self.reverse = reverse

    def _next(self, node: Node):
        return node.prev_nodes if self.reverse else node.next_nodes

    def _prev(self, node: Node):
        return node.next_nodes if self.reverse else node.prev_nodes

    def bfs(self):
        """Breadth-first order from the source."""
        seen, order, q = {id(self.source)}, [], deque([self.source])
        while q:
            n = q.popleft()
            order.append(n)
            for m in self._next(n):
                if id(m) not in seen:
                    seen.add(id(m))
                    q.append(m)
        return order

    def dfs(self):
        """Depth-first order from the source."""
        seen, order, stack = {id(self.source)}, [], [self.source]
        while stack:
            n = stack.pop()
            order.append(n)
            for m in self._next(n):
                if id(m) not in seen:
                    seen.add(id(m))
                    stack.append(m)
        return order

    def topology_sort(self):
        """Kahn's topological sort of the nodes reachable from the source,
        in the reference's order; raises on a cycle."""
        reachable = self.bfs()
        ids = {id(n) for n in reachable}
        indeg = {id(n): sum(1 for p in self._prev(n) if id(p) in ids)
                 for n in reachable}
        q = deque(n for n in reachable if indeg[id(n)] == 0)
        order = []
        while q:
            n = q.popleft()
            order.append(n)
            for m in self._next(n):
                if id(m) in ids:
                    indeg[id(m)] -= 1
                    if indeg[id(m)] == 0:
                        q.append(m)
        if len(order) != len(reachable):
            raise ValueError("graph contains a cycle")
        return order

    def size(self) -> int:
        return len(self.bfs())

    def edges(self) -> int:
        return sum(len(self._next(n)) for n in self.bfs())
