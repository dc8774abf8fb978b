"""Table: the Torch-style container of multi-input and multi-output
activities.

Counterpart of ``bigdl_tpu/utils/table.py`` (reference ``utils/Table.scala:34``
and its ``T()`` constructor, ``:299``): a dict that takes Torch's 1-based
integer keys beside named ones.  The port's layers take and return Python
lists; a Table is for code written against the reference's API.
"""

from __future__ import annotations

__all__ = ["Table", "T"]


class Table(dict):
    """A dict that tolerates Torch-style ``table[1]``, ``table[2]`` integer
    keys."""

    def insert(self, value):
        """Append under the next free 1-based integer key."""
        i = 1
        while i in self:
            i += 1
        self[i] = value
        return self

    def __repr__(self):
        inner = ", ".join(f"{k!r}: {v!r}" for k, v in self.items())
        return "T{" + inner + "}"


def T(*args, **kwargs) -> Table:
    """``T(a, b, c)`` -> a Table with 1-based integer keys; ``T(k=v)`` ->
    named entries."""
    t = Table()
    for i, a in enumerate(args):
        t[i + 1] = a
    t.update(kwargs)
    return t
