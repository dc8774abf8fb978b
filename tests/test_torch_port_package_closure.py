"""The port exports what the JAX package exports.

Every name in the ``__all__`` of ``bigdl_tpu.dataset``, ``bigdl_tpu.models``,
``bigdl_tpu.parallel``, ``bigdl_tpu.serve`` and ``bigdl_tpu.utils``, and every
name the top-level ``bigdl_tpu/__init__.py`` and ``bigdl_tpu/optim/__init__.py``
bind (neither has an ``__all__``: the names their imports and assignments
bind), is
exported by the port's package of the same path, and listed in its
``__all__`` where the package has one, unless it stands in
``NOT_YET_PORTED`` with the ``ROADMAP.md`` queue A item that ports it.
That list holds only serving, elastic, parallelism and interop names; it
may only shrink.
"""

import ast
import importlib
import os

import pytest

import bigdl_tpu

#: reference name -> the queue A item that ports it (serving 5, elastic
#: 6, parallelism 8, interop 9)
NOT_YET_PORTED = {}

ALLOWED_ITEMS = {"item 5", "item 6", "item 8", "item 9"}

PACKAGES = ("bigdl_tpu.dataset", "bigdl_tpu.models", "bigdl_tpu.parallel",
            "bigdl_tpu.serve", "bigdl_tpu.utils")

#: packages without an ``__all__``, read from their import statements
BOUND = ("bigdl_tpu", "bigdl_tpu.optim")


def _bound_names(pkg="bigdl_tpu"):
    path = os.path.join(os.path.dirname(bigdl_tpu.__file__),
                        *pkg.split(".")[1:], "__init__.py")
    names = []
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names += [(a.asname or a.name).split(".")[0] for a in node.names]
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
    return sorted(set(names))


def _cases():
    out = [(pkg, n) for pkg in BOUND for n in _bound_names(pkg)]
    for pkg in PACKAGES:
        out += [(pkg, n) for n in importlib.import_module(pkg).__all__]
    return out


CASES = _cases()


def test_waivers_name_allowed_items():
    for name, item in NOT_YET_PORTED.items():
        assert item in ALLOWED_ITEMS, (name, item)
        assert any(n == name for _, n in CASES), name


@pytest.mark.parametrize("pkg", BOUND + PACKAGES)
def test_package_exports_reference_names(pkg):
    port = importlib.import_module(pkg.replace("bigdl_tpu", "bigdl_torch",
                                               1))
    names = [n for p, n in CASES if p == pkg]
    assert names
    missing = [n for n in names if n not in NOT_YET_PORTED
               and not hasattr(port, n)]
    assert not missing, missing
    exported = getattr(port, "__all__", None)
    if exported is not None:
        unlisted = [n for n in names if n not in NOT_YET_PORTED
                    and not n.startswith("__") and n not in exported]
        assert not unlisted, unlisted


def test_exported_kinds_match_reference():
    """A reference class is a class in the port and a function a callable
    (the port's ViT and TransformerLM are functions that build a
    Sequential, as the reference's are)."""
    import inspect
    for pkg, name in CASES:
        ref = getattr(importlib.import_module(pkg), name)
        port = getattr(importlib.import_module(
            pkg.replace("bigdl_tpu", "bigdl_torch", 1)), name, None)
        if port is None:
            continue
        if inspect.ismodule(ref):
            assert inspect.ismodule(port), (pkg, name)
        elif inspect.isclass(ref):
            assert inspect.isclass(port), (pkg, name)
        elif callable(ref):
            assert callable(port), (pkg, name)
