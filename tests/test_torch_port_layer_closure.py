"""Closure of the port's layer library over the JAX package's.

Every class that ``bigdl_tpu.nn`` exports is either exported by
``bigdl_torch.nn`` and named in some ``tests/test_torch_port_*.py``, or
listed in ``NOT_YET_PORTED``.  A listed name that the port exports fails
the test, so the list only shrinks as the port grows.
"""

import pathlib
import re

import pytest

import bigdl_tpu.nn as jnn

import bigdl_torch.nn as tnn

#: the reference's layers the port lacks: none since slice 17 (it may
#: only stay empty)
NOT_YET_PORTED = set()

REFERENCE = sorted(n for n in dir(jnn) if n[:1].isupper())


def _port_test_text():
    here = pathlib.Path(__file__)
    return "".join(p.read_text() for p in here.parent.glob(
        "test_torch_port_*.py") if p != here)


TEXT = _port_test_text()


@pytest.mark.parametrize("name", REFERENCE)
def test_reference_class_is_ported_or_listed(name):
    if name in NOT_YET_PORTED:
        assert not hasattr(tnn, name), (
            f"{name} is ported: take it out of NOT_YET_PORTED")
        return
    assert hasattr(tnn, name), f"{name} is neither ported nor listed"
    assert re.search(rf"\b{re.escape(name)}\b", TEXT), (
        f"{name} is named in no tests/test_torch_port_*.py")


def test_not_yet_ported_names_exist_in_the_reference():
    assert NOT_YET_PORTED <= set(REFERENCE)
