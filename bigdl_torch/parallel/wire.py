"""The gradient wire: every gradient rounded through the wire dtype.

Counterpart of ``bigdl_tpu/parallel/wire.py`` ``wire_cast`` (its per-leaf
form).  The reference ships gradients between nodes in a bf16-truncated
format (``FP16CompressedTensor``), and its train step rounds each gradient
through ``DTypePolicy.wire_dtype`` after the regularizers and scales and
before clipping and the update, on one device as on many
(``optim/optimizer.py`` ``_build_step``).  The port's ``Optimizer`` does
the same with :func:`wire_cast`.

Not ported: the reference's bucketed form (bit-identical values, a
different XLA program) and its ``measure_collective_seconds`` probe.
"""

from __future__ import annotations

from typing import List, Optional

import torch

__all__ = ["wire_cast"]


def wire_cast(grads: List[torch.Tensor],
              wire: Optional[torch.dtype]) -> List[torch.Tensor]:
    """Each gradient rounded to ``wire`` and widened back to float32
    (``g.to(wire).float()``); ``wire=None`` returns ``grads`` as they
    are."""
    if wire is None:
        return grads
    return [g.to(wire).float() for g in grads]
