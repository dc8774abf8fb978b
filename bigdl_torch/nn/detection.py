"""Detection: greedy non-maximum suppression, ``nms`` and ``Nms``.

Counterpart of ``bigdl_tpu/nn/detection.py`` (BigDL ``nn/Nms.scala``,
beside ``RoiPooling`` on the Fast R-CNN path).  As in the reference the
loop runs a fixed ``max_output`` times with static shapes: each pass takes
the highest-scoring live box (``argmax``: the first of tied scores, as
``jnp.argmax``), writes it at the count, and kills every box whose IoU with
it is above the threshold (strictly).  The count, the selection and the
live set stay on the device: the loop reads nothing back to the host.
The output is (max_output,) int32 indices padded with -1.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .module import Module

__all__ = ["Nms", "nms"]


def _iou_matrix(boxes):
    """(n, 4) x1, y1, x2, y2 boxes -> (n, n) IoU, 0 where the union is
    empty."""
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = (x2 - x1).clamp(min=0) * (y2 - y1).clamp(min=0)
    ix1 = torch.maximum(x1[:, None], x1[None, :])
    iy1 = torch.maximum(y1[:, None], y1[None, :])
    ix2 = torch.minimum(x2[:, None], x2[None, :])
    iy2 = torch.minimum(y2[:, None], y2[None, :])
    inter = (ix2 - ix1).clamp(min=0) * (iy2 - iy1).clamp(min=0)
    union = area[:, None] + area[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def nms(boxes, scores, iou_threshold: float = 0.5,
        max_output: Optional[int] = None,
        score_threshold: float = -math.inf):
    """Greedy NMS: (indices, count), ``indices`` (max_output,) int32 padded
    with -1 and ``count`` a 0-d int32 tensor, both on the boxes' device."""
    n = boxes.shape[0]
    if max_output is None:
        max_output = n
    dev = boxes.device
    iou = _iou_matrix(boxes)
    live = scores > score_threshold
    neg = torch.full_like(scores, -math.inf)
    ar = torch.arange(n, device=dev)
    sel = torch.full((max_output,), -1, dtype=torch.int32, device=dev)
    count = torch.zeros((1,), dtype=torch.int64, device=dev)
    minus_one = torch.full((1,), -1, dtype=torch.int32, device=dev)
    for _ in range(max_output):
        best = torch.argmax(torch.where(live, scores, neg)).view(1)
        any_live = live.any().view(1)
        sel = sel.index_put((count,), torch.where(any_live, best.int(),
                                                  minus_one))
        count = count + any_live.long()
        # kill the taken box and every box overlapping it; nothing once
        # the live set is empty
        suppress = iou.index_select(0, best)[0] > iou_threshold
        live = live & ~suppress & (ar != best) & any_live
    return sel, count[0].int()


class Nms(Module):
    """``nms`` as a module: input (boxes (n, 4), scores (n,)), output the
    padded index array (the reference's Nms.scala fills an index
    buffer)."""

    def __init__(self, iou_threshold: float = 0.5,
                 max_output: Optional[int] = None):
        super().__init__()
        self.iou_threshold = iou_threshold
        self.max_output = max_output

    def forward(self, inp):
        boxes, scores = inp
        idx, _ = nms(boxes, scores, self.iou_threshold, self.max_output)
        return idx
