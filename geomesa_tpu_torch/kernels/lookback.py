"""The per-stream workspace of the kernels that compact in order by
decoupled look-back (``csrc/lookback.cuh``): ``ordered_compact`` and
``seg_band``; ``fused_scan`` keeps its count's total and done counter in
the first words.

A workspace is 4 + units int64 words: a ticket and a done counter, two
totals, ``ordered_compact``'s full word (epoch-tagged: the first unit of a
call whose inclusive prefix reached the capacity), then one status word a
unit (``compact.UNIT`` candidates for ``ordered_compact``, a
1,024-candidate chunk for ``seg_band``). It is zeroed when made; each
kernel leaves its counters zero for the next call, and each call takes the
next epoch, so status and full words of earlier calls read as unpublished.
Calls on one stream run in order, so the kernels share their stream's
workspace. A call holds the workspace tensor it was given until its launch
is queued: a grown one replaces it here, and the allocator reuses the old
block only after that launch on the same stream.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

import torch

_WS: Dict[Tuple[int, int], List] = {}
_LOCK = threading.Lock()
_EPOCH_MAX = (1 << 32) - 1
_MIN_UNITS = 1024


def workspace(dev: torch.device, stream: int,
              need: int) -> Tuple[torch.Tensor, int, int]:
    """(workspace, its units, epoch) of ``stream``'s workspace for a call of
    ``need`` units: made, or grown, zeroed; the epoch is the call's."""
    key = (dev.index, stream)
    with _LOCK:
        ws = _WS.get(key)
        if ws is None or ws[1] < need:
            cap = max(need, _MIN_UNITS, 0 if ws is None else 2 * ws[1])
            ws = _WS[key] = [torch.zeros(4 + cap, dtype=torch.int64,
                                         device=dev), cap, 0]
        ws[2] += 1
        if ws[2] > _EPOCH_MAX:   # every 2^32 calls: forget every epoch's word
            ws[0][3:].zero_()
            ws[2] = 1
        return ws[0], ws[1], ws[2]
