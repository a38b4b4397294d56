"""BIN trajectory encoding.

Copied from ``geomesa_tpu.aggregates.bin``
(host-only) with its imports pointed at this package.

≙ reference `BinAggregatingScan` + `BinaryOutputEncoder`
(index/iterators/BinAggregatingScan.scala, utils/bin/BinaryOutputEncoder.scala:
28,59): pack matching features into fixed 16-byte (or 24-byte labelled)
records — trackId:int32, dtg:int32 epoch seconds, lat:f32, lon:f32
[, label:int64] — the massive-trajectory wire format. The scan/filter runs on
device; the pack is one vectorized structured-array assembly over the
surviving rows (columnar in, columnar out — no per-feature loop).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from geomesa_tpu_torch.features.table import StringColumn
from geomesa_tpu_torch.stats.sketches import hash64

BIN_DTYPE = np.dtype([("track", "<i4"), ("dtg", "<i4"),
                      ("lat", "<f4"), ("lon", "<f4")])
BIN_LABEL_DTYPE = np.dtype([("track", "<i4"), ("dtg", "<i4"),
                            ("lat", "<f4"), ("lon", "<f4"), ("label", "<i8")])


def _track_ids(col) -> np.ndarray:
    """Stable int32 track ids (≙ trackId hashCode semantics: a deterministic
    int per distinct value)."""
    if isinstance(col, StringColumn):
        vocab_ids = (hash64(np.asarray(col.vocab, dtype=object))
                     & np.uint64(0x7FFFFFFF)).astype(np.int32)
        return vocab_ids[col.codes]
    arr = np.asarray(col)
    if arr.dtype.kind in "iub":
        return arr.astype(np.int32)
    return (hash64(arr) & np.uint64(0x7FFFFFFF)).astype(np.int32)


def _label_ids(col) -> np.ndarray:
    if isinstance(col, StringColumn):
        vocab_ids = hash64(np.asarray(col.vocab, dtype=object)).astype(np.int64)
        return vocab_ids[col.codes]
    return np.asarray(col).astype(np.int64)


def bin_records(planner, f, track: str, label: Optional[str] = None,
                sort: bool = False, auths=None) -> np.ndarray:
    """Matching rows as a packed structured array (``.tobytes()`` is the wire
    form). sort=True orders by dtg (≙ the BinSorter merge phase); ``auths``
    restricts to visible rows."""
    sft = planner.sft
    dtg_attr = sft.dtg_attribute
    if dtg_attr is None:
        raise ValueError("BIN encoding requires a date attribute")
    rows = planner.select_indices(f, auths=auths)
    sub = planner.table.take(rows)
    x, y = sub.geometry().point_xy() if sub.geometry().is_points else _centroids(sub)
    out = np.empty(len(rows), dtype=BIN_LABEL_DTYPE if label else BIN_DTYPE)
    out["track"] = _track_ids(sub.columns[track])
    out["dtg"] = (np.asarray(sub.columns[dtg_attr.name], dtype=np.int64)
                  // 1000).astype(np.int32)
    out["lat"] = y.astype(np.float32)
    out["lon"] = x.astype(np.float32)
    if label:
        out["label"] = _label_ids(sub.columns[label])
    if sort:
        out = out[np.argsort(out["dtg"], kind="stable")]
    return out


def _centroids(sub):
    bb = sub.geometry().bboxes()
    return (bb[:, 0] + bb[:, 2]) / 2, (bb[:, 1] + bb[:, 3]) / 2


def decode_bin(buf: Union[bytes, np.ndarray], labelled: bool = False) -> np.ndarray:
    """Wire bytes → structured array (the client decode side)."""
    if isinstance(buf, np.ndarray):
        return buf
    return np.frombuffer(buf, dtype=BIN_LABEL_DTYPE if labelled else BIN_DTYPE)
