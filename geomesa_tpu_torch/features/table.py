"""FeatureTable: the host columnar feature collection.

≙ ``geomesa_tpu.features.table`` for point layers: per attribute, a host
numpy column (the durable copy the host refine reads); strings as
dictionary codes (int32) + a sorted vocab, exactly the reference's
``StringColumn.encode`` so device codes agree across both packages.
Feature ids are implicit (fid == str(row)).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

from geomesa_tpu_torch.features.geometry import GeometryArray
from geomesa_tpu_torch.features.sft import SimpleFeatureType


@dataclass
class StringColumn:
    codes: np.ndarray           # (N,) int32 indices into vocab
    vocab: List[str]

    def __len__(self) -> int:
        return len(self.codes)

    @classmethod
    def encode(cls, values: Sequence[str]) -> "StringColumn":
        vocab, inverse = np.unique(np.asarray(values, dtype=object), return_inverse=True)
        return cls(inverse.astype(np.int32), [str(v) for v in vocab])


@dataclass
class FeatureTable:
    sft: SimpleFeatureType
    # values: np.ndarray | StringColumn | GeometryArray
    columns: Dict[str, object] = field(default_factory=dict)
    _n: int = 0

    def __len__(self) -> int:
        return self._n

    @classmethod
    def build(cls, sft: SimpleFeatureType,
              data: Dict[str, object]) -> "FeatureTable":
        """data: attribute name → column values. Point geometries are a
        GeometryArray or an (x, y) array tuple; strings encode to
        dictionaries (or arrive as a StringColumn)."""
        columns: Dict[str, object] = {}
        n = None
        for attr in sft.attributes:
            if attr.name not in data:
                raise KeyError(f"Missing column {attr.name}")
            raw = data[attr.name]
            if attr.is_geometry:
                if isinstance(raw, GeometryArray):
                    col = raw
                elif isinstance(raw, tuple) and len(raw) == 2:
                    col = GeometryArray.points(raw[0], raw[1])
                else:
                    raise TypeError(f"{attr.name}: pass points as a "
                                    "GeometryArray or an (x, y) tuple")
            elif attr.type_name == "String":
                col = raw if isinstance(raw, StringColumn) else StringColumn.encode(raw)
            elif attr.type_name == "Date":
                arr = np.asarray(raw)
                if arr.dtype.kind == "M":
                    arr = arr.astype("datetime64[ms]").astype(np.int64)
                elif arr.dtype.kind in "OU":
                    arr = np.array(raw, dtype="datetime64[ms]").astype(np.int64)
                col = arr.astype(np.int64)
            else:
                col = np.asarray(raw, dtype=attr.binding)
            m = len(col)
            if n is None:
                n = m
            elif n != m:
                raise ValueError(f"Column {attr.name} length {m} != {n}")
            columns[attr.name] = col
        return cls(sft, columns, _n=n or 0)

    def column(self, name: str):
        return self.columns[name]

    def geometry(self) -> GeometryArray:
        attr = self.sft.geometry_attribute
        if attr is None:
            raise ValueError("No geometry attribute")
        return self.columns[attr.name]

    def take(self, idx: np.ndarray) -> "FeatureTable":
        """Host-side row gather (result hydration)."""
        idx = np.asarray(idx, dtype=np.int64)
        cols: Dict[str, object] = {}
        for name, col in self.columns.items():
            if isinstance(col, GeometryArray):
                cols[name] = col.take(idx)
            elif isinstance(col, StringColumn):
                cols[name] = StringColumn(col.codes[idx], col.vocab)
            else:
                cols[name] = col[idx]
        return FeatureTable(self.sft, cols, _n=len(idx))
