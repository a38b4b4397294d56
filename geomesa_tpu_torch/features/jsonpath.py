"""JSON-path access into JSON-document attributes.

≙ the reference's JSON attribute support (geomesa-features/feature-kryo/src/
main/scala/org/locationtech/geomesa/features/kryo/json/: JsonPathParser,
JsonPathPropertyAccessor, KryoJsonSerialization) — String attributes that
hold JSON documents and expose their interior via json-path. The path
subset matches what the reference's property accessor serves in practice:
``$.key.nested[2].leaf`` (dotted keys + integer array indexes; ``$`` root).

``json_column`` is the columnar surface: evaluate one path over a whole
String column, returning an object array (None for missing/invalid) — used
by the converter's ``jsonPath(...)`` transform, the shaping ``transform``
hint, and direct callers.
"""

from __future__ import annotations

import json
import re
from typing import List, Optional

import numpy as np

_STEP = re.compile(r"\.([A-Za-z_][\w-]*)|\[(\d+)\]|\['([^']+)'\]")


def parse_path(path: str) -> List[object]:
    """'$.a.b[0]' → ['a', 'b', 0]; raises on malformed paths."""
    p = path.strip()
    if not p.startswith("$"):
        raise ValueError(f"json path must start with '$': {path!r}")
    steps: List[object] = []
    pos = 1
    while pos < len(p):
        m = _STEP.match(p, pos)
        if m is None:
            raise ValueError(f"bad json path at {pos}: {path!r}")
        if m.group(1) is not None:
            steps.append(m.group(1))
        elif m.group(2) is not None:
            steps.append(int(m.group(2)))
        else:
            steps.append(m.group(3))
        pos = m.end()
    return steps


def extract(doc, steps: List[object]):
    """Walk parsed steps through a decoded document; None when absent."""
    for s in steps:
        if isinstance(s, int):
            if not isinstance(doc, list) or s >= len(doc):
                return None
            doc = doc[s]
        else:
            if not isinstance(doc, dict) or s not in doc:
                return None
            doc = doc[s]
    return doc


def extract_path(document: Optional[str], path: str):
    """One document, one path (scalar convenience)."""
    if document is None or document == "":
        return None
    try:
        return extract(json.loads(document), parse_path(path))
    except (ValueError, TypeError):
        return None


def json_column(col, path: str) -> np.ndarray:
    """Evaluate ``path`` over a String column of JSON documents → object
    array (the columnar accessor; parses the path once)."""
    from geomesa_tpu_torch.features.table import StringColumn

    steps = parse_path(path)
    if isinstance(col, StringColumn):
        # decode per DISTINCT document via the vocab (dictionary win: a
        # repeated document parses once)
        vals = []
        for v in col.vocab:
            try:
                vals.append(extract(json.loads(v), steps) if v else None)
            except (ValueError, TypeError):
                vals.append(None)
        lut = np.asarray(vals, dtype=object)
        return lut[col.codes]
    out = []
    for v in col:
        try:
            out.append(extract(json.loads(v), steps) if v else None)
        except (ValueError, TypeError):
            out.append(None)
    return np.asarray(out, dtype=object)
