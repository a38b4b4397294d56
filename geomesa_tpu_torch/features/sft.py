"""SimpleFeatureType: schema for a feature collection.

≙ reference SimpleFeatureTypes spec DSL
(GeoMesa geomesa-utils/.../geotools/SimpleFeatureTypes.scala:27).
Schemas parse from the same compact spec-string format the reference uses:

    "name:String,age:Int,dtg:Date,*geom:Point:srid=4326;geomesa.z3.interval=week"

i.e. comma-separated ``[*]name:Type[:opt=val]`` attribute specs, ``*`` marking
the default geometry, followed by ``;``-separated user-data options. Supported
types mirror the reference's attribute type registry (String, Int/Integer,
Long, Float, Double, Boolean, Date, UUID, Bytes, and geometry types).

Per-type configuration rides in ``user_data`` exactly like the reference
(``geomesa.indices``, ``geomesa.z3.interval``, ``geomesa.z.splits``, …).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

GEOMETRY_TYPES = {
    "Point", "LineString", "Polygon", "MultiPoint", "MultiLineString",
    "MultiPolygon", "GeometryCollection", "Geometry",
}

# attribute type name -> numpy storage dtype (None = variable width / special)
ATTRIBUTE_TYPES: Dict[str, Optional[np.dtype]] = {
    "String": None,           # dictionary-encoded int32 + string table
    "Int": np.dtype(np.int32),
    "Integer": np.dtype(np.int32),
    "Long": np.dtype(np.int64),
    "Float": np.dtype(np.float32),
    "Double": np.dtype(np.float64),
    "Boolean": np.dtype(np.bool_),
    "Date": np.dtype(np.int64),  # epoch millis UTC
    "UUID": None,
    "Bytes": None,
}


@dataclass
class AttributeSpec:
    name: str
    type_name: str
    default: bool = False       # '*' prefix (default geometry)
    options: Dict[str, str] = field(default_factory=dict)

    @property
    def is_geometry(self) -> bool:
        return self.type_name in GEOMETRY_TYPES

    @property
    def binding(self) -> Optional[np.dtype]:
        return ATTRIBUTE_TYPES.get(self.type_name)

    def to_spec(self) -> str:
        star = "*" if self.default else ""
        opts = "".join(f":{k}={v}" for k, v in self.options.items())
        return f"{star}{self.name}:{self.type_name}{opts}"


@dataclass
class SimpleFeatureType:
    """Schema: ordered attributes + user-data config map."""

    name: str
    attributes: List[AttributeSpec]
    user_data: Dict[str, str] = field(default_factory=dict)

    # -- parsing (reference SimpleFeatureTypes.createType) ------------------

    @classmethod
    def from_spec(cls, name: str, spec: str) -> "SimpleFeatureType":
        spec = spec.strip()
        if ";" in spec:
            attr_part, _, ud_part = spec.partition(";")
        else:
            attr_part, ud_part = spec, ""
        attributes = []
        if attr_part.strip():
            for chunk in attr_part.split(","):
                chunk = chunk.strip()
                if not chunk:
                    continue
                default = chunk.startswith("*")
                if default:
                    chunk = chunk[1:]
                parts = chunk.split(":")
                if len(parts) < 2:
                    raise ValueError(f"Invalid attribute spec: {chunk}")
                attr_name, type_name = parts[0], parts[1]
                if type_name not in ATTRIBUTE_TYPES and type_name not in GEOMETRY_TYPES:
                    raise ValueError(f"Unknown attribute type: {type_name}")
                options = {}
                for opt in parts[2:]:
                    k, _, v = opt.partition("=")
                    options[k] = v
                attributes.append(AttributeSpec(attr_name, type_name, default, options))
        user_data = {}
        for chunk in ud_part.split(","):
            chunk = chunk.strip()
            if chunk:
                k, _, v = chunk.partition("=")
                user_data[k] = v
        return cls(name, attributes, user_data)

    def to_spec(self) -> str:
        attrs = ",".join(a.to_spec() for a in self.attributes)
        if self.user_data:
            ud = ",".join(f"{k}={v}" for k, v in self.user_data.items())
            return f"{attrs};{ud}"
        return attrs

    # -- accessors ----------------------------------------------------------

    def attribute(self, name: str) -> AttributeSpec:
        for a in self.attributes:
            if a.name == name:
                return a
        raise KeyError(f"No attribute {name!r} in {self.name}")

    @property
    def geometry_attribute(self) -> Optional[AttributeSpec]:
        """The default geometry: '*'-marked, else the first geometry attr."""
        geoms = [a for a in self.attributes if a.is_geometry]
        for a in geoms:
            if a.default:
                return a
        return geoms[0] if geoms else None

    @property
    def dtg_attribute(self) -> Optional[AttributeSpec]:
        """Default date attribute: ``geomesa.index.dtg`` user data, else the
        first Date attribute (reference RichSimpleFeatureType.getDtgField)."""
        configured = self.user_data.get("geomesa.index.dtg")
        if configured:
            return self.attribute(configured)
        for a in self.attributes:
            if a.type_name == "Date":
                return a
        return None

    @property
    def z3_interval(self) -> str:
        return self.user_data.get("geomesa.z3.interval", "week")

    @property
    def xz_precision(self) -> int:
        """The XZ curves' resolution g (``geomesa.xz.precision``, default
        12)."""
        return int(self.user_data.get("geomesa.xz.precision", "12"))

    @property
    def configured_indices(self) -> Optional[List[str]]:
        """The index names of ``geomesa.indices`` user data (``attr:name``
        entries give ``attr``), or None to let the store pick its defaults
        (≙ ``geomesa_tpu/features/sft.py:162``)."""
        raw = self.user_data.get("geomesa.indices")
        if not raw:
            return None
        return [part.split(":")[0] for part in raw.split(",") if part]

    @property
    def feature_expiry(self) -> Optional[tuple]:
        """(date attribute name, ttl_ms) from ``geomesa.feature.expiry``
        user data, or None (≙ ``geomesa_tpu/features/sft.py:171``): the
        reference FeatureExpiration syntax, ``attr(duration)`` or a bare
        ``duration`` on the default dtg attribute. The store enforces it at
        ingest, at every LSM flush and in ``age_off``."""
        raw = self.user_data.get("geomesa.feature.expiry")
        if not raw:
            return None
        m = re.match(r"^\s*(\w+)\s*\(\s*([^)]+?)\s*\)\s*$", raw)
        if m:
            attr_name, dur = m.group(1), m.group(2)
            attr = self.attribute(attr_name)
        else:
            dur = raw.strip()
            attr = self.dtg_attribute
            if attr is None:
                raise ValueError(
                    "geomesa.feature.expiry with a bare duration needs a "
                    "Date attribute (or use 'attr(duration)')")
        if attr.type_name != "Date":
            raise ValueError(
                f"geomesa.feature.expiry attribute {attr.name!r} must be a "
                f"Date (got {attr.type_name})")
        return attr.name, parse_duration_ms(dur)

    @property
    def device_column_group(self) -> Optional[List[str]]:
        """Attribute names projected onto the device (``geomesa.column.groups``
        user data, ':'-separated). ≙ the reference's ColumnGroups narrow
        scans (conf/ColumnGroups.scala): ONE group here — the
        device-resident projection; attributes outside it stay host-only and
        their predicates evaluate as host residuals. None = all attributes.
        Geometry and the primary dtg always project (the scan primaries)."""
        raw = self.user_data.get("geomesa.column.groups")
        if not raw:
            return None
        names = [p for p in raw.split(":") if p]
        known = {a.name for a in self.attributes}
        unknown = [n for n in names if n not in known]
        if unknown:
            raise ValueError(
                f"geomesa.column.groups names unknown attributes {unknown} "
                f"(have {sorted(known)}; ':'-separated)")
        return names


_DURATION_MS = {
    "ms": 1, "millis": 1, "milliseconds": 1,
    "s": 1000, "second": 1000, "seconds": 1000,
    "min": 60_000, "minute": 60_000, "minutes": 60_000,
    "h": 3_600_000, "hour": 3_600_000, "hours": 3_600_000,
    "d": 86_400_000, "day": 86_400_000, "days": 86_400_000,
    "w": 604_800_000, "week": 604_800_000, "weeks": 604_800_000,
}


def parse_duration_ms(s: str) -> int:
    """'7 days' / '30min' / '500 ms' → milliseconds (the reference's
    duration grammar, ``geomesa_tpu/features/sft.py``)."""
    m = re.match(r"^\s*(\d+)\s*([a-zA-Z]+)\s*$", s)
    if not m or m.group(2).lower() not in _DURATION_MS:
        raise ValueError(
            f"Cannot parse duration {s!r} (want '<n> "
            f"{'|'.join(sorted(set(_DURATION_MS)))}')")
    return int(m.group(1)) * _DURATION_MS[m.group(2).lower()]
