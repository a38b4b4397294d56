"""System-property registry: the typed runtime knobs the port reads.

≙ ``geomesa_tpu.config`` (the reference's GeoMesaSystemProperties tier),
trimmed to the knobs of the Z3 point query path. The names and defaults are
the JAX package's, so one environment configures both. Every property reads
its environment variable on EACH access (late-bound), falling back to a
programmatic ``set`` override, then the default.

There is deliberately no counterpart of ``GEOMESA_TPU_PALLAS_REFINE``: on
the card the CUDA point-in-polygon kernel is the only path.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable


@dataclass
class SystemProperty:
    """One typed knob: ``prop.get()`` → env override → set() value → default."""

    name: str                       # env var name
    default: object
    parse: Callable[[str], object]
    doc: str
    _override: object = field(default=None, repr=False)

    def get(self):
        raw = os.environ.get(self.name)
        if raw is not None:
            try:
                return self.parse(raw)
            except (TypeError, ValueError):
                pass  # malformed env values fall back (reference behavior)
        if self._override is not None:
            return self._override
        return self.default

    def set(self, value) -> None:
        self._override = value

    def unset(self) -> None:
        self._override = None


def _register(name: str, default, parse, doc: str) -> SystemProperty:
    return SystemProperty(name, default, parse, doc)


def _parse_bool(s: str) -> bool:
    return s.strip().lower() not in ("0", "false", "no", "off", "")


PRUNE_BLOCK = _register(
    "GEOMESA_TPU_PRUNE_BLOCK", 4096, int,
    "Rows per gather block of the fused program's block gate.")

PRUNE_MAX_FRACTION = _register(
    "GEOMESA_TPU_PRUNE_MAX_FRAC", 0.25, float,
    "Fraction of the table's blocks the pruned branch may gather; above "
    "it the fused program masks the full table.")

FUSED_QUERY = _register(
    "GEOMESA_TPU_FUSED_QUERY", True, _parse_bool,
    "Master switch for the fused query program (index/compiled.py). The "
    "port has no staged scan path yet, so with it off every query raises "
    "NotImplementedError.")

