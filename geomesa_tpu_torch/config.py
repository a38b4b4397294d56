"""System-property registry: the typed runtime knobs the port reads.

≙ ``geomesa_tpu.config`` (the reference's GeoMesaSystemProperties tier),
trimmed to the knobs of the ported paths (the Z3 point query, the staged
scan and density). The names and defaults are
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


SCAN_RANGES_TARGET = _register(
    "GEOMESA_TPU_SCAN_RANGES_TARGET", 2000, int,
    "Target key ranges per query cover (geomesa.scan.ranges.target, "
    "QueryProperties.scala:22).")

PRUNE_BLOCK = _register(
    "GEOMESA_TPU_PRUNE_BLOCK", 4096, int,
    "Rows per gather block: the fused program's block gate and the staged "
    "path's range-pruned block cover.")

PRUNE_MAX_FRACTION = _register(
    "GEOMESA_TPU_PRUNE_MAX_FRAC", 0.25, float,
    "Fraction of the table's blocks a pruned scan may gather; above it the "
    "scan masks the full table.")

PRUNE_ENABLED = _register(
    "GEOMESA_TPU_PRUNE", True, _parse_bool,
    "Master switch for range-pruned scan execution.")

FUSED_QUERY = _register(
    "GEOMESA_TPU_FUSED_QUERY", True, _parse_bool,
    "Master switch for the fused query program (index/compiled.py). With it "
    "off, the staged ScanKernels path (index/scan.py) answers every query.")

DENSITY_PACK = _register(
    "GEOMESA_TPU_DENSITY_PACK", "auto", str,
    "Density grid readback encoding: auto (cheapest faithful of sparse/u8/"
    "fp16 by wire size), sparse, u8 (unweighted only), fp16, or none (raw "
    "f32 grid). Unknown values fall back to auto. ≙ the reference's sparse "
    "kryo density grids (DensityScan.scala:95).")
