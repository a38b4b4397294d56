"""ECQL parsing, the filter IR, planning extraction and host evaluation
(≙ ``geomesa_tpu.filter``)."""

from geomesa_tpu_torch.filter.ir import (  # noqa: F401
    And, BBox, Cmp, During, Filter, In, Include, Intersects, Not, Or,
)
from geomesa_tpu_torch.filter.parser import parse_ecql  # noqa: F401
from geomesa_tpu_torch.filter.evaluate import evaluate  # noqa: F401
from geomesa_tpu_torch.filter.extract import extract_bboxes, extract_intervals  # noqa: F401
