"""Schemas and host columnar tables (≙ ``geomesa_tpu.features``)."""

from geomesa_tpu_torch.features.sft import AttributeSpec, SimpleFeatureType  # noqa: F401
from geomesa_tpu_torch.features.table import FeatureTable  # noqa: F401
