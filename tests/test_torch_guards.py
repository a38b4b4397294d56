"""The schema's query timeout (``geomesa.query.timeout``) through both
packages' stores, on the input of the reference's own
``tests/test_guards_views.py::test_query_timeout``: after a full build and
after a merge build (an LSM delta flushed into the resident index), a count
raises each package's ``QueryTimeout``, as the reference's planner does
with the key set. The port runs with device="cpu"."""

import numpy as np
import pytest

from geomesa_tpu.datastore import TpuDataStore
from geomesa_tpu.features.table import FeatureTable as JTable
from geomesa_tpu.index.guards import QueryTimeout as JTimeout
from geomesa_tpu.metrics import REGISTRY as JREG
from geomesa_tpu_torch import DataStoreFinder
from geomesa_tpu_torch.features.table import FeatureTable as TTable
from geomesa_tpu_torch.index.guards import QueryTimeout as TTimeout
from geomesa_tpu_torch.metrics import REGISTRY as TREG

SPEC = "name:String,v:Int,dtg:Date,*geom:Point"
BASE = np.datetime64("2024-01-01", "ms").astype(np.int64)

SIDES = {"jax": (TpuDataStore, JTable, JTimeout, JREG),
         "torch": (lambda: DataStoreFinder.get_data_store(type="torch",
                                                          device="cpu"),
                   TTable, TTimeout, TREG)}


def _rows(n: int, v0: int = 0) -> dict:
    return {"name": ["a"] * n, "v": list(range(v0, v0 + n)),
            "dtg": [int(BASE)] * n, "geom": ([0.0] * n, [0.0] * n)}


def _merges(reg) -> int:
    return reg.snapshot()["counters"].get("ingest.merge_builds", 0)


@pytest.mark.parametrize("side", ["jax", "torch"])
@pytest.mark.parametrize("timeout", [None, "0.000001"])
def test_query_timeout(side, timeout):
    """The reference test's store and count (10 rows, ``v < 5``): with the
    key set the count raises ``QueryTimeout`` after the full build and
    again after a merge build; without it both counts answer."""
    make, table, timeout_error, reg = SIDES[side]
    ds = make()
    ds.create_schema("t", SPEC if timeout is None
                     else f"{SPEC};geomesa.query.timeout={timeout}")
    ds.load("t", table.build(ds.get_schema("t"), _rows(10)))
    if timeout is None:
        assert ds.count("t", "v < 5") == 5
    else:
        with pytest.raises(timeout_error):
            ds.count("t", "v < 5")
    # two rows into the delta tier, then a flush through the merge build
    ds.load("t", table.build(ds.get_schema("t"), _rows(2, 10)))
    before = _merges(reg)
    ds.flush("t")
    assert _merges(reg) == before + 1
    if timeout is None:
        assert ds.count("t", "v < 5") == 5
    else:
        with pytest.raises(timeout_error):
            ds.count("t", "v < 5")
