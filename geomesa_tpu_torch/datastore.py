"""In-process data store over the port (≙ ``geomesa_tpu.datastore``).

    store = DataStoreFinder.get_data_store(type="torch", device="cuda")
    store.create_schema("gdelt", "name:String,val:Int,dtg:Date,*geom:Point;"
                        "geomesa.z3.interval=week")
    store.load("gdelt", FeatureTable.build(sft, columns))
    store.count("gdelt", "BBOX(geom, ...) AND dtg DURING ...")
    store.query("gdelt", "INTERSECTS(geom, POLYGON(...)) AND ...").indices
    store.query("gdelt", "dtg DURING ...", hints={"density": {
        "bbox": (-60, -30, 60, 30), "width": 64, "height": 64}}).weights

The device is ``cuda`` unless the caller passes another (``device="cpu"``
runs every kernel's plain version); asking for ``cuda`` without a card
raises. This port holds one bulk load per type in a Z3 index and answers
counts, selects and density heat maps; every other store feature raises
NotImplementedError naming its ROADMAP.md item.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

from geomesa_tpu_torch.aggregates.density import DensityGrid, density
from geomesa_tpu_torch.features.sft import SimpleFeatureType
from geomesa_tpu_torch.features.table import FeatureTable
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.index.api import QueryResult, not_ported
from geomesa_tpu_torch.index.device import resolve
from geomesa_tpu_torch.index.planner import QueryPlanner
from geomesa_tpu_torch.index.spatial import Z3Index


class TorchDataStore:
    """Schemas, loaded tables and their planners, on one device."""

    def __init__(self, params: Optional[dict] = None):
        self.device = resolve((params or {}).get("device"))
        self.schemas: Dict[str, SimpleFeatureType] = {}
        self.planners: Dict[str, QueryPlanner] = {}

    @classmethod
    def can_process(cls, params: dict) -> bool:
        return params.get("type") == "torch"

    def create_schema(self, sft: Union[SimpleFeatureType, str],
                      spec: Optional[str] = None) -> SimpleFeatureType:
        if isinstance(sft, str):
            sft = SimpleFeatureType.from_spec(sft, spec or "")
        if sft.name in self.schemas:
            raise ValueError(f"Schema {sft.name} already exists")
        if not Z3Index.supports(sft):
            raise not_ported("schemas without a Point geometry and a Date "
                             "(Z2 and the extent indexes)", 9)
        if any(a.options.get("index", "").lower() in ("true", "full", "join")
               for a in sft.attributes) or sft.user_data.get("geomesa.indices"):
            raise not_ported("attribute and configured indexes", 10)
        self.schemas[sft.name] = sft
        return sft

    def load(self, type_name: str, table: FeatureTable) -> None:
        """Bulk-load a columnar table: builds the Z3 index on the device."""
        sft = self.schemas[type_name]
        if type_name in self.planners:
            raise not_ported("appends to a loaded type (the LSM delta tier)", 10)
        self.planners[type_name] = QueryPlanner(
            sft, table, [Z3Index(sft, table, self.device)])

    def planner(self, type_name: str) -> QueryPlanner:
        if type_name not in self.planners:
            raise ValueError(f"No data written to {type_name}")
        return self.planners[type_name]

    def count(self, type_name: str,
              f: Union[str, ir.Filter] = "INCLUDE") -> int:
        return self.planner(type_name).count(f)

    def query(self, type_name: str, f: Union[str, ir.Filter] = "INCLUDE",
              hints: Optional[dict] = None
              ) -> Union[QueryResult, DensityGrid]:
        """Rows of a filter as a QueryResult; with ``hints={"density":
        {"bbox", "width", "height", "weight"}}`` a DensityGrid heat map of
        the matches instead (width/height default to 256, weight to None)."""
        hints = hints or {}
        unknown = set(hints) - {"density"}
        if unknown:
            raise not_ported(f"query hints {sorted(unknown)}", 10)
        planner = self.planner(type_name)
        if "density" in hints:
            d = dict(hints["density"])
            return density(planner, f, d["bbox"], d.get("width", 256),
                           d.get("height", 256), d.get("weight"))
        return planner.query(f)


class DataStoreFinder:
    """Data store lookup by params (≙ DataStoreFactorySpi discovery);
    ``type="torch"`` selects this port's store."""

    @classmethod
    def get_data_store(cls, **params):
        if TorchDataStore.can_process(params):
            return TorchDataStore(params)
        raise ValueError(f"No datastore factory for params {sorted(params)}")
