"""Merged and routed multi-store views.

≙ reference `index.view` (SURVEY.md §2.4: MergedDataStoreView.scala:33 —
scatter-gather a query across several stores and concatenate;
RoutedDataStoreView + RouteSelector.scala:17 — send each query to exactly
one store chosen by the filter's attributes)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Union

import numpy as np

from geomesa_tpu_torch.features.table import FeatureTable
from geomesa_tpu_torch.filter import ir
from geomesa_tpu_torch.filter.parser import parse_ecql


def _filter_attributes(f: ir.Filter) -> Set[str]:
    out: Set[str] = set()

    def walk(node):
        if isinstance(node, (ir.And, ir.Or)):
            for c in node.children:
                walk(c)
        elif isinstance(node, ir.Not):
            walk(node.child)
        elif hasattr(node, "attr"):
            out.add(node.attr)

    walk(f)
    return out


class MergedDataStoreView:
    """Scatter-gather across stores sharing a schema (≙ MergedQueryRunner:
    each store queried with the same filter, results concatenated; counts
    sum)."""

    def __init__(self, stores: Sequence[object], type_name: str):
        if not stores:
            raise ValueError("MergedDataStoreView requires at least one store")
        self.stores = list(stores)
        self.type_name = type_name
        specs = {s.get_schema(type_name).to_spec() for s in self.stores}
        if len(specs) > 1:
            raise ValueError(f"Stores disagree on schema for {type_name!r}")

    def count(self, f: Union[str, ir.Filter] = "INCLUDE", auths=None) -> int:
        return sum(s.count(self.type_name, f, auths=auths) for s in self.stores)

    def query(self, f: Union[str, ir.Filter] = "INCLUDE",
              auths=None) -> FeatureTable:
        parts = [s.query(self.type_name, f, auths=auths).table
                 for s in self.stores]
        parts = [p for p in parts if len(p)]
        if not parts:
            return self.stores[0].query(self.type_name, "EXCLUDE").table
        return FeatureTable.concat(parts) if len(parts) > 1 else parts[0]


class RouteSelectorByAttribute:
    """Route on which attributes the filter references (≙
    RouteSelectorByAttribute): first route whose attribute set covers the
    filter's attributes wins; ``default`` catches the rest."""

    def __init__(self, routes: Sequence[tuple],
                 default: Optional[int] = None):
        """routes: (store_index, {attribute names}) pairs."""
        self.routes = [(i, set(attrs)) for i, attrs in routes]
        self.default = default

    def route(self, f: ir.Filter) -> Optional[int]:
        attrs = _filter_attributes(f)
        if attrs:
            for i, route_attrs in self.routes:
                if attrs <= route_attrs:
                    return i
        return self.default


class RoutedDataStoreView:
    """Route each query to exactly ONE store (≙ RoutedDataStoreView —
    merged views scan all stores; routed views pick one)."""

    def __init__(self, stores: Sequence[object], type_name: str, selector):
        self.stores = list(stores)
        self.type_name = type_name
        self.selector = selector

    def _store(self, f):
        i = self.selector.route(f)
        if i is None:
            raise ValueError(
                f"No route for query {f} (and no default configured)")
        return self.stores[i]

    def count(self, f: Union[str, ir.Filter] = "INCLUDE", auths=None) -> int:
        f = parse_ecql(f) if isinstance(f, str) else f
        return self._store(f).count(self.type_name, f, auths=auths)

    def query(self, f: Union[str, ir.Filter] = "INCLUDE", auths=None):
        f = parse_ecql(f) if isinstance(f, str) else f
        return self._store(f).query(self.type_name, f, auths=auths)
