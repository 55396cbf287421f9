"""Catalog factory: config dict -> connector instances.

Reference analog: ``metadata/CatalogManager.java`` +
``connector/DefaultCatalogFactory.java`` — catalogs declared as
properties (``etc/catalog/*.properties``) instantiated through the
connector factories.  The config form here is a plain dict so it ships
to worker processes and (later) loads from files:
``{"tpch": {"connector": "tpch", "page_rows": 65536}}``.

The JAX engine's catalog factory (``trino_tpu/connectors/catalog.py``),
copied.
"""

from __future__ import annotations

from typing import Dict

from ..types import TrinoError
from .spi import Connector


def create_catalog(name: str, config: dict) -> Connector:
    kind = config.get("connector", name)
    options = {k: v for k, v in config.items() if k != "connector"}
    if kind == "tpch":
        from .tpch import TpchConnector

        return TpchConnector(catalog_name=name, **options)
    if kind == "memory":
        from .memory import MemoryConnector

        return MemoryConnector(catalog_name=name, **options)
    if kind == "blackhole":
        from .blackhole import BlackHoleConnector

        return BlackHoleConnector(catalog_name=name, **options)
    if kind == "tpcds":
        from .tpcds import TpcdsConnector

        return TpcdsConnector(catalog_name=name, **options)
    raise TrinoError(f"unknown connector '{kind}' for catalog '{name}'",
                     "CATALOG_NOT_FOUND")


def create_catalogs(config: Dict[str, dict]) -> Dict[str, Connector]:
    return {name: create_catalog(name, c) for name, c in config.items()}
