"""Cluster configuration: the three config scopes.

Reference analog: airlift ``@Config`` binding over
``etc/config.properties`` (cluster scope), ``etc/catalog/*.properties``
(catalog scope, ``connector/StaticCatalogManager.java``), and per-query
session properties (``session_properties.py``). JSON sidecar files
configure access control and resource groups the way the reference's
file-based plugins do (``etc/access-control.json``,
``etc/resource-groups.json``).

The JAX engine's ``trino_tpu/config.py``, copied.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, Optional

from .connectors.catalog import create_catalog
from .connectors.spi import Connector
from .resource_groups import ResourceGroupManager
from .security import (ALLOW_ALL, RuleBasedAccessControl,
                       SystemAccessControl)


def parse_properties(text: str) -> Dict[str, str]:
    """Java-style .properties: key=value lines, # comments."""
    out: Dict[str, str] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        k, _, v = line.partition("=")
        out[k.strip()] = v.strip()
    return out


def _coerce(v: str):
    low = v.lower()
    if low in ("true", "false"):
        return low == "true"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


@dataclass
class ServerConfig:
    """Everything ``Server.start`` needs (reference: server/Server.java
    bootstrap over the airlift module graph)."""

    properties: Dict[str, str] = field(default_factory=dict)
    connectors: Dict[str, Connector] = field(default_factory=dict)
    access_control: SystemAccessControl = ALLOW_ALL
    resource_groups: Optional[ResourceGroupManager] = None

    @property
    def default_catalog(self) -> Optional[str]:
        return self.properties.get("default-catalog") \
            or next(iter(self.connectors), None)


def load_etc(etc_dir: str) -> ServerConfig:
    """Load an ``etc/`` directory: config.properties,
    catalog/*.properties, access-control.json, resource-groups.json."""
    cfg = ServerConfig()
    props_path = os.path.join(etc_dir, "config.properties")
    if os.path.exists(props_path):
        cfg.properties = parse_properties(open(props_path).read())

    catalog_dir = os.path.join(etc_dir, "catalog")
    if os.path.isdir(catalog_dir):
        for fn in sorted(os.listdir(catalog_dir)):
            if not fn.endswith(".properties"):
                continue
            name = fn[:-len(".properties")]
            props = parse_properties(
                open(os.path.join(catalog_dir, fn)).read())
            conf = {"connector": props.pop("connector.name", name)}
            conf.update({k: _coerce(v) for k, v in props.items()})
            cfg.connectors[name] = create_catalog(name, conf)

    ac_path = os.path.join(etc_dir, "access-control.json")
    if os.path.exists(ac_path):
        cfg.access_control = RuleBasedAccessControl.from_config(
            json.load(open(ac_path)))

    rg_path = os.path.join(etc_dir, "resource-groups.json")
    if os.path.exists(rg_path):
        cfg.resource_groups = ResourceGroupManager.from_config(
            json.load(open(rg_path)))
    return cfg
