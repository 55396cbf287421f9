"""Access control.

Reference analog: ``core/trino-spi/.../security/SystemAccessControl.java``
+ ``security/AccessControlManager.java`` and the file-based rule engine in
``lib/trino-plugin-toolkit`` (catalog/schema/table rules, first match
wins). The engine consults the chain at analysis/execution boundaries:
query admission, table read (with column set), writes, session-property
changes.

The JAX engine's ``trino_tpu/security.py``, copied.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from .types import TrinoError


class AccessDeniedError(TrinoError):
    def __init__(self, message: str):
        super().__init__(f"Access Denied: {message}", "PERMISSION_DENIED")


class SystemAccessControl:
    """Default-allow base (reference: SystemAccessControl's default
    methods). Override to restrict."""

    def check_can_execute_query(self, user: str):
        pass

    def check_can_select(self, user: str, catalog: str, schema: str,
                         table: str, columns: Sequence[str]):
        pass

    def check_can_insert(self, user: str, catalog: str, schema: str,
                         table: str):
        pass

    def check_can_delete(self, user: str, catalog: str, schema: str,
                         table: str):
        pass

    def check_can_create_table(self, user: str, catalog: str,
                               schema: str, table: str):
        pass

    def check_can_drop_table(self, user: str, catalog: str, schema: str,
                             table: str):
        pass

    def check_can_set_session_property(self, user: str, name: str):
        pass


ALLOW_ALL = SystemAccessControl()


@dataclass
class TableRule:
    """One rule (reference: file-based access control's table rules).
    Regexes anchor-match; ``privileges`` from
    {SELECT, INSERT, DELETE, OWNERSHIP}; ``columns`` optionally narrows
    SELECT to a column allowlist."""

    user: str = ".*"
    catalog: str = ".*"
    schema: str = ".*"
    table: str = ".*"
    privileges: List[str] = field(default_factory=list)
    columns: Optional[List[str]] = None

    def matches(self, user, catalog, schema, table) -> bool:
        return bool(re.fullmatch(self.user, user)
                    and re.fullmatch(self.catalog, catalog or "")
                    and re.fullmatch(self.schema, schema or "")
                    and re.fullmatch(self.table, table or ""))


class RuleBasedAccessControl(SystemAccessControl):
    """First matching rule decides; no match denies (the reference
    file-based semantics)."""

    def __init__(self, rules: Sequence[TableRule],
                 query_users: str = ".*"):
        self.rules = list(rules)
        self.query_users = query_users

    @classmethod
    def from_config(cls, doc: dict) -> "RuleBasedAccessControl":
        rules = [TableRule(
            user=r.get("user", ".*"),
            catalog=r.get("catalog", ".*"),
            schema=r.get("schema", ".*"),
            table=r.get("table", ".*"),
            privileges=[p.upper() for p in r.get("privileges", [])],
            columns=r.get("columns"),
        ) for r in doc.get("tables", [])]
        return cls(rules, doc.get("query_users", ".*"))

    def _rule(self, user, catalog, schema, table) -> Optional[TableRule]:
        for r in self.rules:
            if r.matches(user, catalog, schema, table):
                return r
        return None

    def check_can_execute_query(self, user: str):
        if not re.fullmatch(self.query_users, user):
            raise AccessDeniedError(f"user {user} cannot execute queries")

    def _check(self, priv, user, catalog, schema, table):
        r = self._rule(user, catalog, schema, table)
        if r is None or (priv not in r.privileges
                         and "OWNERSHIP" not in r.privileges):
            raise AccessDeniedError(
                f"user {user} cannot {priv} {catalog}.{schema}.{table}")
        return r

    def check_can_select(self, user, catalog, schema, table, columns):
        r = self._check("SELECT", user, catalog, schema, table)
        if r.columns is not None:
            blocked = [c for c in columns if c not in r.columns]
            if blocked:
                raise AccessDeniedError(
                    f"user {user} cannot select columns {blocked} from "
                    f"{catalog}.{schema}.{table}")

    def check_can_insert(self, user, catalog, schema, table):
        self._check("INSERT", user, catalog, schema, table)

    def check_can_delete(self, user, catalog, schema, table):
        self._check("DELETE", user, catalog, schema, table)

    def check_can_create_table(self, user, catalog, schema, table):
        self._check("OWNERSHIP", user, catalog, schema, table)

    def check_can_drop_table(self, user, catalog, schema, table):
        self._check("OWNERSHIP", user, catalog, schema, table)
