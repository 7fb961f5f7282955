"""Prebuilt compression graphs.  This slice ports the numeric profile: one
``numeric_auto`` selector over a numeric column."""
from __future__ import annotations

from ..core.graph import GraphBuilder, Plan


def numeric_profile() -> Plan:
    g = GraphBuilder(1)
    g.select("numeric_auto", g.input(0))
    return g.build("numeric")
