"""Data makers, one module per data set, found by the configuration's
`data` key."""
from __future__ import annotations

import importlib
import re


def module(config: dict):
    """The data maker `rdfbench.data.<config["data"]>`."""
    name = config["data"]
    if not re.fullmatch(r"[a-z][a-z0-9_]*", name):
        raise ValueError(f"no data set {name!r}")
    return importlib.import_module(f"{__name__}.{name}")
