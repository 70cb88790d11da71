"""Duration strings: '30s' / '1m' / '500ms' / '2h' -> seconds.

Shared by the jobspec parser and the HTTP blocking-query layer (one
implementation so the accepted units cannot drift).
"""
from __future__ import annotations

import re

_RE = re.compile(r"(\d+(?:\.\d+)?)(ms|s|m|h)?")
_UNITS = {"ms": 0.001, "s": 1.0, "m": 60.0, "h": 3600.0}


def parse_duration(value) -> float:
    if isinstance(value, (int, float)):
        return float(value)
    m = _RE.fullmatch(str(value).strip())
    if not m:
        raise ValueError(f"invalid duration {value!r}")
    return float(m.group(1)) * _UNITS[m.group(2) or "s"]
