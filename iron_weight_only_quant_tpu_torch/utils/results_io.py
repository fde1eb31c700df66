"""Valid-JSON results files (port of ``utils/results_io.py``).

The reference appends whole JSON objects to one file (main.py:422 ``open(...,
"a")``), producing concatenated invalid JSON.  Here results accumulate in a
single JSON object keyed by config name, re-written atomically.
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any, Dict


def read_results(path: str) -> Dict[str, Any]:
    p = Path(path)
    if not p.exists():
        return {}
    return json.loads(p.read_text())


def append_results(path: str, new: Dict[str, Any]) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    merged = read_results(path)
    merged.update(new)
    fd, tmp = tempfile.mkstemp(dir=str(p.parent), suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(merged, f, indent=2)
    os.replace(tmp, str(p))
