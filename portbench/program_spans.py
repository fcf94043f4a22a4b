"""What the per-layer readers take from the port's own span export
(`utils/profiling.Recorder.export()`, which a driver leaves in its
readings as `program`): the device ms of the spans of one name.  A run
whose program has no such span (an earlier program) reads None."""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional


def device_ms(r: Dict, name: str) -> List[float]:
    spans = (r.get("program") or {}).get("spans") or []
    return [s["device_ms"] for s in spans if s["name"] == name and s["device_ms"] is not None]


def median_device_ms(r: Dict, name: str) -> Optional[float]:
    ms = device_ms(r, name)
    return statistics.median(ms) if ms else None
