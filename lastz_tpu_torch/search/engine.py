"""The seed search engine with the port's device search.

SeedSearchEngine from lastz_tpu, whose `search` runs the port's
device_search (search/device_hits.py) and goes to lastz_tpu's host
engines (native sweep, batched numpy, scalar) only when the slice's
`supported()` gate declines the configuration; those runs are counted
in --stats as "seed host searches".  A device failure propagates.
"""

from __future__ import annotations

from lastz_tpu import stats as _stats
from lastz_tpu.search.engine import SeedSearchEngine as _HostEngine

from .device_hits import device_search


class SeedSearchEngine(_HostEngine):
    def __init__(self, *args, device, **kwargs):
        super().__init__(*args, **kwargs)
        self.device = device

    def search(self, start: int = 0, end: int = 0) -> int:
        self._dev_reported = False
        r = device_search(self, self.device, start, end)
        if r is not None:
            return r
        x = _stats.current.extra
        x["seed host searches"] = x.get("seed host searches", 0) + 1
        return super().search(start, end)
