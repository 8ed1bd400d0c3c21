"""Pipeline: the 95th percentile of the per-query wall seconds of the
window, from a query's handover to its last output byte. A per-layer
reading where a window completes too few queries for a stable tail."""

import numpy as np


def read(r):
    if not len(r["walls"]):
        return None
    return float(np.percentile(r["walls"], 95))
