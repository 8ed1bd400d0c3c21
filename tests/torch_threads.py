"""One share of the host's cores for the port's torch in each test worker.

Under pytest-xdist every worker's torch starts one thread per core, and
the workers' threads together oversubscribe the cores: on an 8-core
host, six workers at eight threads each ran one sharded search 30 times
slower than six at one thread.  Every test file of the port imports
this module, so torch in a worker takes cores // workers threads, and
`env` gives the processes those tests start the same share
(OMP_NUM_THREADS, which torch reads when it is imported).  Outside
pytest-xdist nothing changes.
"""

import os

import torch

_workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
THREADS = (max(1, len(os.sched_getaffinity(0)) // int(_workers))
           if _workers else None)
if THREADS is not None:
    torch.set_num_threads(THREADS)


def env(**kw):
    """os.environ with `kw`, and OMP_NUM_THREADS at the worker's share
    (where it is not set already)."""
    out = dict(os.environ, **kw)
    if THREADS is not None:
        out.setdefault("OMP_NUM_THREADS", str(THREADS))
    return out
