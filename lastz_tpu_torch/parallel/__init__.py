"""Query-level parallelism: the farm-out over device slots in one
process (farm.py) and query sharding across processes under
torch.distributed (distributed.py), and the query-parallel
multi-device step over device slots (mesh.py).  Ports of
lastz_tpu/parallel/farm.py, distributed.py and mesh.py."""
