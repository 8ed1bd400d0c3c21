"""Query-level parallelism: the farm-out over device slots in one
process (farm.py) and query sharding across processes under
torch.distributed (distributed.py).  Ports of lastz_tpu/parallel/
farm.py and distributed.py; the target-sharded tier (lastz_tpu/
parallel/mesh.py) is not ported yet."""
