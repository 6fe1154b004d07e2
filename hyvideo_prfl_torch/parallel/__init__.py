"""Multi-GPU layer of the port: the (data, sp) process mesh, sequence
parallelism and the FSDP strategies (parallel/sharding.py)."""
