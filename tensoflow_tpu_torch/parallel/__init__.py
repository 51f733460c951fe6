"""Multi-device training of the port (counterpart of
tensoflow_tpu/parallel): ray-sharded data parallelism over
torch.distributed (sharding.py) and the multi-rank dry run (dryrun.py)."""
