"""Distributed helpers of the port: the fault-tolerance hooks of the
reference's ``repro.distributed.fault`` (preemption, stragglers, step
timing, retry).  Sharded plans and the rest of ``repro.distributed`` come
with the sharding slice."""
