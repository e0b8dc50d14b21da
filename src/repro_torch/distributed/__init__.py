"""Distributed helpers of the port.  Only ``fault.retry`` so far; sharded
plans and the rest of the reference's ``repro.distributed`` come with the
sharding slice."""
