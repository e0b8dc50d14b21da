"""Distributed parts of the port: nnz-balanced sharded SpMM plans
(``repro_torch.distributed.spmm``: the per-shard loop and one shard a rank
over ``torch.distributed``) and the fault-tolerance hooks of the
reference's ``repro.distributed.fault`` (preemption, stragglers, step
timing, retry).  The model-parallel half of ``repro.distributed`` —
parameter, batch and cache placement over a 2-D mesh (``sharding.py``)
and re-sharding a training state (``elastic.py``) — comes with the next
slice of the port."""
