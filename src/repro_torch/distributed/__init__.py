"""Distributed parts of the port: nnz-balanced sharded SpMM plans
(``repro_torch.distributed.spmm``: the per-shard loop and one shard a rank
over ``torch.distributed``), the fault-tolerance hooks of the reference's
``repro.distributed.fault`` (preemption, stragglers, step timing, retry),
and the model-parallel half: parameter, batch and cache placement over a
``DeviceMesh`` with the model's activation constraints (``sharding``) and
re-sharding a training state onto another mesh (``elastic``)."""
