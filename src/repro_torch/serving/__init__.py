"""Online serving: continuous batching over pre-built shape buckets.

    ladder = serving.BucketLadder.from_max(max_len=128, max_batch=8)
    server = serving.Server(forward, params, ladder).start()
    fut = server.submit(tokens)            # 1-D int array, any length
    out = fut.result(timeout=60)           # rows trimmed to true length
    assert server.recompiles() == 0        # ladder covered the stream
    server.stop(timeout=60)

``buckets`` holds the pure ladder/packer core, ``server`` the queue,
batcher, admission control and program warmup (one CUDA graph a bucket on
the card) and the lockstep mode of a server on every rank of a mesh
(``Lockstep``), ``loadgen`` the deterministic Poisson load generator.
"""
from . import loadgen
from .buckets import BucketLadder, PackedBatch, pack
from .server import (Lockstep, RequestFuture, RequestShed, Server,
                     ServerClosed)

__all__ = ["BucketLadder", "Lockstep", "PackedBatch", "RequestFuture",
           "RequestShed", "Server", "ServerClosed", "loadgen", "pack"]
