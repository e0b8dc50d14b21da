"""Plan-once / execute-many engine: the per-pattern plan cache, and the
per-shape program cache that online serving replays (one CUDA graph a
bucket on the card)."""
from .cache import (CacheStats, PlanCache, cache_stats, clear_cache,
                    default_cache, get_plan)
from .programs import (EagerProgram, GraphProgram, ProgramCache,
                       ProgramStats, bucket_program)

__all__ = ["CacheStats", "EagerProgram", "GraphProgram", "PlanCache",
           "ProgramCache", "ProgramStats", "bucket_program", "cache_stats",
           "clear_cache", "default_cache", "get_plan"]
