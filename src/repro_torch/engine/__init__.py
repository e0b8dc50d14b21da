"""Plan-once / execute-many engine: the per-pattern plan cache, and the
per-shape program cache that online serving replays (one CUDA graph a
bucket on the card), and the process-default TuneDB that "auto" plans
resolve through (``load_tunedb``)."""
from .cache import (CacheStats, PlanCache, cache_stats, clear_cache,
                    current_tunedb, default_cache, get_plan, load_tunedb,
                    set_tunedb)
from .programs import (EagerProgram, GraphProgram, ProgramCache,
                       ProgramStats, bucket_program)

__all__ = ["CacheStats", "EagerProgram", "GraphProgram", "PlanCache",
           "ProgramCache", "ProgramStats", "bucket_program", "cache_stats",
           "clear_cache", "current_tunedb", "default_cache", "get_plan",
           "load_tunedb", "set_tunedb"]
