"""Plan-once / execute-many engine: the per-pattern plan cache."""
from .cache import (CacheStats, PlanCache, cache_stats, clear_cache,
                    default_cache, get_plan)

__all__ = ["CacheStats", "PlanCache", "cache_stats", "clear_cache",
           "default_cache", "get_plan"]
