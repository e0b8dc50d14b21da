"""LRU cache of SpmmPlans keyed on sparsity-pattern content.

A pruned weight's pattern is frozen for the lifetime of the model, so
every plan derived from it is built at most once per pattern and shared
by every layer and call that presents the same mask.  Keys are content
fingerprints of (row_ptr, col_ind) plus the resolved plan request and the
device the plan lives on.  Counters (hits / misses / evictions) let callers
assert that a hot path built no plan.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict

from repro_torch.core.config import PlanPolicy
from repro_torch.core.csr import CSR
from repro_torch.core.plan import SpmmPlan, build_plan, pattern_fingerprint

DEFAULT_MAXSIZE = 256


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    size: int = 0


class PlanCache:
    """Thread-safe LRU over ``build_plan`` results."""

    def __init__(self, maxsize: int = DEFAULT_MAXSIZE):
        self.maxsize = maxsize
        self._entries: OrderedDict[tuple, SpmmPlan] = OrderedDict()
        self._hits = self._misses = self._evictions = 0
        self._lock = threading.Lock()

    def get(self, a: CSR, policy: PlanPolicy | None = None) -> SpmmPlan:
        """Cached ``build_plan``: the engine's plan-once entry point.

        The key pins the static decisions through the same
        ``PlanPolicy.resolve`` that ``build_plan`` uses, so "auto" and its
        resolved form share one entry.
        """
        policy = policy if policy is not None else PlanPolicy()
        r = policy.resolve(a)
        key = (pattern_fingerprint(a), a.shape, a.nnz_pad, str(a.device),
               r.method, r.t, r.tl, r.l_pad, policy.with_transpose)
        with self._lock:
            plan = self._entries.get(key)
            if plan is not None:
                self._entries.move_to_end(key)
                self._hits += 1
                return plan
        # Build outside the lock — plans are pure functions of the key.
        plan = build_plan(a, policy, _resolved=r)
        with self._lock:
            self._misses += 1
            self._entries[key] = plan
            self._entries.move_to_end(key)
            while len(self._entries) > self.maxsize:
                self._entries.popitem(last=False)
                self._evictions += 1
        return plan

    def stats(self) -> CacheStats:
        with self._lock:
            return CacheStats(hits=self._hits, misses=self._misses,
                              evictions=self._evictions,
                              size=len(self._entries))

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._hits = self._misses = self._evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


_default_cache = PlanCache()


def default_cache() -> PlanCache:
    return _default_cache


def get_plan(a: CSR, policy: PlanPolicy | None = None) -> SpmmPlan:
    """Module-level convenience over the process-wide default cache."""
    return _default_cache.get(a, policy)


def cache_stats() -> CacheStats:
    return _default_cache.stats()


def clear_cache() -> None:
    _default_cache.clear()
