"""LRU cache of SpmmPlans keyed on sparsity-pattern content.

A pruned weight's pattern is frozen for the lifetime of the model, so
every plan derived from it is built at most once per pattern and shared
by every layer and call that presents the same mask.  Canonical keys are
content fingerprints of (row_ptr, col_ind) plus the resolved plan request
and the device the plan lives on; a raw-request alias map answers a
repeated request without resolving it again, as the reference's
(``repro.engine.cache``) does.

The counters live on the global metrics registry, one ``cache`` label per
instance: ``plan_cache_events_total{cache,event}`` (hit / miss / eviction
/ alias_eviction) and the ``plan_cache_size{cache}`` /
``plan_cache_aliases{cache}`` gauges; :meth:`PlanCache.stats` is their
attribute view.  Callers assert against them that a hot path built no
plan.  While tracing is on, ``cache.hit`` / ``cache.miss`` /
``cache.eviction`` events and a ``plan.build`` span land in the trace;
``REPRO_VERIFY_PLANS=1`` re-verifies every plan served from the cache.
A request with ``PlanPolicy.shards`` set gets a ``ShardedSpmmPlan``
(``repro_torch.distributed.spmm``): one entry keyed on the global pattern
and the shard spec, each shard's plan an entry of its own.

Swapping the process-default TuneDB (:func:`set_tunedb`) can never serve a
plan resolved against the old one: an "auto" request's raw key holds the
DB's content ``digest()``, so another DB misses the alias map and
resolves afresh; the canonical key holds the *resolved* request (method,
``t``, ``tl``, ``l_pad``), so a DB that picks differently gives another
entry and one that picks alike shares it.
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
from collections import OrderedDict

from repro_torch.analysis import _flags as _verify_flags
from repro_torch.core.config import PlanPolicy
from repro_torch.core.csr import CSR
from repro_torch.core.plan import SpmmPlan, build_plan, pattern_fingerprint
from repro_torch.obs import registry as _metrics
from repro_torch.obs import trace as _trace

DEFAULT_MAXSIZE = 256
ALIASES_PER_ENTRY = 4

_cache_events = _metrics.counter(
    "plan_cache_events_total", "PlanCache events by cache instance",
    labels=("cache", "event"))
_cache_size = _metrics.gauge(
    "plan_cache_size", "live entries per PlanCache", labels=("cache",))
_cache_alias_size = _metrics.gauge(
    "plan_cache_aliases", "live alias-map entries per PlanCache",
    labels=("cache",))

_cache_ids = itertools.count()


def _verify_hit(plan: SpmmPlan, a: CSR) -> None:
    """REPRO_VERIFY_PLANS hook on cache hits: misses verify inside
    ``build_plan`` itself, but a hit serves a stored plan keyed by content
    fingerprint -- re-verify it against the CSR actually presented, so a
    fingerprint collision or stale alias fails here, not in a kernel.  A
    host copy of the plan: plans are attached before any CUDA graph
    capture (serving warmup), never fetched inside one."""
    from repro_torch.analysis.planlint import check_plan
    check_plan(plan, a)


# Process-wide empirical tuning database (repro_torch.tune.TuneDB).  When
# set, every "auto" plan request resolves its method through measurements
# (exact pattern -> pattern class -> calibrated threshold) instead of the
# paper's fixed K40c threshold.  Consulted at plan build only.
_default_tunedb = None


def set_tunedb(db) -> None:
    """Install (or clear, with None) the process-default TuneDB."""
    global _default_tunedb
    _default_tunedb = db


def current_tunedb():
    return _default_tunedb


def load_tunedb(path, **kw):
    """Load a TuneDB from ``path`` and install it as the process default.

    Forgiving like ``TuneDB.load``: a corrupt or mismatched file installs
    an empty DB (with a warning), so plan building falls back to the
    analytic heuristic; a missing file raises.
    """
    from repro_torch.tune.db import TuneDB

    db = TuneDB.load(path, **kw)
    set_tunedb(db)
    return db


def _heuristic_key(policy: PlanPolicy):
    """What an "auto" request's method depends on beyond the pattern: the
    heuristic's threshold and the TuneDB's content digest."""
    if policy.method != "auto":
        return None
    db = policy.resolved_tunedb()
    return (policy.heuristic.threshold
            if policy.heuristic is not None else None,
            db.digest() if db is not None else None)


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    size: int = 0
    aliases: int = 0
    alias_evictions: int = 0


class PlanCache:
    """Thread-safe LRU over ``build_plan`` results."""

    def __init__(self, maxsize: int = DEFAULT_MAXSIZE,
                 name: str | None = None):
        self.maxsize = maxsize
        # The metric label distinguishing this instance's counters on the
        # global registry (the process-default cache is "default").
        self.name = name if name is not None else f"cache{next(_cache_ids)}"
        self._c_hit = _cache_events.labels(cache=self.name, event="hit")
        self._c_miss = _cache_events.labels(cache=self.name, event="miss")
        self._c_evict = _cache_events.labels(cache=self.name,
                                             event="eviction")
        self._c_alias_evict = _cache_events.labels(
            cache=self.name, event="alias_eviction")
        self._g_size = _cache_size.labels(cache=self.name)
        self._g_aliases = _cache_alias_size.labels(cache=self.name)
        # The alias map is its own (key-only) LRU of ALIASES_PER_ENTRY x
        # maxsize: raw request keys embed per-request attributes (heuristic
        # thresholds, TuneDB digests), so a long-lived server cycling those
        # would otherwise grow it without bound while the plan LRU stays
        # capped.
        self.alias_maxsize = ALIASES_PER_ENTRY * maxsize
        self._entries: OrderedDict[tuple, SpmmPlan] = OrderedDict()
        # raw (unresolved) request key -> canonical key, so a repeated
        # request skips PlanPolicy.resolve (and its host reads) entirely.
        self._aliases: OrderedDict[tuple, tuple] = OrderedDict()
        self._lock = threading.Lock()

    def _alias_insert(self, raw: tuple, key: tuple) -> None:
        # Callers hold self._lock.
        self._aliases[raw] = key
        self._aliases.move_to_end(raw)
        while len(self._aliases) > self.alias_maxsize:
            self._aliases.popitem(last=False)
            self._c_alias_evict.inc()
        self._g_aliases.set(len(self._aliases))

    def _hit(self, plan: SpmmPlan, a: CSR, alias: bool) -> SpmmPlan:
        # Callers hold self._lock.
        self._c_hit.inc()
        if _trace._enabled:
            _trace.event("cache.hit", cat="cache", cache=self.name,
                         alias=alias, method=plan.meta.method)
        if _verify_flags.verify_plans:
            _verify_hit(plan, a)
        return plan

    def get(self, a: CSR, policy: PlanPolicy | None = None):
        """Cached ``build_plan``: the engine's plan-once entry point.

        With ``policy.shards`` set, the cached ``ShardedSpmmPlan``
        (:meth:`_get_sharded`).

        Canonical keys pin down the static decisions through the same
        ``PlanPolicy.resolve`` that ``build_plan`` uses, so "auto" and its
        resolved form share one entry.  A raw-request alias map makes a
        repeated request O(1): it resolves nothing (no ladder rung, no
        ``l_pad`` scan) and returns the plan its first resolution keyed
        (the fingerprint itself is memoized per CSR object).
        """
        policy = policy if policy is not None else PlanPolicy()
        if policy.shards is not None:
            return self._get_sharded(a, policy)
        hkey = _heuristic_key(policy)
        fp, device = pattern_fingerprint(a), str(a.device)
        raw = (fp, a.shape, a.nnz_pad, device, policy.method, hkey,
               policy.t, policy.tl, policy.l_pad, policy.with_transpose)
        with self._lock:
            canonical = self._aliases.get(raw)
            plan = self._entries.get(canonical) if canonical else None
            if plan is not None:
                self._entries.move_to_end(canonical)
                self._aliases.move_to_end(raw)
                return self._hit(plan, a, alias=True)
        r = policy.resolve(a)
        key = (fp, a.shape, a.nnz_pad, device, r.method, r.t, r.tl,
               r.l_pad, policy.with_transpose)
        with self._lock:
            plan = self._entries.get(key)
            if plan is not None:
                self._entries.move_to_end(key)
                self._alias_insert(raw, key)
                return self._hit(plan, a, alias=False)
        # Build outside the lock -- plans are pure functions of the key.
        if _trace._enabled:
            _trace.event("cache.miss", cat="cache", cache=self.name,
                         method=r.method)
        with _trace.span("plan.build", cat="plan", method=r.method,
                         m=int(a.shape[0]), k=int(a.shape[1]),
                         nnz_pad=int(a.nnz_pad), t=r.t, tl=r.tl,
                         l_pad=r.l_pad):
            plan = build_plan(a, policy, _resolved=r)
        with self._lock:
            self._c_miss.inc()
            self._entries[key] = plan
            self._entries.move_to_end(key)
            self._alias_insert(raw, key)
            self._evict_over()
            self._g_size.set(len(self._entries))
            self._g_aliases.set(len(self._aliases))
        return plan

    def _get_sharded(self, a: CSR, policy: PlanPolicy):
        """Cached sharded-plan build (``policy.shards`` set).

        The sharded plan is one entry keyed on the *global* pattern plus
        the whole shard spec (count, dim, axis, mesh), while every
        per-shard local plan lands as its own entry keyed on the shard's
        fingerprint (``build_sharded_plan`` funnels them back through
        :meth:`get`, into the same LRU).  Because the spec is in the key,
        re-sharding the same matrix with another count or mesh builds a
        sibling entry: it can never poison, nor be served from, the other.
        """
        spec = policy.shards
        key = (pattern_fingerprint(a), a.shape, a.nnz_pad, str(a.device),
               "sharded", spec.resolved_n(), spec.dim, spec.axis, spec.mesh,
               policy.method, _heuristic_key(policy), policy.t, policy.tl,
               policy.l_pad, policy.with_transpose)
        with self._lock:
            plan = self._entries.get(key)
            if plan is not None:
                self._entries.move_to_end(key)
                self._c_hit.inc()
                if _trace._enabled:
                    _trace.event("cache.hit", cat="cache", cache=self.name,
                                 alias=False, sharded=True)
                if _verify_flags.verify_plans:
                    _verify_hit(plan, a)
                return plan
        # Build outside the lock; the per-shard plans recurse through
        # self.get (each takes the lock for its own entry).
        from repro_torch.distributed.spmm import build_sharded_plan

        if _trace._enabled:
            _trace.event("cache.miss", cat="cache", cache=self.name,
                         sharded=True)
        plan = build_sharded_plan(a, policy, cache=self)
        with self._lock:
            self._c_miss.inc()
            self._entries[key] = plan
            self._entries.move_to_end(key)
            self._evict_over()
            self._g_size.set(len(self._entries))
            self._g_aliases.set(len(self._aliases))
        return plan

    def _evict_over(self) -> None:
        # Callers hold self._lock.
        while len(self._entries) > self.maxsize:
            evicted, _ = self._entries.popitem(last=False)
            self._aliases = OrderedDict(
                (r, c) for r, c in self._aliases.items() if c != evicted)
            self._c_evict.inc()
            if _trace._enabled:
                _trace.event("cache.eviction", cat="cache",
                             cache=self.name)

    def stats(self) -> CacheStats:
        """The attribute view of this instance's registry counters."""
        return CacheStats(
            hits=self._c_hit.value, misses=self._c_miss.value,
            evictions=self._c_evict.value,
            size=int(self._g_size.value),
            aliases=int(self._g_aliases.value),
            alias_evictions=self._c_alias_evict.value)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._aliases.clear()
            for c in (self._c_hit, self._c_miss, self._c_evict,
                      self._c_alias_evict, self._g_size, self._g_aliases):
                c.reset()

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


_default_cache = PlanCache(name="default")


def default_cache() -> PlanCache:
    return _default_cache


def get_plan(a: CSR, policy: PlanPolicy | None = None):
    """Module-level convenience over the process-wide default cache."""
    return _default_cache.get(a, policy)


def cache_stats() -> CacheStats:
    return _default_cache.stats()


def clear_cache() -> None:
    _default_cache.clear()
