"""TuneDB: a versioned, backend-keyed, on-disk record of measured winners.

The paper ships one number — threshold 9.35, calibrated once on a K40c.
The crossover is a property of the hardware and the kernels, so this
module replaces the constant with *measurements*: every tuned pattern
gets a record of its merge/row-split timings (and every other registered
method's), the winning method, and the winning static parameters
(row-split ``l_pad``, merge chunk ``t``).

Resolution at plan-build time (``PlanPolicy.resolve``), all host-side:

1. **exact** — the pattern's content fingerprint has a record → use its
   method (and tuned ``l_pad``/``t``),
2. **class** — the pattern's binned ``(m, k, d, cv)`` signature matches
   tuned patterns → majority winner among them,
3. **threshold** — the §5.4 analytic rule with a threshold *calibrated
   from this DB's own timings* (the paper's 9.35 only when the DB has
   none).

The JSON schema is the reference's (``repro.tune.db``) field for field,
so a file either package writes loads in the other when ``backend=`` is
given.  The backend key differs on purpose: it names this implementation
and its device (``torch-cuda:<card name>``, ``torch-cpu``), so the port
never reads the JAX package's timings (``cpu:cpu``, ``tpu:…``) as its own,
nor the plain versions' timings on a card (``torch-cuda-plain:<card
name>``) as the card's kernels'.

``load`` is forgiving by design: a corrupt file, a schema-version mismatch,
a backend mismatch or a malformed entry degrades to an *empty* DB (with a
warning), so plan building falls back to the analytic heuristic instead
of failing a serving job over a stale artifact; a missing file raises.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import warnings

import numpy as np
import torch

from repro_torch.core.csr import CSR
from repro_torch.core.heuristic import Heuristic, calibrate
from repro_torch.core.plan import pattern_fingerprint

SCHEMA_VERSION = 1


def backend_key(device=None, impl: str | None = None) -> str:
    """Identity of the implementation and device the timings belong to:
    ``torch-cuda:<device name>`` for the CUDA kernels,
    ``torch-cuda-plain:<device name>`` for their plain versions timed on
    the card (``impl="torch"``), or ``torch-cpu``.  ``device`` None: the
    CUDA device when there is one, else the CPU."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        plain = "-plain" if impl == "torch" else ""
        return f"torch-cuda{plain}:{torch.cuda.get_device_name(dev)}"
    return f"torch-{dev.type}"


def _log2_bin(x: float) -> int:
    return int(round(math.log2(x))) if x > 0 else -1


_CV_EDGES = (0.1, 0.5, 1.0)     # regular | mild | irregular | heavy-tail


def class_signature(m: int, k: int, d: float, cv: float) -> str:
    """Binned pattern-class signature over (m, k, d, cv).

    Octave (log2) bins for the sizes and the mean row length, coarse
    imbalance bins for cv — wide enough that one tuned matrix covers its
    neighbours, narrow enough that the merge/row-split crossover (an
    octave-scale effect in ``d``) stays resolvable.
    """
    cv_bin = sum(cv >= e for e in _CV_EDGES)
    return (f"m{_log2_bin(m)}k{_log2_bin(k)}"
            f"d{_log2_bin(d)}cv{cv_bin}")


@dataclasses.dataclass
class TuneRecord:
    """Measured outcome for one sparsity pattern on one backend.

    ``method`` is the overall winner across every registered method (it
    may be ``"rowgroup"``; exact TuneDB hits replay it).
    ``merge_us``/``rowsplit_us`` always hold the core pair's timings — they
    anchor the class aggregates and the threshold calibration, which are
    two-way.  ``timings`` carries every method's best timing.
    """

    method: str                  # overall winner (a registered method name)
    merge_us: float
    rowsplit_us: float
    m: int
    k: int
    d: float                     # mean row length
    cv: float                    # row-length coefficient of variation
    n: int                       # dense B columns used for timing
    l_pad: int | None = None     # winning rowsplit pad (None: pattern max)
    t: int | None = None         # winning merge chunk size (None: default)
    name: str = ""               # corpus spec name, for reports
    timings: dict[str, float] | None = None  # per-method best, in us

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def oracle(self) -> str:
        """Winner of the core merge/rowsplit pair (calibration target)."""
        return "merge" if self.merge_us < self.rowsplit_us else "rowsplit"

    @property
    def signature(self) -> str:
        return class_signature(self.m, self.k, self.d, self.cv)


class TuneDB:
    """In-memory view of the tuning database (see module docstring)."""

    def __init__(self, backend: str | None = None):
        self.backend = backend or backend_key()
        self.entries: dict[str, TuneRecord] = {}
        self.threshold: float | None = None
        self.threshold_accuracy: float | None = None
        self._classes: dict[str, dict[str, float]] = {}
        self._digest: str | None = None

    # ------------------------------------------------------- mutation ---

    def record(self, fingerprint: str, rec: TuneRecord) -> None:
        old = self.entries.get(fingerprint)
        if old is not None:
            self._class_add(old, remove=True)
        self.entries[fingerprint] = rec
        self._class_add(rec)
        self._digest = None

    def _class_add(self, rec: TuneRecord, remove: bool = False) -> None:
        sgn = -1.0 if remove else 1.0
        agg = self._classes.setdefault(
            rec.signature, {"merge_wins": 0.0, "rowsplit_wins": 0.0,
                            "merge_us": 0.0, "rowsplit_us": 0.0})
        agg[f"{rec.oracle}_wins"] += sgn
        agg["merge_us"] += sgn * rec.merge_us
        agg["rowsplit_us"] += sgn * rec.rowsplit_us

    def calibrate_threshold(self) -> tuple[float, float]:
        """Fit the analytic-fallback threshold from this DB's timings."""
        if not self.entries:
            raise ValueError("cannot calibrate an empty TuneDB")
        recs = list(self.entries.values())
        thr, acc = calibrate(np.array([r.d for r in recs]),
                             np.array([r.rowsplit_us for r in recs]),
                             np.array([r.merge_us for r in recs]))
        self.threshold, self.threshold_accuracy = thr, acc
        self._digest = None
        return thr, acc

    # -------------------------------------------------------- queries ---

    def __len__(self) -> int:
        return len(self.entries)

    def lookup_exact(self, fingerprint: str) -> TuneRecord | None:
        return self.entries.get(fingerprint)

    def lookup_class(self, signature: str) -> str | None:
        agg = self._classes.get(signature)
        if agg is None or (agg["merge_wins"] + agg["rowsplit_wins"]) <= 0:
            return None
        if agg["merge_wins"] != agg["rowsplit_wins"]:
            return "merge" if agg["merge_wins"] > agg["rowsplit_wins"] \
                else "rowsplit"
        return "merge" if agg["merge_us"] <= agg["rowsplit_us"] \
            else "rowsplit"

    def heuristic(self) -> Heuristic:
        """Analytic fallback, calibrated from this DB when possible."""
        if self.threshold is not None:
            return Heuristic(threshold=self.threshold)
        return Heuristic()

    def lookup_class_for(self, a: CSR) -> str | None:
        """Class-rung lookup for a concrete pattern (no exact check)."""
        from repro_torch.matrices.stats import compute_stats

        s = compute_stats(a)
        return self.lookup_class(class_signature(s.m, s.k, s.d, s.cv))

    def pick(self, a: CSR, registered=None
             ) -> tuple[str | None, str, TuneRecord | None]:
        """The DB's rungs of the ladder for a concrete pattern:
        ``(method, rung, record)``.

        ``rung`` is ``"exact"`` (``record`` is the hit, whose ``t`` and
        ``l_pad`` a plan replays), ``"class"`` or ``"miss"`` (method
        None).  ``registered``: the method names the caller can run; an
        exact record or a class naming another drops to the next rung, the
        record with a warning.  ``PlanPolicy.resolve`` climbs the rest of
        the ladder.
        """
        rec = self.lookup_exact(pattern_fingerprint(a))
        if rec is not None and registered is not None \
                and rec.method not in registered:
            # A DB naming a method this process lacks drops to the next
            # rungs instead of failing every plan on this pattern.
            warnings.warn(
                f"TuneDB exact record names unregistered method "
                f"{rec.method!r} (registered: {', '.join(registered)}); "
                "falling back to class/heuristic resolution", stacklevel=3)
            rec = None
        if rec is not None:
            return rec.method, "exact", rec
        cls = self.lookup_class_for(a)
        if cls is not None and (registered is None or cls in registered):
            return cls, "class", None
        return None, "miss", None

    def resolve(self, a: CSR) -> tuple[str | None, str]:
        """Method for a concrete pattern: ``(method, source)``.

        ``source`` is ``"exact"``, ``"class"``, or ``"miss"`` (method
        None — the caller falls back to :meth:`heuristic`).
        """
        method, source, _ = self.pick(a)
        return method, source

    def choose(self, a: CSR) -> str:
        """Fully resolved method (resolve, then heuristic fallback)."""
        method, _ = self.resolve(a)
        return method if method is not None else self.heuristic().choose(a)

    def digest(self) -> str:
        """Content hash of the DB (changes with every record or
        calibration)."""
        if self._digest is None:
            blob = json.dumps(self.as_dict(), sort_keys=True)
            self._digest = hashlib.sha1(blob.encode()).hexdigest()[:16]
        return self._digest

    # ---------------------------------------------------- persistence ---

    def as_dict(self) -> dict:
        return {
            "schema_version": SCHEMA_VERSION,
            "backend": self.backend,
            "threshold": self.threshold,
            "threshold_accuracy": self.threshold_accuracy,
            "entries": {fp: r.as_dict()
                        for fp, r in sorted(self.entries.items())},
        }

    def save(self, path: str | os.PathLike) -> None:
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(self.as_dict(), f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str | os.PathLike, *,
             backend: str | None = None, strict: bool = False) -> TuneDB:
        """Load a DB for ``backend`` (default: :func:`backend_key`).

        Any defect — unreadable or corrupt JSON, schema-version mismatch,
        backend mismatch, malformed entry — returns an **empty** DB (with a
        warning), so callers degrade to the analytic heuristic.
        ``strict=True`` turns those defects into ``ValueError`` (the CLI
        uses it).  A missing file raises ``FileNotFoundError``.
        """
        expect = backend or backend_key()

        def _reject(msg: str) -> TuneDB:
            if strict:
                raise ValueError(f"TuneDB {path}: {msg}")
            warnings.warn(f"TuneDB {path}: {msg}; falling back to the "
                          "analytic heuristic", stacklevel=3)
            return cls(backend=expect)

        try:
            with open(path) as f:
                raw = json.load(f)
        except FileNotFoundError:
            raise
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
            return _reject(f"unreadable or corrupt ({e})")
        if not isinstance(raw, dict):
            return _reject("not a JSON object")
        if raw.get("schema_version") != SCHEMA_VERSION:
            return _reject(f"schema version {raw.get('schema_version')!r} "
                           f"!= supported {SCHEMA_VERSION}")
        if raw.get("backend") != expect:
            return _reject(f"built for backend {raw.get('backend')!r}, "
                           f"this process runs {expect!r}")
        db = cls(backend=expect)
        try:
            for fp, rd in raw.get("entries", {}).items():
                db.record(fp, TuneRecord(**rd))
        except TypeError as e:
            return _reject(f"malformed entry ({e})")
        db.threshold = raw.get("threshold")
        db.threshold_accuracy = raw.get("threshold_accuracy")
        db._digest = None
        return db
