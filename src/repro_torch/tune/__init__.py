"""Empirical autotuning of the port: measured kernel selection with a
persistent, device-keyed DB (a copy of the reference's ``repro.tune``).

    # build the database once per card
    python -m repro_torch.tune --suite paper --out tune.json

    # plan building then resolves methods from measurements
    from repro_torch import engine
    engine.load_tunedb("tune.json")
    plan = engine.get_plan(a)       # exact -> class -> calibrated threshold

See ``repro_torch.tune.db`` for the resolution ladder and the on-disk
schema, ``repro_torch.tune.autotune`` for what exactly gets timed.
"""
from .autotune import tune_pattern, tune_suite
from .db import (SCHEMA_VERSION, TuneDB, TuneRecord, backend_key,
                 class_signature)
from .timing import TimingResult, timeit

__all__ = [
    "tune_pattern", "tune_suite",
    "SCHEMA_VERSION", "TuneDB", "TuneRecord", "backend_key",
    "class_signature",
    "TimingResult", "timeit",
]
