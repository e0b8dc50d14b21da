"""Deterministic data of the port (the reference's ``repro.data``)."""
from .pipeline import DataConfig, PackedFileSource, SyntheticLM, make_source

__all__ = ["DataConfig", "PackedFileSource", "SyntheticLM", "make_source"]
