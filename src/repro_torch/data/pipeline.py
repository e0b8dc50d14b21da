"""Deterministic, shard-aware, resumable data (the reference's
``repro.data.pipeline``).

A batch is a pure function of ``(seed, step, shard)``: there is no
iterator state to checkpoint, and a restarted run replays exactly the
batches it has not trained on.  Two sources:

* ``SyntheticLM``: a counter-based splitmix64 hash to tokens, the
  reference's numpy arithmetic, so both packages give the same tokens;
* ``PackedFileSource``: a memory-mapped flat int32 token file, sliced by
  index.

``batch_at`` returns CPU tensors (tokens and labels int64); the caller
moves them to its device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    input_mode: str = "tokens"     # tokens | embeddings (stub frontends)
    d_model: int = 0               # for embeddings mode


def _lm_batch(rows: np.ndarray) -> dict:
    """(b, s + 1) tokens → tokens and next-token labels, int64 tensors."""
    rows = rows.astype(np.int64)
    return {"tokens": torch.from_numpy(rows[:, :-1].copy()),
            "labels": torch.from_numpy(rows[:, 1:].copy())}


class SyntheticLM:
    """Counter-based generator: tokens[i] = hash(seed, step, row, i)."""

    def __init__(self, cfg: DataConfig, shard_index: int = 0,
                 num_shards: int = 1):
        if cfg.global_batch % num_shards:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split into {num_shards} shards")
        self.cfg = cfg
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        with np.errstate(over="ignore"):  # uint64 hash wraps by design
            rows = (np.arange(self.local_batch, dtype=np.uint64)
                    + self.shard_index * self.local_batch)
            cols = np.arange(cfg.seq_len + 1, dtype=np.uint64)
            # splitmix64-style hash of (seed, step, row, col)
            x = (np.uint64(cfg.seed) * np.uint64(0x9E3779B97F4A7C15)
                 ^ np.uint64(step) * np.uint64(0xBF58476D1CE4E5B9))
            h = (rows[:, None] * np.uint64(0x94D049BB133111EB)
                 ^ cols[None, :] ^ x)
            h ^= h >> np.uint64(31)
            h *= np.uint64(0xBF58476D1CE4E5B9)
            h ^= h >> np.uint64(27)
            toks = (h % np.uint64(cfg.vocab_size)).astype(np.int32)
        batch = _lm_batch(toks)
        if cfg.input_mode == "embeddings":
            # stub modality frontend: pseudo-embeddings from the token hash
            f = (toks[:, :-1, None]
                 * np.arange(1, cfg.d_model + 1, dtype=np.int64)) % 4096
            emb = f.astype(np.float32) / 2048.0 - 1.0
            batch = {"embeds": torch.from_numpy(emb),
                     "labels": batch["labels"]}
        return batch


class PackedFileSource:
    """Flat binary int32 token file, deterministic index-based slicing."""

    def __init__(self, path: str, cfg: DataConfig, shard_index: int = 0,
                 num_shards: int = 1):
        self.tokens = np.memmap(path, dtype=np.int32, mode="r")
        self.cfg = cfg
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        self.n_windows = (len(self.tokens) - 1) // cfg.seq_len
        if self.n_windows < 1:
            raise ValueError(f"{path}: {len(self.tokens)} tokens hold no "
                             f"window of {cfg.seq_len} + 1")

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        base = step * cfg.global_batch + self.shard_index * self.local_batch
        idx = (base + np.arange(self.local_batch)) % self.n_windows
        rows = np.stack([
            self.tokens[i * cfg.seq_len: i * cfg.seq_len + cfg.seq_len + 1]
            for i in idx])
        return _lm_batch(rows)


def make_source(cfg: DataConfig, path: str | None = None,
                shard_index: int = 0, num_shards: int = 1):
    if path:
        return PackedFileSource(path, cfg, shard_index, num_shards)
    return SyntheticLM(cfg, shard_index, num_shards)
