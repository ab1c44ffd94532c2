"""Deterministic synthetic token pipeline.

Sequences follow a fixed seeded bigram Markov chain over the vocabulary, so
a language model has real structure to learn (loss decreases measurably in
a few hundred steps — used by examples/quickstart.py and the FT tests) and
every (step, host) batch is reproducible for elastic restarts: the stream
is addressed by step index, never by iterator state.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    branching: int = 8          # bigram successors per token


class SyntheticStream:
    def __init__(self, cfg: ArchConfig, shape: ShapeConfig,
                 dcfg: DataConfig = DataConfig()):
        self.cfg = cfg
        self.shape = shape
        self.dcfg = dcfg
        rng = np.random.default_rng(dcfg.seed)
        v = min(cfg.vocab_size, 4096)   # active vocab (keeps tables small)
        self.active_vocab = v
        self.successors = rng.integers(0, v, size=(v, dcfg.branching))

    def batch_at(self, step: int, *, batch_size: int | None = None) -> dict:
        b = batch_size or self.shape.global_batch
        t = self.shape.seq_len
        rng = np.random.default_rng(
            np.random.SeedSequence([self.dcfg.seed, step]))
        seq = np.empty((b, t + 1), dtype=np.int32)
        seq[:, 0] = rng.integers(0, self.active_vocab, size=b)
        choices = rng.integers(0, self.dcfg.branching, size=(b, t))
        for i in range(t):
            seq[:, i + 1] = self.successors[seq[:, i], choices[:, i]]
        batch = {"tokens": seq[:, :-1], "labels": seq[:, 1:]}
        if self.cfg.is_encoder_decoder:
            rngf = np.random.default_rng(
                np.random.SeedSequence([self.dcfg.seed, step, 1]))
            batch["frames"] = rngf.standard_normal(
                (b, t, self.cfg.d_model)).astype(np.float32)
            td = min(self.cfg.max_decoder_len, t)
            batch["tokens"] = batch["tokens"][:, :td]
            batch["labels"] = batch["labels"][:, :td]
        if self.cfg.mrope:
            pos = np.broadcast_to(np.arange(t, dtype=np.int32)[None, :], (b, t))
            batch["pos3"] = np.broadcast_to(pos[None], (3, b, t)).copy()
            rngv = np.random.default_rng(
                np.random.SeedSequence([self.dcfg.seed, step, 2]))
            batch["vision_embeds"] = rngv.standard_normal(
                (b, min(256, t), self.cfg.d_model)).astype(np.float32)
        return batch

    def host_batch_at(self, step: int, host: int, num_hosts: int) -> dict:
        """Host-sharded slice of the global batch (data-parallel loading)."""
        full = self.batch_at(step)
        per = self.shape.global_batch // num_hosts
        sl = slice(host * per, (host + 1) * per)
        out = {}
        for k, v in full.items():
            out[k] = v[:, sl] if k == "pos3" else v[sl]
        return out
