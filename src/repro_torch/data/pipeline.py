"""Deterministic synthetic token pipeline with checkpointable state.

Production shape without a corpus: a counter-seeded numpy generator emits
packed (tokens, labels) batches; state is one integer (the step), so
resuming from a checkpoint replays the exact stream (fault tolerance —
``runtime/checkpoint.py`` stores it).  Host sharding: each data-parallel
host slices its batch rows by ``host_id``.  The generator and its draws
are the reference's, so the batches equal its batches; they are yielded
as int32 tensors on the pipeline's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


@dataclasses.dataclass
class DataState:
    step: int = 0

    def to_dict(self) -> dict:
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d: dict) -> "DataState":
        return cls(step=int(d["step"]))


class SyntheticLM:
    """Zipf-ish synthetic LM stream: next-token = f(current) + noise, so
    models can actually drive loss below entropy."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = device
        self.state = DataState()

    def _batch_np(self, step: int):
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed << 32) | step)
        b = cfg.global_batch // cfg.n_hosts
        # Markov-ish stream: x_{t+1} = (a * x_t + b + noise) % V.
        x = np.empty((b, cfg.seq_len + 1), np.int32)
        x[:, 0] = rng.integers(0, cfg.vocab_size, b)
        noise = (rng.random((b, cfg.seq_len)) < 0.1)
        rand_tok = rng.integers(0, cfg.vocab_size, (b, cfg.seq_len))
        for t in range(cfg.seq_len):
            nxt = (x[:, t] * 31 + 17) % cfg.vocab_size
            x[:, t + 1] = np.where(noise[:, t], rand_tok[:, t], nxt)
        return {"tokens": x[:, :-1], "labels": x[:, 1:]}

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        batch = self._batch_np(self.state.step * self.cfg.n_hosts
                               + self.cfg.host_id)
        self.state.step += 1
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    # -- checkpointable iterator state -----------------------------------
    def state_dict(self) -> dict:
        return self.state.to_dict()

    def load_state_dict(self, d: dict) -> None:
        self.state = DataState.from_dict(d)
