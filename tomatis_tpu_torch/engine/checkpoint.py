"""Chunk-granular checkpoint/resume for the streaming engine (a copy of
tomatis_tpu/engine/checkpoint.py: numpy only, the same .npz layout, so a
checkpoint names its state with the reference's keys).

The stream's entire sequential state is tiny (SURVEY §5): the gate carry,
the crossfade alpha, the OLA sample/window tails, the undrained output
bytes and the flush-plan cursor. This module persists exactly that (plus
sink offsets) after every N chunks, atomically, so an interrupted
hour-long job resumes from the last checkpoint instead of restarting.

State is stored as one .npz (atomic rename) whose `meta` entry carries a
config fingerprint — resuming with different parameters is refused.
"""
from __future__ import annotations

import json
import os

import numpy as np


class CheckpointManager:
    def __init__(self, path, config: dict, every_chunks: int = 8):
        self.path = str(path)
        self.config = dict(config)
        self.every = max(1, int(every_chunks))
        self._since = 0

    def load(self) -> dict | None:
        """Return the saved state if present and config-compatible."""
        if not os.path.exists(self.path):
            return None
        with np.load(self.path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            if meta["config"] != self.config:
                raise ValueError(
                    "checkpoint was written with different parameters; "
                    "delete it to start over: " + self.path)
            state = {k: z[k] for k in z.files if k != "meta"}
        state["__meta__"] = meta
        return state

    def maybe_save(self, state: dict, force: bool = False):
        self._since += 1
        if not force and self._since < self.every:
            return False
        self._since = 0
        meta = dict(config=self.config,
                    scalars=state.pop("__scalars__", {}))
        tmp = self.path + ".tmp.npz"  # np.savez appends .npz itself
        np.savez(tmp[:-4], meta=json.dumps(meta),
                 **{k: np.asarray(v) for k, v in state.items()})
        os.replace(tmp, self.path)
        return True

    def clear(self):
        if os.path.exists(self.path):
            os.remove(self.path)
