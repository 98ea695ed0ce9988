"""A cell's inputs, made from the seed by its mix's generator: float32
arrays for an "array" mix, PCM_24 FLAC files (written by the benchmark's
frozen codec) for a "flac" mix. The reference is handed exactly the
samples the program gets: the arrays, or the files' PCM_24 values over
2^23."""
from __future__ import annotations

import os

import numpy as np

from harness import spec

FULL_SCALE = 8388608.0


def to_pcm24(x: np.ndarray) -> np.ndarray:
    """float samples -> the int32 PCM_24 values a FLAC file holds."""
    return np.clip(np.rint(x * FULL_SCALE), -FULL_SCALE,
                   FULL_SCALE - 1).astype(np.int32)


class Inputs:
    def __init__(self, cell: spec.Cell, seed: int, workdir: str,
                 scale: float = 1.0):
        """scale shrinks every length (the CPU rehearsal)."""
        mix = dict(cell.mix)
        mix["lengths_s"] = [s * scale for s in mix["lengths_s"]]
        self.mix = mix
        self.sr = cell.config["sample_rate"]
        self.format = mix["format"]
        self.workdir = workdir
        self.warm_s = mix["warm_s"] * scale
        gen = spec.load_module("traffic", mix["generator"])
        arrays = gen.make(mix, cell.config, seed)
        if self.format == "array":
            self.samples = arrays
            self.paths = [None] * len(arrays)
        elif self.format == "flac":
            from reference import flaccodec
            self.samples = [to_pcm24(a) for a in arrays]
            del arrays
            self.paths = []
            for i, pcm in enumerate(self.samples):
                path = os.path.join(workdir, f"in{i}.flac")
                flaccodec.encode(path, pcm, self.sr)
                self.paths.append(path)
        else:
            raise ValueError(f"unknown input format {self.format!r}")
        self._warm: dict = {}

    def __len__(self) -> int:
        return len(self.samples)

    def seconds(self, i: int) -> float:
        return len(self.samples[i]) / self.sr

    def reference_input(self, i: int) -> np.ndarray:
        x = self.samples[i]
        if x.dtype == np.int32:
            return x.astype(np.float64) / FULL_SCALE
        return x

    def warm(self, i: int):
        """The first warm_s seconds of input i, in the input's own form
        (an array, or a FLAC file's path)."""
        if i not in self._warm:
            part = self.samples[i][:int(self.warm_s * self.sr)]
            if self.format == "array":
                self._warm[i] = part
            else:
                from reference import flaccodec
                path = os.path.join(self.workdir, f"warm{i}.flac")
                flaccodec.encode(path, part, self.sr)
                self._warm[i] = path
        return self._warm[i]
