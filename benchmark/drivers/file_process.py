"""Entry driver: file to file through the function the configuration
names under "entry" (tomatis_tpu_torch:process for the standard
processor, tomatis_tpu_torch.models.xfade:process for the crossfade one),
called as entry(in_path, out_path, params, state_csv_path=...,
frames_per_chunk=..., progress=..., device=...): FLAC in, FLAC PCM_24 and
the state CSV out, transport "auto". Job k takes input k mod the number
of inputs, so a mix of several tracks is processed in turn; of each
input the check gets one round's outputs drawn from the seed and the
newest (harness.driving.OutputSlots)."""
from __future__ import annotations

import os

from harness import spec
from harness.driving import (Context, Job, OutputSlots, file_answers,
                             program_params, timed_job)


class FileProcess:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.params = program_params(ctx.cell.config)
        self.entry = spec.program_object(ctx.cell.config, "entry")
        self.progress = ctx.spans.wrap("progress", lambda done, total: None)
        self.slots = OutputSlots(ctx.seed, len(ctx.inputs))

    def _run(self, in_path: str, tag: str):
        c = self.ctx
        out = os.path.join(c.workdir, f"{tag}.flac")
        csv_path = os.path.join(c.workdir, f"{tag}.csv")
        with c.spans.span("entry.process"):
            stats = self.entry(in_path, out, self.params,
                               state_csv_path=csv_path,
                               frames_per_chunk=c.frames_per_chunk,
                               progress=self.progress, device=c.device)
        return stats, out, csv_path

    def warm(self) -> None:
        self._run(self.ctx.inputs.warm(0), "warm")

    def job(self, k: int) -> Job:
        inputs = self.ctx.inputs
        i = k % len(inputs)

        def one():
            stats, out, csv_path = self._run(inputs.paths[i],
                                             self.slots.tag(k))
            return inputs.seconds(i), stats, [(i, out, csv_path)]
        return timed_job(k, self.ctx.spans, "job", one)

    def answers(self, jobs: list) -> list:
        return file_answers(jobs)

    def release(self) -> None:
        self.entry = None


def make(ctx: Context) -> FileProcess:
    return FileProcess(ctx)
