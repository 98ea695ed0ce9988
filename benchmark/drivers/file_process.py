"""Entry driver: file to file through the processor's `process`
(tomatis_tpu_torch.process for the standard processor,
tomatis_tpu_torch.models.xfade.process for the crossfade one), FLAC in,
FLAC PCM_24 and the state CSV out, transport "auto". Job k takes input k
mod the number of inputs, so a mix of several tracks is processed in
turn."""
from __future__ import annotations

import os

from harness.driving import (Context, Job, file_answers, program_params,
                             timed_job)


class FileProcess:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.params = program_params(ctx.cell.config)
        if ctx.cell.config["processor"] == "standard":
            import tomatis_tpu_torch
            self.entry = tomatis_tpu_torch.process
        else:
            from tomatis_tpu_torch.models import xfade
            self.entry = xfade.process
        self.progress = ctx.spans.wrap("progress", lambda done, total: None)

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
            stats, out, csv_path = self._run(inputs.paths[i], f"job{k}")
            return inputs.seconds(i), stats, [(i, out, csv_path)]
        return timed_job(k, self.ctx.spans, "job", one)

    def answers(self, jobs: list) -> list:
        return file_answers(jobs)

    def release(self) -> None:
        self.entry = None


def make(ctx: Context) -> FileProcess:
    return FileProcess(ctx)
