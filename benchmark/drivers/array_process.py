"""Entry driver: the in-memory API, the function the configuration names
under "array_entry" (a processor's `process_array`), called as
entry(x, sr, params, frames_per_chunk=..., device=...) at its default
transport ("f32"), on arrays made in set-up. Nothing is written to disk.
The outputs of a few jobs drawn from the seed, and of the last, are kept
for the check."""
from __future__ import annotations

from harness.check import Answer
from harness import spec
from harness.driving import Context, Job, program_params, sample_indices
from harness.driving import timed_job

KEEP_AMONG, KEEP_DRAWS = 8, 2


class ArrayProcess:
    def __init__(self, ctx: Context):
        self.ctx = ctx
        self.params = program_params(ctx.cell.config)
        self.entry = spec.program_object(ctx.cell.config, "array_entry")
        self.keep = sample_indices(ctx.seed, KEEP_AMONG, KEEP_DRAWS)
        self.last = None

    def _run(self, x):
        c = self.ctx
        with c.spans.span("entry.process_array"):
            return self.entry(x, c.inputs.sr, self.params,
                              frames_per_chunk=c.frames_per_chunk,
                              device=c.device)

    def warm(self) -> None:
        self._run(self.ctx.inputs.warm(0))

    def job(self, k: int) -> Job:
        inputs = self.ctx.inputs
        i = k % len(inputs)

        def one():
            y, stats = self._run(inputs.samples[i])
            return inputs.seconds(i), stats, [(i, y)]
        job = timed_job(k, self.ctx.spans, "job", one)
        # keep the drawn jobs' outputs and the newest one's
        if self.last is not None and self.last.index not in self.keep:
            self.last.outputs = []
        self.last = job
        return job

    def answers(self, jobs: list) -> list:
        return [Answer(f"job{j.index}", i, y=y)
                for j in jobs for i, y in j.outputs]

    def release(self) -> None:
        self.entry = None


def make(ctx: Context) -> ArrayProcess:
    return ArrayProcess(ctx)
