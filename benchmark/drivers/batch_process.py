"""Entry driver: a folder of files as one batch,
`tomatis_tpu_torch.process_batch(jobs, params, state_csv_paths=...)` on
one device, one lane per input, the transport as the program's
batch_transport picks it. A job is one batch of every input; it fails if
any lane fails. The job's stats are the lanes' stats and the program's
parallel.batch.LAST_TIMINGS of that call."""
from __future__ import annotations

import os

from harness.driving import (Context, Job, file_answers, program_params,
                             timed_job)


class BatchProcess:
    def __init__(self, ctx: Context):
        import tomatis_tpu_torch
        from tomatis_tpu_torch.parallel import batch
        self.ctx = ctx
        self.params = program_params(ctx.cell.config)
        self.entry = tomatis_tpu_torch.process_batch
        self.timings = batch.LAST_TIMINGS
        self.lanes = len(ctx.inputs)

    def _run(self, paths: list, tag: str):
        c = self.ctx
        d = os.path.join(c.workdir, tag)
        os.makedirs(d, exist_ok=True)
        outs = [os.path.join(d, f"lane{i}.flac") for i in range(len(paths))]
        csvs = [os.path.join(d, f"lane{i}.csv") for i in range(len(paths))]
        with c.spans.span("entry.process_batch"):
            lanes = self.entry(list(zip(paths, outs)), self.params,
                               frames_per_chunk=c.frames_per_chunk,
                               state_csv_paths=csvs, device=c.device)
        bad = [s["failed"] for s in lanes if s.get("failed")]
        if bad:
            raise RuntimeError(f"{len(bad)} lane(s) failed: {bad[0]}")
        return lanes, list(zip(range(len(paths)), outs, csvs))

    def warm(self) -> None:
        inputs = self.ctx.inputs
        self._run([inputs.warm(i) for i in range(len(inputs))], "warm")

    def job(self, k: int) -> Job:
        inputs = self.ctx.inputs

        def one():
            lanes, outputs = self._run(inputs.paths, f"job{k}")
            stats = {"lanes": lanes, "timings": dict(self.timings)}
            return (sum(inputs.seconds(i) for i in range(len(inputs))),
                    stats, outputs)
        return timed_job(k, self.ctx.spans, "job", one)

    def answers(self, jobs: list) -> list:
        return file_answers(jobs)

    def release(self) -> None:
        self.entry = None


def make(ctx: Context) -> BatchProcess:
    return BatchProcess(ctx)
