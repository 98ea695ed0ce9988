"""Entry driver: the audited job, as a clinic checks a programme before
handing it on. Per job, on input k mod the number of inputs:
  1. the configuration's "entry" (tomatis_tpu_torch:process) file to file,
     as drivers/file_process.py calls it;
  2. the params sidecar that `tomatis-torch process` writes beside its
     output (cli/_sidecar.py::write_sidecar of cli/process.py::
     sidecar_fields);
  3. the Layer-1 validator and 4. the +-15 dB verifier that the workload
     names under "validate_entry" and "verify_entry", each called with the
     arguments its command gives it: the command's parser defaults
     (cli/validate.py, cli/verify_15db.py) with the sidecar laid over
     them (cli/_sidecar.py::apply_params); settings that differ from the
     configuration's "audit" group end the run. They write their spectrum
     CSVs, the verifier's report and, where matplotlib imports, the PNGs
     beside the output.
The job's stats are process()'s, with stats["audit"] = {"validate":
{timings, counters}, "verify15": {...}} of the two verifiers (no
counters where the program's verifiers keep none). Its further outputs,
which reference/verify_ref.py reads: both spectrum CSVs, the verifier's
report, and each tool's results as JSON without their timings and
counters; none holds a path or a time, so a window's repeats of one input
fold to one answer. Of each input the check gets one round's outputs
drawn from the seed and the newest (harness.driving.OutputSlots)."""
from __future__ import annotations

import contextlib
import inspect
import io
import json
import os

import numpy as np

from harness import spec
from harness.driving import Context, Job, timed_job

file_process = spec.load_module("drivers", "file_process")

# tool: (the workload's key of its entry, its command's module)
TOOLS = {"validate": ("validate_entry", "tomatis_tpu_torch.cli.validate"),
         "verify15": ("verify_entry", "tomatis_tpu_torch.cli.verify_15db")}
# the command's argument behind each positional parameter of the entry
POSITIONAL = {"in_path": "input", "out_path": "output",
              "state_csv": "state_csv"}


def _plain(v):
    """json.dump's fallback for NumPy scalars and arrays."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    raise TypeError(f"{type(v).__name__} is not JSON")


class VerifyProcess(file_process.FileProcess):
    def __init__(self, ctx: Context):
        import importlib

        from tomatis_tpu_torch.cli import _sidecar
        from tomatis_tpu_torch.cli import process as cli_process
        super().__init__(ctx)
        self.sidecar = _sidecar
        self.fields = cli_process.sidecar_fields(self.params)
        self.tools = {
            tool: (spec.program_object(ctx.cell.workload, key),
                   importlib.import_module(cli))
            for tool, (key, cli) in TOOLS.items()}

    def _tool(self, tool: str, argv: list) -> dict:
        """The tool's entry called as its command calls it."""
        entry, cli = self.tools[tool]
        args = cli.build_parser().parse_args(argv)
        with contextlib.redirect_stdout(io.StringIO()):
            self.sidecar.apply_params(args, cli.build_parser, argv)
        want = self.ctx.cell.config.get("audit", {}).get(tool, {})
        got = {k: getattr(args, k, None) for k in want}
        if got != want:
            raise ValueError(f"{tool} would run at {got}, and the "
                             f"configuration states {want}")
        pos, kw = [], {}
        for name, p in inspect.signature(entry).parameters.items():
            if name in POSITIONAL and p.default is inspect.Parameter.empty:
                pos.append(getattr(args, POSITIONAL[name]))
            elif hasattr(args, name):
                kw[name] = getattr(args, name)
        return entry(*pos, **kw)

    def _audit(self, in_path: str, tag: str):
        c = self.ctx
        stats, out, csv_path = self._run(in_path, tag)
        self.sidecar.write_sidecar(out, "process", self.fields)
        base = os.path.join(c.workdir, tag)
        common = ["-i", in_path, "-o", out, "--device", c.device]
        results = {}
        with c.spans.span("entry.validate"):
            results["validate"] = self._tool("validate", common + [
                "--state_csv", csv_path, "--out_csv", f"{base}.validate.csv",
                "--out_png", f"{base}.validate.png"])
        with c.spans.span("entry.verify15"):
            results["verify15"] = self._tool("verify15", common + [
                "--out_prefix", f"{base}.verify15"])
        stats["audit"] = {
            tool: {k: r[k] for k in ("timings", "counters") if k in r}
            for tool, r in results.items()}
        files = {"validate_csv": f"{base}.validate.csv",
                 "verify15_csv": f"{base}.verify15_spectrum.csv",
                 "verify15_report": f"{base}.verify15_report.txt"}
        for tool, r in results.items():
            files[f"{tool}_json"] = f"{base}.{tool}.json"
            with open(files[f"{tool}_json"], "w", encoding="utf-8") as f:
                json.dump({k: v for k, v in r.items()
                           if k not in ("timings", "counters")}, f,
                          default=_plain)
        return stats, out, csv_path, files

    def warm(self) -> None:
        self._audit(self.ctx.inputs.warm(0), "warm")

    def job(self, k: int) -> Job:
        inputs = self.ctx.inputs
        i = k % len(inputs)

        def one():
            stats, out, csv_path, files = self._audit(inputs.paths[i],
                                                      self.slots.tag(k))
            return inputs.seconds(i), stats, [(i, out, csv_path, files)]
        return timed_job(k, self.ctx.spans, "job", one)

    def release(self) -> None:
        super().release()
        self.tools = None


def make(ctx: Context) -> VerifyProcess:
    return VerifyProcess(ctx)
