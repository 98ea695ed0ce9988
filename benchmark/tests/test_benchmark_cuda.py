"""On the card (marked cuda; skips without one): a traced run of a cell
through the command the checks run, with the device's numbers in its
line. Run on the card's machine with
python -m pytest -p no:cacheprovider benchmark/tests -m cuda."""
import json
import subprocess
import sys

import pytest

from helpers import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_on_the_card(trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "standard.flac_10min", "--seed", "2500000001",
                        "--seconds", "3", "--trace", str(trace)], cwd=ROOT,
                       capture_output=True, text=True, timeout=360)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert dev["kind"] == torch.cuda.get_device_name(0)
    assert dev["memory_peak_bytes"] > 0
    if trace:
        assert 0 < dev["busy_s"] < dev["window_s"]
        assert {"device_idle_pct", "chunk_tail_gbps",
                "peak_device_mb"} <= set(line["metrics"])
        assert len(line["breakdown"]["device_ops"]) <= 10
    else:
        assert set(line["metrics"]) == {"realtime_x", "setup_s"}
