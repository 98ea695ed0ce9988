"""The port stands alone: it imports neither jax nor tomatis_tpu, and its
entry points default to the card."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tomatis_tpu_torch.models import standard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import importlib, pkgutil, sys
sys.path.insert(0, {repo!r})
import tomatis_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tomatis_tpu_torch.__path__,
                                               "tomatis_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "tomatis_tpu" or m.startswith("tomatis_tpu."))
assert not bad, bad
print("IMPORTED", len(names))
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ)
    r = subprocess.run([sys.executable, "-c", _CHECK.format(repo=REPO)],
                       capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    n = int(r.stdout.split("IMPORTED")[1])
    assert n >= 20   # every module of every sub-package was imported


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour of a host without a card")
    x = np.zeros((4800, 2), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        standard.process_array(x, 48000)
    with pytest.raises(RuntimeError, match="CUDA"):
        standard.build_controller(standard.StandardParams(), 48000)
