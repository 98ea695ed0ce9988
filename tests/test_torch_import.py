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
    assert n >= 54   # every module of every sub-package was imported


def test_new_modules_import_no_jax_and_no_reference():
    """The crossfade model, the FLAC codec's binding and the checkpoint
    manager, imported on their own in a fresh interpreter."""
    code = ("import sys; sys.path.insert(0, %r); "
            "import tomatis_tpu_torch.models.xfade, "
            "tomatis_tpu_torch.io.flac, tomatis_tpu_torch.io.flac_py, "
            "tomatis_tpu_torch.engine.checkpoint, "
            "tomatis_tpu_torch.cli.process_xfade, "
            "tomatis_tpu_torch.cli.convert; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tomatis_tpu')); assert not bad, bad" % REPO)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_eq_adaptive_analysis_modules_import_no_jax_no_pandas():
    """The adaptive processor, the EQ appliers, the repair tools, the
    analysis stage, the match workflow and their commands, imported on
    their own in a fresh interpreter: no jax, nothing of the JAX package,
    no pandas (the EQ CSV readers use the csv module)."""
    mods = ["models.eq", "models.adaptive", "models.repair",
            "models.workflow", "analysis.align", "analysis.spectra",
            "analysis.compare", "analysis.analyze_eq", "analysis.features",
            "analysis.gridgate", "analysis.calibrate", "cli.apply_eq",
            "cli.apply_residual_eq", "cli.process_adaptive", "cli.repair",
            "cli.cut", "cli.compare", "cli.analyze_eq", "cli.calibrate",
            "cli.calibrate_v2", "cli.match", "cli.main", "convert"]
    code = ("import sys; sys.path.insert(0, %r); import importlib; "
            "[importlib.import_module('tomatis_tpu_torch.' + m) "
            "for m in %r]; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'tomatis_tpu', 'pandas')); "
            "assert not bad, bad" % (REPO, mods))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour of a host without a card")
    x = np.zeros((4800, 2), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        standard.process_array(x, 48000)
    with pytest.raises(RuntimeError, match="CUDA"):
        standard.build_controller(standard.StandardParams(), 48000)
