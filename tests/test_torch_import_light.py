"""Host-side use of the port must not import torch: reading audio through
the top-level package, importing the host-only sub-packages or asking the
dispatcher for its commands leaves torch (and with it any CUDA context)
out, as tests/test_import_light.py holds the JAX package's I/O to no
backend. Touching a processor does import torch. Each check runs in a
fresh interpreter."""
import os
import subprocess
import sys

import numpy as np
import pytest

from tomatis_tpu_torch.io import audio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code: str) -> str:
    r = subprocess.run([sys.executable, "-c",
                        f"import sys\nsys.path.insert(0, {REPO!r})\n" + code],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout


_READ = """
import tomatis_tpu_torch
x, sr = tomatis_tpu_torch.io.read({wav!r})
assert x.shape == (1000, 2) and sr == 48000, (x.shape, sr)
f = tomatis_tpu_torch.io.AudioFile({wav!r}, "r")
v = f.read_int24(100)
f.close()
assert v.dtype.name == "int32" and v.shape == (100, 2)
y, _ = tomatis_tpu_torch.audio.read({flac!r})
assert (y == x).all()
assert "torch" not in sys.modules, "reading audio imported torch"
print("LIGHT-OK")
"""


def test_audio_reads_leave_torch_out(tmp_path):
    wav, flac = str(tmp_path / "a.wav"), str(tmp_path / "a.flac")
    x = (np.random.default_rng(0).standard_normal((1000, 2)) * 0.1
         ).astype(np.float32)
    audio.write(wav, x, 48000, subtype="PCM_24")
    audio.write(flac, x, 48000, subtype="PCM_24")
    assert "LIGHT-OK" in _run(_READ.format(wav=wav, flac=flac))


@pytest.mark.parametrize("package", ["ops", "engine", "io", "native",
                                     "parallel", "models"])
def test_subpackage_import_leaves_torch_out(package):
    _run(f"import tomatis_tpu_torch.{package}\n"
         f"assert 'torch' not in sys.modules, sorted(sys.modules)\n")


def test_dispatcher_help_leaves_torch_out():
    out = _run("from tomatis_tpu_torch.cli.main import main\n"
               "assert main(['--help']) == 0\n"
               "assert 'torch' not in sys.modules\n")
    assert out.startswith("usage: tomatis-torch <command>")


@pytest.mark.parametrize("name", ["StandardParams", "process",
                                  "process_array", "XfadeParams",
                                  "AdaptiveParams", "process_batch"])
def test_touching_a_processor_imports_torch(name):
    _run("import tomatis_tpu_torch\n"
         "assert 'torch' not in sys.modules\n"
         f"obj = tomatis_tpu_torch.{name}\n"
         "assert 'torch' in sys.modules\n"
         f"assert obj.__name__ == {name!r}\n")
