"""The port's repair tools (tomatis_tpu_torch/models/repair.py: declicker
and head trimmer) against the JAX package's. Both are host numpy, so
everything is equal: segments, statistics, and the written files byte for
byte. Also the `declick` and `cut` commands of the port's CLI.
"""
import numpy as np
import pytest

from tomatis_tpu.models import repair as jrepair
from tomatis_tpu_torch.cli import main as cli_main
from tomatis_tpu_torch.io import audio
from tomatis_tpu_torch.models import repair


def _clean(n=48000, sr=48000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    x = 0.3 * np.sin(2 * np.pi * 220 * t)[:, None]
    x = np.repeat(x, 2, 1) + 0.001 * rng.standard_normal((n, 2))
    return x.astype(np.float32)


def _clicked(clicks=(12345, 30000, 30010, 41007)):
    x = _clean()
    for c in clicks:
        x[c] += 0.9
    return x


def test_helpers_equal():
    mask = np.array([0, 1, 1, 0, 0, 1, 0, 0, 0, 1, 1], bool)
    for gap in (0, 1, 2, 5):
        np.testing.assert_array_equal(repair.merge_runs(mask, gap),
                                      jrepair.merge_runs(mask, gap))
    np.testing.assert_array_equal(repair.merge_runs(mask),
                                  [[1, 3], [5, 6], [9, 11]])
    assert len(repair.merge_runs(np.zeros(5, bool))) == 0
    d = np.abs(np.diff(_clicked(), axis=0)).max(1)
    assert repair.mad_sigma(d) == jrepair.mad_sigma(d)


@pytest.mark.parametrize("kw", [
    {}, dict(k=6.0), dict(pad_ms=0.0), dict(merge_gap_ms=3.0),
    dict(max_fix_ms=0.5)])
def test_detect_and_inpaint_equal(kw):
    x = _clicked()
    segs_t, st_t = repair.detect_clicks(x, 48000, **kw)
    segs_j, st_j = jrepair.detect_clicks(x, 48000, **kw)
    np.testing.assert_array_equal(segs_t, segs_j)
    assert st_t == st_j
    np.testing.assert_array_equal(repair.inpaint_linear(x, segs_t),
                                  jrepair.inpaint_linear(x, segs_j))
    if not kw:
        for c in (12345, 30000, 41007):
            assert any(s <= c < e for s, e in segs_t), c
        y = repair.inpaint_linear(x, segs_t)
        assert abs(y[12345, 0]) < abs(x[12345, 0]) - 0.4


@pytest.mark.parametrize("ext", ["wav", "flac"])
def test_declick_file_equals_reference(tmp_path, ext):
    x = _clicked()
    ip = tmp_path / "i.wav"
    audio.write(ip, x, 48000, subtype="FLOAT")
    ot, oj = tmp_path / f"t.{ext}", tmp_path / f"j.{ext}"
    st_t = repair.declick(ip, ot, report_csv=tmp_path / "t.csv")
    st_j = jrepair.declick(ip, oj, report_csv=tmp_path / "j.csv")
    assert ot.read_bytes() == oj.read_bytes()
    assert (tmp_path / "t.csv").read_text() == (tmp_path / "j.csv").read_text()
    assert {k: v for k, v in st_t.items() if k != "out_path"} == \
        {k: v for k, v in st_j.items() if k != "out_path"}
    assert st_t["kept_segments"] >= 3
    y, _ = audio.read(ot)
    assert len(y) == len(x) and abs(y[30000, 0]) < 0.4


def test_declick_clean_passthrough(tmp_path):
    x = _clean(24000)
    ip, op = tmp_path / "i.wav", tmp_path / "o.wav"
    audio.write(ip, x, 48000, subtype="FLOAT")
    stats = repair.declick(ip, op, k=25.0)
    assert stats["hits"] == 0 and "kept_segments" not in stats
    y, _ = audio.read(op)
    assert np.max(np.abs(y - x)) < 2 ** -23 + 1e-6


def test_cut_head_equals_reference(tmp_path):
    sr = 8000
    x = _clean(3 * sr, sr)
    ip = tmp_path / "i.wav"
    audio.write(ip, x, sr, subtype="FLOAT")
    st_t = repair.cut_head(ip, tmp_path / "t.wav", cut_seconds=1.0)
    st_j = jrepair.cut_head(ip, tmp_path / "j.wav", cut_seconds=1.0)
    assert (tmp_path / "t.wav").read_bytes() == \
        (tmp_path / "j.wav").read_bytes()
    assert st_t["cut_samples"] == st_j["cut_samples"] == sr
    assert st_t["n_out"] == st_j["n_out"] == 2 * sr


def test_cli_declick_and_cut(tmp_path, capsys):
    x = _clicked()
    ip = tmp_path / "i.wav"
    audio.write(ip, x, 48000, subtype="PCM_24")
    op = tmp_path / "o.wav"
    assert cli_main.main(["declick", "-i", str(ip), "-o", str(op),
                          "--report_csv", str(tmp_path / "r.csv")]) == 0
    out = capsys.readouterr().out
    assert "[DETECT]" in out and "[SEGS]" in out and "[SAVE]" in out
    y, _ = audio.read(op)
    assert len(y) == len(x) and abs(y[12345, 0]) < 0.4
    # cut: explicit output, then the derived default name
    assert cli_main.main(["cut", str(ip), str(tmp_path / "c.wav"),
                          "0.25"]) == 0
    assert audio.info(tmp_path / "c.wav").frames == len(x) - 12000
    assert cli_main.main(["cut", str(ip)]) == 0      # 16 s off a 1 s file
    assert audio.info(tmp_path / "i_cut16s.wav").frames == 0
    capsys.readouterr()
    long_p = tmp_path / "long.wav"
    audio.write(long_p, np.zeros((8000 * 17, 1), np.float32), 8000)
    assert cli_main.main(["cut", str(long_p)]) == 0
    assert audio.info(tmp_path / "long_cut16s.wav").frames == 8000
    assert cli_main.main(["declick", "-i", str(tmp_path / "nope.wav"),
                          "-o", str(op)]) == 1
