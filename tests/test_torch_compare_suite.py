"""The port's comparison suite (tomatis_tpu_torch/analysis/compare_suite.py
and cli/compare_suite.py) against the JAX package's on the fixture of
tests/test_compare_suite.py, on the CPU.

Tolerances: alignment delays, frame and sample counts equal (the same
numpy/scipy alignment); band statistics, gains, anchors, SNRs,
music_err/noise_delta and every CSV row within 1e-3 dB (float32 rFFT
power in another rounding, reduced in float64 on both sides); plot-diff's
bands from one CSV equal (the same host numpy on the same numbers).

matplotlib is made unimportable in every test (None in sys.modules): the
suite then writes no PNG, as the reference does without it, and a first
matplotlib import under a fresh HOME spends a minute on its font cache.
"""
import os
import sys

import numpy as np
import pytest
import torch

from tomatis_tpu.analysis import compare_suite as jcs
from tomatis_tpu_torch.analysis import compare_suite as cs
from tomatis_tpu_torch.cli import main as cli_main
from tomatis_tpu_torch.io import audio
from tests.test_analyze_compare import _colorize, _music, COLOR

torch.set_num_threads(2)

SR = 48000
DB = 1e-3


@pytest.fixture(autouse=True)
def _no_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cmp")
    x = _music(30.0)
    base = _colorize(x, COLOR)
    bp = tmp / "base.flac"
    c1 = tmp / "candA.flac"
    c2 = tmp / "candB.flac"
    audio.write(bp, base, SR, subtype="PCM_24")
    audio.write(c1, x, SR, subtype="PCM_24")
    audio.write(c2, (0.8 * base).astype(np.float32), SR, subtype="PCM_24")
    return bp, c1, c2


def _csv_close(a, b, tol=DB):
    ta, tb = open(a).read().splitlines(), open(b).read().splitlines()
    assert ta[0] == tb[0] and len(ta) == len(tb)
    va = np.loadtxt(a, delimiter=",", skiprows=1)
    vb = np.loadtxt(b, delimiter=",", skiprows=1)
    np.testing.assert_array_equal(va[:, 0], vb[:, 0])     # frequencies
    np.testing.assert_allclose(va[:, 1:], vb[:, 1:], rtol=0, atol=tol)


def _pngs(d) -> list:
    return sorted(f for f in os.listdir(d) if f.endswith(".png"))


def test_compare_to_baseline_matches_jax(pair, tmp_path):
    bp, c1, c2 = pair
    out, jout = tmp_path / "out", tmp_path / "jout"
    res = cs.compare_to_baseline(bp, [c1, c2], str(out), max_minutes=0.6,
                                 device="cpu")
    jres = jcs.compare_to_baseline(bp, [c1, c2], str(jout), max_minutes=0.6)
    assert [r["name"] for r in res] == [r["name"] for r in jres]
    for r, j in zip(res, jres):
        assert r["delay"] == j["delay"] and r["path"] == j["path"]
        for k in ("gain_db", "anchor_db", "snr", "music_err",
                  "noise_delta"):
            assert abs(r[k] - j[k]) <= DB, k
        for k in r["stats"]:
            assert abs(r["stats"][k] - j["stats"][k]) <= DB, k
        np.testing.assert_array_equal(r["freqs"], j["freqs"])
        np.testing.assert_allclose(r["delta_smooth"], j["delta_smooth"],
                                   rtol=0, atol=DB)
        _csv_close(out / f"diff_{r['name']}.csv",
                   jout / f"diff_{r['name']}.csv")
    byname = {r["name"]: r for r in res}
    assert byname["candB"]["music_err"] < 0.3
    assert byname["candA"]["music_err"] > byname["candB"]["music_err"]
    assert (out / "summary.txt").exists() and _pngs(out) == []
    head = open(out / "diff_candA.csv").readline().strip()
    assert head == "freq_hz,delta_raw_db,delta_anchored_db,delta_smooth_db"


def test_compare_three_matches_jax(pair, tmp_path, monkeypatch):
    bp, c1, _ = pair
    for tag, fn in (("port", lambda: cs.compare_three(
            bp, [c1], plot_sec=10.0, max_sec_spec=20.0, out_prefix="cmp",
            device="cpu")),
                    ("jax", lambda: jcs.compare_three(
            bp, [c1], plot_sec=10.0, max_sec_spec=20.0, out_prefix="cmp"))):
        d = tmp_path / tag
        d.mkdir()
        monkeypatch.chdir(d)
        if tag == "port":
            res = fn()
        else:
            jres = fn()
    for r, j in zip(res, jres):
        assert r["delay_samples"] == j["delay_samples"]
        assert r["delay_ms"] == j["delay_ms"] and r["cand"] == j["cand"]
        for k in r:
            if k.endswith("_db"):
                assert abs(r[k] - j[k]) <= DB, k
    assert res[0]["band_200_1k_db"] > 0.3 and res[0]["band_3k_8k_db"] < -1.0
    name = os.path.basename(str(c1))
    _csv_close(tmp_path / "port" / f"cmp_diff_{name}.csv",
               tmp_path / "jax" / f"cmp_diff_{name}.csv")
    assert _pngs(tmp_path / "port") == []


def test_compare_diff_spectrum_and_plot_match_jax(pair, tmp_path):
    bp, c1, _ = pair
    kw = dict(max_minutes=0.5)
    res = cs.compare_diff_spectrum(bp, c1, out_csv=str(tmp_path / "ds.csv"),
                                   out_png=str(tmp_path / "ds.png"),
                                   device="cpu", **kw)
    jres = jcs.compare_diff_spectrum(bp, c1,
                                     out_csv=str(tmp_path / "jds.csv"),
                                     out_png=None, **kw)
    assert res["delay_samples"] == jres["delay_samples"]
    assert res["used_frames"] == jres["used_frames"]
    assert abs(res["anchor_db"] - jres["anchor_db"]) <= DB
    np.testing.assert_array_equal(res["freqs"], jres["freqs"])
    for k in ("delta_raw", "delta_smooth"):
        np.testing.assert_allclose(res[k], jres[k], rtol=0, atol=DB)
    assert len(res["freqs"]) == 512
    assert np.all(np.abs(res["delta_raw"]) <= 12.0 + 1e-6)
    _csv_close(tmp_path / "ds.csv", tmp_path / "jds.csv")
    assert not (tmp_path / "ds.png").exists()
    # plot-diff on the port's CSV: the same bands as the JAX package's
    # plotter on it, and no PNG without matplotlib
    out = cs.plot_diff_spectrum(tmp_path / "ds.csv")
    jout = jcs.plot_diff_spectrum(tmp_path / "ds.csv")
    assert out["bands"] == jout["bands"] and "200-1000" in out["bands"]
    assert out["out_png"] is None is jout["out_png"]


def test_plot_diff_picks_columns_tolerantly(tmp_path):
    """The reference's tolerant column pick (case, spaces, alternative
    names), an unsorted frequency column and an empty cell."""
    p = tmp_path / "any.csv"
    f = np.geomspace(20, 20000, 300)[::-1]
    d = 3 * np.sin(np.log(f))
    rows = [f"{a:.6f},{b:.6f},x" for a, b in zip(f, d)]
    rows[7] = f"{f[7]:.6f},{d[7]:.6f},"
    p.write_text(" Freq ,Delta_dB,note\n" + "\n".join(rows) + "\n")
    out = cs.plot_diff_spectrum(p, smooth_win=11)
    jout = jcs.plot_diff_spectrum(p, smooth_win=11)
    assert out["bands"] == jout["bands"]
    bad = tmp_path / "bad.csv"
    bad.write_text("a,b\n1,2\n")
    with pytest.raises(ValueError, match="unexpected columns"):
        cs.plot_diff_spectrum(bad)


def test_comparison_commands_run_and_print(pair, tmp_path, capsys,
                                           monkeypatch):
    bp, c1, c2 = pair
    monkeypatch.chdir(tmp_path)
    rc = cli_main.main(["compare-baseline", "--baseline", str(bp),
                        "--candidates", str(c1), str(c2), "--outdir",
                        str(tmp_path / "o"), "--max_minutes", "0.6",
                        "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "[candA] music_err=" in out and "[candB]" in out
    rc = cli_main.main(["compare-three", "--base", str(bp), "--cand",
                        str(c1), "--plot_sec", "10", "--max_sec_spec", "20",
                        "--device", "cpu"])
    assert rc == 0 and "bands: 200-1k" in capsys.readouterr().out
    assert _pngs(tmp_path) == []
    rc = cli_main.main(["compare-diff-spectrum", "--base", str(bp), "--cand",
                        str(c1), "--max_minutes", "0.5", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "[ALIGN] delay = " in out
    assert (tmp_path / "diff_spectrum.csv").exists()
    assert not (tmp_path / "diff_vs_baseline.png").exists()
    rc = cli_main.main(["plot-diff", "-i", str(tmp_path /
                                               "diff_spectrum.csv")])
    out = capsys.readouterr().out
    res = cs.plot_diff_spectrum(tmp_path / "diff_spectrum.csv")
    assert rc == 0 and "[OUT]" not in out
    for band, v in res["bands"].items():
        assert f"[BAND {band}Hz] {v:+.2f} dB" in out
    assert cli_main.main(["plot-diff", "-i", str(tmp_path / "nope.csv")]) \
        == 1


def test_comparators_default_to_the_card(pair, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour of a host without a card")
    bp, c1, _ = pair
    with pytest.raises(RuntimeError, match="CUDA"):
        cs.compare_diff_spectrum(bp, c1, max_minutes=0.2,
                                 out_csv=str(tmp_path / "x.csv"))
    with pytest.raises(RuntimeError, match="CUDA"):
        cs.compare_to_baseline(bp, [c1], str(tmp_path / "o"))
    with pytest.raises(RuntimeError, match="CUDA"):
        cs.compare_three(bp, [c1])
    assert not (tmp_path / "x.csv").exists()
    assert cli_main.main(["compare-three", "--base", str(bp), "--cand",
                          str(c1)]) == 1
