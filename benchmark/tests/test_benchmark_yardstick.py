"""The yardstick: the traffic generator repeats bit for bit for a seed and
differs across seeds; the frozen FLAC codec round-trips and its threaded
encoder writes the sequential encoder's bytes; the plain reference agrees
with the port's CPU run at a small size, and its lower-precision control
does not; the reference imports nothing of the program."""
import ast
import os
import shutil

import numpy as np
import pytest

from harness import check, control, spec
from harness.inputs import Inputs, to_pcm24
from reference import tomatis_ref

HAS_GXX = shutil.which("g++") is not None
needs_gxx = pytest.mark.skipif(not HAS_GXX, reason="the frozen FLAC codec "
                               "is built with g++, which this machine lacks")


def _mix(name, lengths):
    cell = spec.load_cell(name)
    mix = dict(cell.mix, lengths_s=lengths)
    return cell, mix


@pytest.mark.parametrize("cell_name", ["standard.flac_10min",
                                       "xfade.flac_tracks"])
def test_traffic_repeats_for_a_seed_and_differs_across(cell_name):
    cell, mix = _mix(cell_name, [7.0, 3.5])
    gen = spec.load_module("traffic", mix["generator"])
    seed = 2 ** 31 + 12345
    a = gen.make(mix, cell.config, seed)
    b = gen.make(mix, cell.config, seed)
    c = gen.make(mix, cell.config, seed + 1)
    assert [x.shape for x in a] == [(336000, 2), (168000, 2)]
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    # passages change on any sample, not on the hop grid: some hop blocks
    # straddle a change, between the two levels
    hop = cell.config["params"]["hop"]
    x = a[0].astype(np.float64)
    blocks = (x[:len(x) // hop * hop] ** 2).reshape(-1, hop, 2).mean((1, 2))
    gap = np.abs(10 * np.log10(blocks) - cell.config["threshold_dbfs"])
    assert gap.min() < 9.0 and gap.max() > 11.0
    # and the files end in a passage, not in silence
    assert a[0][-16:].any() and a[1][-16:].any()


@needs_gxx
def test_frozen_codec_round_trip_and_threads(tmp_path):
    from reference import flaccodec
    rng = np.random.default_rng(3)
    x = to_pcm24(rng.standard_normal((4096 * 5 + 77, 2)) * 0.05)
    a, b = tmp_path / "a.flac", tmp_path / "b.flac"
    flaccodec.encode(str(a), x, 48000, threads=4)
    flaccodec.encode_sequential(str(b), x, 48000, block=1000)
    assert a.read_bytes() == b.read_bytes()
    y, sr, bps = flaccodec.decode(str(a))
    assert (sr, bps) == (48000, 24) and np.array_equal(x, y)
    # the program's reader sees the same samples
    from tomatis_tpu_torch.io import audio
    with audio.AudioFile(str(a), "r") as f:
        z = f.read(f.frames)
    assert np.array_equal(np.rint(z * 8388608.0).astype(np.int32), x)


def _port_run(cfg, x, transport):
    import torch
    torch.set_num_threads(2)
    from harness.driving import program_params
    from tomatis_tpu_torch.models import standard, xfade
    mod = standard if cfg["processor"] == "standard" else xfade
    y, _ = mod.process_array(x, cfg["sample_rate"], program_params(cfg),
                             frames_per_chunk=256, device="cpu",
                             transport=transport)
    return y


@pytest.mark.parametrize("cell_name,transport", [
    ("standard.flac_10min", "pcm24"), ("xfade.array_10min", "f32"),
    ("xfade.flac_tracks", "pcm24")])
def test_reference_agrees_with_the_port_and_the_control_does_not(
        cell_name, transport):
    cell, mix = _mix(cell_name, [40.0])
    x = spec.load_module("traffic", mix["generator"]).make(
        mix, cell.config, 11)[0]
    if transport == "pcm24":
        x = (to_pcm24(x) / 8388608.0).astype(np.float32)
    y = _port_run(cell.config, x, transport)
    ref = tomatis_ref.render(x, cell.config)
    gap = np.abs(y.astype(np.float64) - ref["y"]).max() * 8388608.0
    assert gap <= 4.0, gap
    assert (ref["states"] == 2).any() and (ref["states"] == 1).any()
    ctl = tomatis_ref.render(x, cell.config, tomatis_ref.bfloat16)
    assert np.abs(ctl["y"] - ref["y"]).max() * 8388608.0 > 100 * gap


@pytest.mark.parametrize("cell_name", ["standard.flac_10min",
                                       "xfade.flac_tracks"])
def test_file_end_reads_as_float32_reads_it(cell_name):
    """A file of a whole number of hops: its last samples lie under the
    last frame's window tail alone. The port's gap to the reference there
    (end_lsb) is what a float32 run of the reference reads too, the body
    of the file (audio_lsb) stays within rounding, and the bfloat16
    control reads far more at the end."""
    cell = spec.load_cell(cell_name)
    hop = cell.config["params"]["hop"]
    mix = dict(cell.mix, lengths_s=[200 * hop / cell.config["sample_rate"]])
    x = spec.load_module("traffic", mix["generator"]).make(
        mix, cell.config, 1)[0]
    x = (to_pcm24(x) / 8388608.0).astype(np.float32)
    assert len(x) == 200 * hop
    ref = tomatis_ref.render(x, cell.config)
    n_fft = cell.config["params"]["n_fft"]

    def gaps(pcm):
        return check._audio_gaps(check.Answer("a", 0, pcm=pcm), ref, n_fft)
    port = gaps(to_pcm24(_port_run(cell.config, x, "pcm24")))
    f32 = gaps(tomatis_ref.render(x, cell.config, tomatis_ref.float32)["pcm"])
    ctl = gaps(tomatis_ref.render(x, cell.config, tomatis_ref.bfloat16)["pcm"])
    assert port["audio_lsb"] <= 4 and f32["audio_lsb"] <= 4, (port, f32)
    assert port["end_lsb"] <= 4 * f32["end_lsb"] + 16, (port, f32)
    assert ctl["end_lsb"] > 30 * max(port["end_lsb"], 16), (ctl, port)


def test_gate_decisions_within_rounding_are_masked():
    """A level within AMBIGUOUS_DB of a threshold: the gate run the other
    way there changes the frames after it, and the check does not hold a
    state, an alpha or a sample under those frames to the reference."""
    ton, toff, hop = -38.5, -41.5, 2048
    levels = [-50.0] * 4 + [ton + 1e-4] * 1 + [-30.0] * 10 + [-50.0] * 5
    a = tomatis_ref.gate(levels, ton, toff, 3 * hop, hop, hop)
    b = tomatis_ref.gate(levels, ton, toff, 3 * hop, hop, hop, flip=4)
    assert list(np.nonzero(a != b)[0]) == [7]
    # a frame not near a threshold is never taken the other way
    assert np.array_equal(a, tomatis_ref.gate(levels, ton, toff, 3 * hop,
                                              hop, hop, flip=10))
    n = len(levels)
    masked = a != b
    starts = -hop + np.arange(n) * hop
    ref = {"rows": np.arange(1, n), "states": a, "masked": masked,
           "levels": np.array(levels), "alpha": None, "starts": starts,
           "pcm": np.zeros(((n - 1) * hop, 2), np.int32), "last_cut": 0}
    ref["last_cut"] = len(ref["pcm"])
    names = np.where(b[1:] == 2, "C2", "C1")
    table = {"frame_idx": np.arange(1, n), "level": np.array(levels[1:]),
             "state": names}
    got = check._csv_gaps(check.Answer("a", 0, csv=table), ref, {})
    assert got["state_frames"] == 0
    table["state"] = names.copy()
    table["state"][12] = "C1" if names[12] == "C2" else "C2"
    got = check._csv_gaps(check.Answer("a", 0, csv=table), ref, {})
    assert got["state_frames"] == 1
    pcm = np.zeros_like(ref["pcm"])
    pcm[starts[7] + 10] = 5000          # under the masked frame only
    assert check._audio_gaps(check.Answer("a", 0, pcm=pcm), ref,
                             2 * hop)["audio_lsb"] == 0
    pcm[starts[12] + 10] = 7
    assert check._audio_gaps(check.Answer("a", 0, pcm=pcm), ref,
                             2 * hop)["audio_lsb"] == 7


@needs_gxx
@pytest.mark.parametrize("cell_name", ["standard.flac_10min",
                                       "xfade.array_10min",
                                       "standard.batch8_flac",
                                       "xfade.flac_tracks"])
def test_control_comes_out_not_correct(cell_name, tmp_path):
    cell = spec.load_cell(cell_name)
    inputs = Inputs(cell, 5, str(tmp_path), 0.02)
    ok, checks = check.judge(
        check.compare(control.answers(inputs, cell.config), inputs,
                      cell.config), cell.workload["limits"])
    assert not ok
    # files this short are one flush cut: the end's number holds them
    assert any(checks[k]["value"] > checks[k]["limit"]
               for k in ("audio_lsb", "end_lsb"))
    # and the reference in the program's place is correct
    ok, _ = check.judge(
        check.compare(control.answers(inputs, cell.config,
                                      tomatis_ref.identity), inputs,
                      cell.config), cell.workload["limits"])
    assert ok


def test_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(spec.BENCH, "reference")
    for f in os.listdir(ref_dir):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref_dir, f)).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("tomatis_tpu_torch",
                                               "tomatis_tpu", "jax",
                                               "jaxlib", "flax"), (f, n)
