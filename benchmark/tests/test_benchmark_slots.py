"""Where a file driver's jobs write (harness.driving.OutputSlots): of each
input the check keeps one round drawn from the seed and the newest, and
the other jobs write over the input's slot, so that a window writes little
to disk; file_answers then judges each file once, named after its newest
job."""
import shutil

import numpy as np
import pytest

from harness import driving

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="the frozen FLAC codec needs g++")


@pytest.mark.parametrize("n_inputs", [1, 3, 8])
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 99, 2 ** 32 + 5])
def test_each_input_keeps_one_drawn_round_and_a_slot(seed, n_inputs):
    slots = driving.OutputSlots(seed, n_inputs)
    again = driving.OutputSlots(seed, n_inputs)
    assert slots.kept == again.kept
    assert all(0 <= r < driving.KEEP_ROUNDS for r in slots.kept)
    jobs = range(n_inputs * (driving.KEEP_ROUNDS + 3))
    tags = [slots.tag(k) for k in jobs]
    for i in range(n_inputs):
        mine = [t for k, t in zip(jobs, tags) if k % n_inputs == i]
        kept = [t for t in mine if t.startswith("job")]
        assert kept == [f"job{slots.kept[i] * n_inputs + i}"]
        assert set(mine) - set(kept) == {f"slot{i}"}


def test_seeds_draw_different_rounds():
    drawn = {tuple(driving.OutputSlots(s, 8).kept) for s in range(20)}
    assert len(drawn) > 1


@needs_gxx
def test_a_slot_is_judged_once_as_its_newest_job(tmp_path):
    from reference import flaccodec
    rng = np.random.default_rng(5)
    pcm = [rng.integers(-2 ** 20, 2 ** 20, (4800, 2)).astype(np.int32)
           for _ in range(2)]
    kept, slot = str(tmp_path / "job0.flac"), str(tmp_path / "slot0.flac")
    flaccodec.encode(kept, pcm[0], 48000)
    flaccodec.encode(slot, pcm[1], 48000)
    jobs = [driving.Job(k, 0.1, 0.1, outputs=[(0, path, None)])
            for k, path in enumerate([kept, slot, slot, slot])]
    answers = sorted(driving.file_answers(jobs), key=lambda a: a.name)
    assert [a.name for a in answers] == ["job0:job0.flac", "job3:slot0.flac"]
    assert np.array_equal(answers[0].pcm, pcm[0])
    assert np.array_equal(answers[1].pcm, pcm[1])

