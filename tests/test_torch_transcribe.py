"""The port's note transcription (``msv_tpu_torch/ops/transcribe.py``, on
the CPU) against ``msv_tpu/ops/transcribe.py``.

Every note list equals msv_tpu's (start, end, midi, hz, velocity) on
tests/test_transcribe.py's melodies: a gapped three-note melody, a legato
pitch change, a blip under the minimum duration, two levels.  The MIDI
writer's bytes equal msv_tpu's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from msv_tpu_torch.ops.transcribe import transcribe_notes, write_midi  # noqa: E402,E501

try:
    from msv_tpu.ops import transcribe as J
    from test_transcribe import _read_midi, _tone
except ImportError:  # no jax
    J = None

CPU = {"device": "cpu"}
SR = 16000


@pytest.fixture(autouse=True)
def _reference(request):
    """The JAX reference is absent where the card-only tests run."""
    if J is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference (msv_tpu) is not installed")


def _melody(freqs=(440.0, 523.25, 659.26), dur=0.5, gap=0.15, sr=SR):
    """tests/test_transcribe.py:69's gapped melody (10 ms ramps)."""
    t = np.arange(int(dur * sr)) / sr
    env = np.minimum(1.0, np.minimum(t, t[::-1]) / 0.01)
    silence = np.zeros(int(gap * sr), np.float32)
    parts = [silence]
    for f in freqs:
        parts += [(0.4 * env * np.sin(2 * np.pi * f * t)).astype(
            np.float32), silence]
    return np.concatenate(parts)


def _same(x, **kw):
    got = transcribe_notes(x, SR, **kw, **CPU)
    assert got == J.transcribe_notes(x, SR, **kw)
    return got


def test_melody_equals_jax(tmp_path):
    notes = _same(_melody())
    assert [nt["midi"] for nt in notes] == [69, 72, 76]
    for name, fn in (("port", write_midi), ("jax", J.write_midi)):
        fn(str(tmp_path / f"{name}.mid"), notes, tempo_bpm=96.0)
    data = (tmp_path / "port.mid").read_bytes()
    assert data == (tmp_path / "jax.mid").read_bytes()
    assert [nt["midi"] for nt in _read_midi(str(tmp_path / "port.mid"))] \
        == [69, 72, 76]


def test_legato_blip_and_levels_equal_jax():
    x = np.concatenate([_tone(SR, 440.0, 0.4), _tone(SR, 523.25, 0.4)])
    assert [nt["midi"] for nt in _same(x, split_on_onsets=False)] == [69, 72]
    blip = np.concatenate([
        np.zeros(int(0.2 * SR), np.float32), _tone(SR, 440.0, 0.03),
        np.zeros(int(0.2 * SR), np.float32), _tone(SR, 440.0, 0.5)])
    assert len(_same(blip, min_note_ms=80.0)) == 1
    quiet = _same(_tone(SR, 440.0, 0.5, amp=0.05))
    loud = _same(_tone(SR, 440.0, 0.5, amp=0.8))
    assert loud[0]["velocity"] > quiet[0]["velocity"] + 10


def test_validation_and_silence(tmp_path):
    with pytest.raises(ValueError):
        transcribe_notes(np.zeros((2, 100), np.float32), 8000, **CPU)
    with pytest.raises(ValueError):
        transcribe_notes(np.zeros(8000, np.float32), 8000, min_note_ms=-1.0,
                         **CPU)
    with pytest.raises(ValueError):
        transcribe_notes(np.zeros(8000, np.float32), 8000, pitch_tol=0.0,
                         **CPU)
    assert transcribe_notes(np.zeros(SR, np.float32), SR, **CPU) == []
    p = str(tmp_path / "x.mid")
    for kw in ({"tempo_bpm": 0.0}, {"ppq": 0}, {"program": -2}):
        with pytest.raises(ValueError):
            write_midi(p, [], **kw)
    with pytest.raises(ValueError):
        write_midi(p, [{"start": 0, "end": 1, "midi": 200, "velocity": 90}])
    write_midi(p, [])
    J.write_midi(str(tmp_path / "j.mid"), [])
    assert open(p, "rb").read() == (tmp_path / "j.mid").read_bytes()


@pytest.mark.gpu
def test_transcribe_on_the_card_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = _melody()
    notes = transcribe_notes(x, SR)
    assert [nt["midi"] for nt in notes] == [69, 72, 76]
    assert notes == transcribe_notes(x, SR, **CPU)
