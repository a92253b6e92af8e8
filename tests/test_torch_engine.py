"""The engine switch (``msv_tpu_torch/config.py::set_engine``) against
msv_tpu's (``msv_tpu/config.py:170-188``), on the CPU.

"auto" and "pallas" route the mel dB work through the kernel's wrapper
(``mel_spectrogram_cuda``), "xla" through its plain version
(``mel_spectrogram_plain``) on the same device, in the session's adds,
streaming and the log-mel frontend; the calls are counted by wrapping
both.  On the CPU the wrapper runs the plain version too, so an "xla"
session's planes equal an "auto" session's bit for bit; on the card they
are held by chip_smoke's ``f32_agree``.  msv_tpu's "xla" session is held
to the port's at the kernel bound of tests/test_pallas_kernel.py (atol
2e-3 dB, rtol 1e-4).  ``render --engine xla`` equals the library call
under ``set_engine("xla")``.  The card test runs where the card is (``-m
gpu``; no JAX there).
"""

import importlib
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import msv_tpu_torch  # noqa: E402
from msv_tpu_torch import config as tcfg  # noqa: E402
from msv_tpu_torch import features as tfeat  # noqa: E402
from msv_tpu_torch.io.audio import write_wav  # noqa: E402
from msv_tpu_torch.kernels import spectrogram_cuda as K  # noqa: E402
from msv_tpu_torch.parallel import streaming as tstream  # noqa: E402
from msv_tpu_torch.session import multitrack as tmt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
ATOL, RTOL = 2e-3, 1e-4
# (rate, seconds): the 8 kHz track streams under the tests' threshold
TRACKS = ((8000, 2.5), (16000, 1.2), (16000, 1.2))


@pytest.fixture(autouse=True)
def _engine_restored():
    yield
    tcfg.set_engine("auto")


@pytest.fixture()
def paths(tmp_path):
    rng = np.random.default_rng(11)
    out = []
    for i, (sr, sec) in enumerate(TRACKS):
        t = np.arange(int(sec * sr)) / sr
        x = 0.3 * np.sin(2 * np.pi * (300 + 90 * i) * t)
        x = (x + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
        out.append(str(tmp_path / f"t{i}_{sr}.wav"))
        write_wav(out[-1], x[None], sr)
    return out


def _count(monkeypatch):
    """{'kernel': n, 'plain': n}: calls of the kernel's wrapper by the
    session, streaming and the frontend, and of its plain version by their
    mel routes (not the plain calls of the wrapper's own CPU route)."""
    calls = {"kernel": 0, "plain": 0}
    inside = []
    real_cuda, real_plain = K.mel_spectrogram_cuda, K.mel_spectrogram_plain

    def kernel(*a, **kw):
        calls["kernel"] += 1
        inside.append(1)
        try:
            return real_cuda(*a, **kw)
        finally:
            inside.pop()

    def plain(*a, **kw):
        calls["plain"] += not inside
        return real_plain(*a, **kw)

    for mod in (tmt, tstream, tfeat):
        monkeypatch.setattr(mod, "mel_spectrogram_cuda", kernel)
    monkeypatch.setattr(K, "mel_spectrogram_plain", plain)
    return calls


def test_round_trip_and_bad_name():
    jcfg = pytest.importorskip("jax") and importlib.import_module(
        "msv_tpu.config")
    assert tcfg.get_engine() == jcfg.get_engine() == "auto"
    for engine in ("xla", "pallas", "auto"):
        tcfg.set_engine(engine)
        assert tcfg.get_engine() == engine
    with pytest.raises(ValueError) as port_err:
        tcfg.set_engine("triton")
    with pytest.raises(ValueError) as jax_err:
        jcfg.set_engine("triton")
    assert str(port_err.value) == str(jax_err.value)
    assert tcfg.get_engine() == "auto"


def _session(paths, **kw):
    mt = msv_tpu_torch.MultiTrack(device="cpu", **kw)
    mt.add_tracks(list(range(len(paths))), paths)
    return mt


def test_xla_session_equals_auto(paths, monkeypatch):
    """A launch group (the two 16 kHz tracks) and a streamed track (251
    frames at 8 kHz, one segment): "auto" calls the wrapper once for each,
    "xla" never, and the planes and the dB range are the same."""
    monkeypatch.setattr(tmt, "STREAMING_FRAME_THRESHOLD", 200)
    calls = _count(monkeypatch)
    auto = _session(paths)
    assert calls == {"kernel": 2, "plain": 0}
    calls.update(kernel=0, plain=0)
    tcfg.set_engine("xla")
    xla = _session(paths)
    assert calls == {"kernel": 0, "plain": 2}
    assert auto.get_max_db() == xla.get_max_db()
    assert auto.get_min_db() == xla.get_min_db()
    for i in range(len(paths)):
        np.testing.assert_array_equal(auto.get_spec_db(i), xla.get_spec_db(i))


def test_xla_session_matches_jax(paths):
    pytest.importorskip("jax")
    import msv_tpu
    from msv_tpu import config as jcfg

    jcfg.set_engine("xla")
    ref = msv_tpu.MultiTrack()
    ref.add_tracks(list(range(len(paths))), paths)
    tcfg.set_engine("xla")
    port = _session(paths)
    for i in range(len(paths)):
        got, want = port.get_spec_db(i), ref.get_spec_db(i)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_streaming_and_frontend_take_the_plain_version(paths, monkeypatch):
    from msv_tpu_torch.io.audio import open_audio_mono_ex
    from msv_tpu_torch.ops.framing import n_frames_for

    win, hop, ops = cs.operands(16000, "cpu")
    wav = open_audio_mono_ex(paths[1])[0]
    n = 1 + len(tstream._seg_plan_for(n_frames_for(len(wav), win, hop), 16,
                                      2))
    calls = _count(monkeypatch)
    outs = {}
    for engine in ("auto", "xla"):
        tcfg.set_engine(engine)
        outs[engine] = (
            tstream.streaming_spec_db(wav, win, hop, *ops, chunk_frames=16,
                                      seg_chunks=2)[0],
            tfeat.log_mel_spectrogram(wav, 16000, device="cpu"))
        assert calls == ({"kernel": n, "plain": 0} if engine == "auto"
                         else {"kernel": n, "plain": n}), engine
    for a, b in zip(*outs.values()):
        assert torch.equal(a, b)


def test_render_engine_xla_equals_the_library_call(paths, tmp_path):
    from msv_tpu_torch.cli import main

    out = str(tmp_path / "out")
    assert main(["render", *paths, "-o", out, "--engine", "xla",
                 "--device", "cpu"]) == 0
    assert tcfg.get_engine() == "auto"
    tcfg.set_engine("xla")
    lib = _session(paths)
    for i, p in enumerate(paths):
        stem = os.path.splitext(os.path.basename(p))[0]
        np.testing.assert_array_equal(
            cs.png_pixels(os.path.join(out, f"spec_{stem}.png")),
            lib.get_spec_image(i, 100.0, 500))
        np.testing.assert_array_equal(
            cs.png_pixels(os.path.join(out, f"wav_{stem}.png")),
            lib.get_wav_image(i, 100.0, 150, -1.0, 1.0))


@pytest.mark.gpu
def test_card_xla_session_launches_nothing(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from msv_tpu_torch.kernels import spectrogram_cuda as K

    rng = np.random.default_rng(4)
    paths = []
    for i, sr in enumerate((16000, 44100, 48000)):
        x = (0.2 * rng.standard_normal(int(6 * sr))).astype(np.float32)
        paths.append(str(tmp_path / f"c{i}.wav"))
        write_wav(paths[-1], x[None], sr)
    ids = list(range(len(paths)))
    auto = msv_tpu_torch.MultiTrack(device="cuda")
    auto.add_tracks(ids, paths)
    before = dict(K.LAUNCHES_BY_MODE)
    tcfg.set_engine("xla")
    xla = msv_tpu_torch.MultiTrack(device="cuda")
    xla.add_tracks(ids, paths)
    assert K.LAUNCHES_BY_MODE == before
    for i in ids:
        cs.check_f32(torch.from_numpy(xla.get_spec_db(i)),
                     torch.from_numpy(auto.get_spec_db(i)), f"track {i}")
