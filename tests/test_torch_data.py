"""The port's batch loader (``msv_tpu_torch/data.py``) against msv_tpu's
(``msv_tpu/data.py``), on the CPU.

Mirrors tests/test_data.py's seven cases on the same in-repo fixtures and
synthetic WAVs, each through both packages: batch rows within
``ops/resample.py``'s bound (2e-5 of the peak), ``ClipMeta`` fields equal,
``errors`` and ``dropped`` equal; the port's rows equal to its own decode
-> pad/truncate -> resample; log-mel rows of ``extract_features``
against msv_tpu's log-mel of the same batches by chip_smoke's ``f32_agree``
in every bin (the zero-padded clips' silent frames put many bins under the
f32 floor, so its share cap does not apply).  The copy of msv_tpu's code
is pinned to its original.  The card test runs where the card is (``-m
gpu``; no JAX there): the card's batches against the CPU's at the
resampler's bound.
"""

import dataclasses
import importlib
import importlib.util
import inspect
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from msv_tpu_torch import data as tdata  # noqa: E402
from msv_tpu_torch.io.audio import open_audio_file, write_wav  # noqa: E402
from msv_tpu_torch.ops.resample import resample  # noqa: E402

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
ATOL = 2e-5  # of the peak: tests/test_resample.py's bound
CPU = {"device": "cpu"}

# Named line edits of the copied code: (original line, lines in the copy).
# AudioBatcher._assemble is the port's own (a pinned host stack, a
# non-blocking copy and the port's resample).
EDITS = {
    "ClipMeta": [],
    "AudioBatcher": [
        ("        from msv_tpu.data import AudioBatcher",
         "        from msv_tpu_torch.data import AudioBatcher"),
        ("        from msv_tpu import whisper_log_mel",
         "        from msv_tpu_torch import whisper_log_mel"),
        ("    (dropped clips are listed on ``.dropped``).",
         "    (dropped clips are listed on ``.dropped``).  ``device`` is "
         "where the\n    batches go (default \"cuda\"; \"cpu\" runs the "
         "plain versions)."),
        ('        on_error: str = "raise",',
         '        on_error: str = "raise",\n        device="cuda",'),
        ("        self._lock = threading.Lock()",
         "        self._lock = threading.Lock()\n"
         "        self.device = torch.device(device)\n"
         "        self._in_flight = []  # (copy's event, pinned host batch)"),
    ],
    "extract_features": [
        ('                     on_error: str = "raise"):',
         '                     on_error: str = "raise", device="cuda"):'),
        ("        on_error=on_error,",
         "        on_error=on_error, device=device,"),
        ("        out = np.asarray(feature_fn(batch))",
         "        out = feature_fn(batch)\n"
         "        out = (out.cpu().numpy() if isinstance(out, torch.Tensor)\n"
         "               else np.asarray(out))"),
    ],
}


@pytest.fixture(scope="module")
def jdata():
    """msv_tpu's data module (absent on the card's machine)."""
    pytest.importorskip("jax")
    return importlib.import_module("msv_tpu.data")


@pytest.fixture()
def mixed_paths(tmp_path, rng):
    """7 wavs across 3 source rates, distinct content, varied lengths
    (tests/test_data.py's fixture)."""
    paths = []
    for i, (sr, sec) in enumerate(
        [(8000, 0.3), (8000, 0.5), (8000, 0.7), (16000, 0.5),
         (16000, 0.2), (22050, 0.5), (22050, 0.6)]
    ):
        t = np.arange(int(sr * sec)) / sr
        x = (0.3 * np.sin(2 * np.pi * (200 + 50 * i) * t)).astype(np.float32)
        p = str(tmp_path / f"clip{i}_{sr}.wav")
        write_wav(p, x[None], sr)
        paths.append(p)
    return paths


def _source(obj, drop=None):
    src = inspect.getsource(obj)
    if drop is not None:
        src = src.replace(inspect.getsource(getattr(obj, drop)), "")
    return src


@pytest.mark.parametrize("name", sorted(EDITS))
def test_copy_differs_only_by_named_lines(jdata, name):
    """msv_tpu's loader code, but for ``_assemble`` and the named lines."""
    drop = "_assemble" if name == "AudioBatcher" else None
    expect = _source(getattr(jdata, name), drop).split("\n")
    for old, new in EDITS[name]:
        assert expect.count(old) == 1, old
        expect[expect.index(old)] = new
    assert _source(getattr(tdata, name), drop) == "\n".join(expect)


def _meta(m):
    return dataclasses.astuple(m)


def _collect(mod, paths, **kw):
    """{path: (row as numpy, meta fields)} and the batch shapes."""
    got, shapes = {}, []
    b = mod.AudioBatcher(paths, **kw)
    for batch, metas in b:
        rows = batch.numpy() if isinstance(batch, torch.Tensor) \
            else np.asarray(batch)
        shapes.append(rows.shape)
        for row, m in zip(rows, metas):
            got[m.path] = (row, _meta(m))
    return got, shapes, b


def _rows_close(got, want):
    assert got.keys() == want.keys()
    for p in got:
        assert got[p][1] == want[p][1], p
        scale = max(float(np.abs(want[p][0]).max()), 1.0)
        np.testing.assert_allclose(got[p][0], want[p][0], rtol=0,
                                   atol=ATOL * scale, err_msg=p)


def test_covers_every_file_once_with_fixed_shapes(jdata, mixed_paths):
    kw = dict(target_sr=16000, clip_seconds=0.5, batch_size=2, workers=3)
    got, shapes, _ = _collect(tdata, mixed_paths, **kw, **CPU)
    want, jshapes, _ = _collect(jdata, mixed_paths, **kw)
    assert shapes == jshapes
    assert all(s[0] <= 2 and s[1] == 8000 for s in shapes)
    assert sorted(got) == sorted(mixed_paths)  # each exactly once
    _rows_close(got, want)


def test_rows_match_direct_decode_resample(jdata, mixed_paths):
    """Every batch equals pad/truncate at source rate + ops.resample of the
    same group — the loader adds no arithmetic of its own (a convolution
    over another batch may sum in another order, so the direct call takes
    the group's stack) — and msv_tpu's rows within the resampler's bound."""
    kw = dict(target_sr=16000, clip_seconds=0.5, batch_size=2)
    got, _, _ = _collect(tdata, mixed_paths, **kw, **CPU)
    _rows_close(got, _collect(jdata, mixed_paths, **kw)[0])
    n_rows = 0
    for batch, metas in tdata.AudioBatcher(mixed_paths, **kw, **CPU):
        group = []
        for m in metas:
            wav2d, sr = open_audio_file(m.path)
            x = wav2d.sum(axis=0)
            want_len = int(round(0.5 * sr))
            trunc = len(x) > want_len
            group.append(x[:want_len] if trunc
                         else np.pad(x, (0, want_len - len(x))))
            assert m.truncated == trunc and m.n_channels == 1
        direct = resample(np.stack(group), metas[0].sr, 16000, **CPU)
        assert torch.equal(batch, direct)
        n_rows += len(metas)
    assert n_rows == len(mixed_paths)


def test_mixed_codecs_and_channel_selection(jdata):
    paths = [os.path.join(FIXDIR, n) for n in (
        "sine440_8k.flac", "sine440_8k.ogg", "sine440_16k.mp3",
        "duotone_8k_stereo.flac")]
    kw = dict(target_sr=16000, clip_seconds=0.4, batch_size=4, channel=0)
    got, _, _ = _collect(tdata, paths, **kw, **CPU)
    _rows_close(got, _collect(jdata, paths, **kw)[0])
    by_name = {os.path.basename(p): v for p, v in got.items()}
    assert by_name["duotone_8k_stereo.flac"][1][3] == 2
    # a 440 Hz fixture stays 440 Hz through decode + resample
    row = by_name["sine440_8k.flac"][0]
    f = np.abs(np.fft.rfft(row * np.hanning(len(row))))
    assert abs(f.argmax() * 16000 / len(row) - 440.0) < 5.0


def test_error_policy(jdata, tmp_path, mixed_paths):
    from msv_tpu_torch.utils.errors import AudioReadError

    junk = str(tmp_path / "junk.wav")
    with open(junk, "wb") as f:
        f.write(b"RIFFxxxxWAVEjunk")
    paths = mixed_paths[:2] + [junk]
    with pytest.raises(AudioReadError):
        list(tdata.AudioBatcher(paths, clip_seconds=0.3, batch_size=2,
                                **CPU))
    kw = dict(clip_seconds=0.3, batch_size=2, on_error="skip")
    got, _, b = _collect(tdata, paths, **kw, **CPU)
    want, _, jb = _collect(jdata, paths, **kw)
    assert sorted(got) == sorted(mixed_paths[:2])
    _rows_close(got, want)
    assert b.errors == jb.errors and len(b.errors) == 1
    assert b.errors[0][0] == junk


def test_drop_remainder(jdata, mixed_paths):
    kw = dict(clip_seconds=0.5, batch_size=2, drop_remainder=True)
    got, shapes, b = _collect(tdata, mixed_paths, **kw, **CPU)
    want, _, jb = _collect(jdata, mixed_paths, **kw)
    assert all(s[0] == 2 for s in shapes)
    _rows_close(got, want)
    # 3 files at 8 k, 2 at 16 k, 2 at 22 k05 -> exactly one odd group
    assert b.dropped == jb.dropped and len(b.dropped) == 1


@pytest.mark.parametrize("args,match", [
    (([],), "empty"), ((None,), "bad target_sr"), ((None,), "on_error")])
def test_validation(jdata, mixed_paths, args, match):
    kw = {"empty": {}, "bad target_sr": {"batch_size": 0},
          "on_error": {"on_error": "ignore"}}[match]
    paths = mixed_paths if args[0] is None else args[0]
    for mod in (tdata, jdata):
        with pytest.raises(ValueError, match=match):
            mod.AudioBatcher(paths, **kw)


def test_extract_features_end_to_end(jdata, mixed_paths):
    from msv_tpu import log_mel_spectrogram as jlog_mel
    from msv_tpu_torch import log_mel_spectrogram

    kw = dict(clip_seconds=0.5, batch_size=2)
    batches = []

    def feats(b):
        batches.append(b.numpy().copy())
        return log_mel_spectrogram(b, 16000, n_mel=40, precision="parity")

    rows, metas = tdata.extract_features(mixed_paths, feats, **kw, **CPU)
    jrows, jmetas = jdata.extract_features(
        mixed_paths, lambda b: jlog_mel(b, 16000, n_mel=40,
                                        precision="parity"), **kw)
    assert len(rows) == len(metas) == len(mixed_paths)
    assert all(isinstance(m, tdata.ClipMeta) for m in metas)
    assert [_meta(m) for m in metas] == [_meta(m) for m in jmetas]
    assert all(isinstance(r, np.ndarray) for r in rows)
    assert {r.shape for r in rows} == {jrows[0].shape}
    assert rows[0].shape[1] == 40
    # the batches' features against msv_tpu's on the same batches (the
    # batches themselves are held to msv_tpu's above)
    want = np.concatenate([np.asarray(jlog_mel(x, 16000, n_mel=40,
                                               precision="parity"))
                           for x in batches])
    agree, _ = cs.f32_agree(torch.from_numpy(np.stack(rows)),
                            torch.from_numpy(want))
    assert bool(agree.all())
    # row/meta alignment: recompute one file directly
    i = [m.path for m in metas].index(mixed_paths[3])  # a 16 k file
    wav2d, sr = open_audio_file(mixed_paths[3])
    x = wav2d.sum(axis=0)
    assert sr == 16000
    direct = log_mel_spectrogram(np.pad(x, (0, 8000 - len(x))), 16000,
                                 n_mel=40, precision="parity", **CPU)
    np.testing.assert_allclose(rows[i], direct.numpy(), atol=1e-6)


@pytest.mark.gpu
def test_card_batches_match_cpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(3)
    paths = []
    for i, sr in enumerate((8000, 22050, 44100, 44100, 48000)):
        x = (0.3 * rng.standard_normal(int(sr * 2.5))).astype(np.float32)
        paths.append(str(tmp_path / f"c{i}.wav"))
        write_wav(paths[-1], x[None], sr)
    kw = dict(target_sr=16000, clip_seconds=2.0, batch_size=2, workers=2)
    card, cpu = {}, {}
    for batch, metas in tdata.AudioBatcher(paths, **kw):
        assert batch.device.type == "cuda"
        for row, m in zip(batch.cpu().numpy(), metas):
            card[m.path] = row
    for batch, metas in tdata.AudioBatcher(paths, **kw, **CPU):
        for row, m in zip(batch.numpy(), metas):
            cpu[m.path] = row
    assert card.keys() == cpu.keys() == set(paths)
    for p in paths:
        scale = max(float(np.abs(cpu[p]).max()), 1.0)
        np.testing.assert_allclose(card[p], cpu[p], rtol=0,
                                   atol=ATOL * scale)
