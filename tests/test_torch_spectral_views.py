"""The port's constant-Q, multitaper and reassigned spectrograms
(``msv_tpu_torch/ops/{cqt,multitaper,reassign}.py``, on the CPU) against
msv_tpu's.

Bounds: the CQT within tests/test_cqt.py:53's atol 2e-5; multitaper power
within tests/test_multitaper.py:46's rtol 2e-4, atol 2e-7, and its dB
view within 1e-3 dB; reassignment's power and coordinates on live cells at
tests/test_reassign.py:59-62's rtol 1e-4 / atol 1e-6, 2e-5 s and 0.05 Hz.
The reassigned image is a nearest-cell histogram, so a coordinate on a
cell boundary may land in either neighbour on another backend
(msv_tpu/ops/reassign.py:173-178): it is compared by its total power
(rtol 1e-5, tests/test_reassign.py:129) and by a 5 x 5-smoothed image,
never cell by cell.  Frames are taken in blocks
(``stft.BLOCK_ELEMENTS``), which changes no value.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

TC = importlib.import_module("msv_tpu_torch.ops.cqt")
TM = importlib.import_module("msv_tpu_torch.ops.multitaper")
TR = importlib.import_module("msv_tpu_torch.ops.reassign")
TS = importlib.import_module("msv_tpu_torch.ops.stft")
try:
    JC = importlib.import_module("msv_tpu.ops.cqt")
    JM = importlib.import_module("msv_tpu.ops.multitaper")
    JR = importlib.import_module("msv_tpu.ops.reassign")
except ImportError:  # no jax
    JC = None

CPU = {"device": "cpu"}
SR = 8000
CQT = {"fmin": 110.0, "n_bins": 48, "hop_length": 256}
STFT = {"win_length": 256, "hop_length": 128, "n_fft": 512}


@pytest.fixture(autouse=True)
def _reference(request):
    if JC is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference (msv_tpu) is not installed")


def _signal(n=6000, seed=9, rows=None):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = (0.5 * np.sin(2 * np.pi * 702.3 * t)
         + 0.3 * rng.standard_normal((rows or 1, n))).astype(np.float32)
    return x if rows else x[0]


@pytest.mark.parametrize("rows,block", [(None, None), (2, None),
                                        (None, 3 * 4096)])
def test_cqt_matches_jax(rows, block, monkeypatch):
    if block is not None:
        monkeypatch.setattr(TS, "BLOCK_ELEMENTS", block)
    x = _signal(rows=rows)
    got = TC.cqt(x, SR, **CQT, **CPU).numpy()
    want = np.asarray(JC.cqt(x, SR, **CQT))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    np.testing.assert_array_equal(TC.cqt_frequencies(110.0, 48),
                                  JC.cqt_frequencies(110.0, 48))


def test_cqt_errors():
    x = _signal()
    for kw in ({"n_bins": 96, "fmin": 32.7}, {"fmin": -1.0},
               {"hop_length": 0}, {"n_bins": 0}):
        with pytest.raises(ValueError):
            TC.cqt(x, SR, **{**CQT, **kw}, **CPU)
    with pytest.raises(ValueError, match="must be"):
        TC.cqt(np.zeros((1, 2, 3), np.float32), SR, **CQT, **CPU)


@pytest.mark.parametrize("rows,kw,block", [
    (None, {}, None), (2, {"nw": 4.0, "n_tapers": 5}, None),
    (None, {}, 20_000)])
def test_multitaper_matches_jax(rows, kw, block, monkeypatch):
    if block is not None:
        monkeypatch.setattr(TS, "BLOCK_ELEMENTS", block)
    x = _signal(rows=rows)
    got = TM.multitaper_spectrogram(x, SR, **STFT, **kw, **CPU).numpy()
    want = np.asarray(JM.multitaper_spectrogram(x, SR, **STFT, **kw))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-7)


@pytest.mark.parametrize("top_db", [80.0, None])
def test_multitaper_db_matches_jax(top_db):
    x = _signal()
    got = TM.multitaper_spec_db(x, SR, top_db=top_db, **STFT, **CPU)
    want = np.asarray(JM.multitaper_spec_db(x, SR, top_db=top_db, **STFT))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)
    for kw in ({"nw": 0.5}, {"n_tapers": 9}, {"top_db": -1.0},
               {"hop_length": 0}):
        with pytest.raises(ValueError):
            TM.multitaper_spec_db(x, SR, **{**STFT, **kw}, **CPU)


def test_reassigned_coordinates_match_jax():
    x = _signal()
    got = TR.reassigned_stft(x, SR, **STFT, **CPU)
    want = [np.asarray(a) for a in JR.reassigned_stft(x, SR, **STFT)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-6)
    live = want[0] > want[0].max() * 1e-6
    np.testing.assert_allclose(got[1][live], want[1][live], atol=2e-5)
    np.testing.assert_allclose(got[2][live], want[2][live], atol=0.05)


def test_reassign_blocks_change_no_value(monkeypatch):
    """Ten frames a block give the whole-plane coordinates bit for bit."""
    x = _signal()
    whole = TR.reassigned_stft(x, SR, **STFT, **CPU)
    monkeypatch.setattr(TS, "BLOCK_ELEMENTS", 10 * 3 * 257)
    for got, want in zip(TR.reassigned_stft(x, SR, **STFT, **CPU), whole):
        np.testing.assert_array_equal(got, want)


def _smooth(img, k=5):
    p = np.pad(img, k // 2, mode="edge")
    return sum(p[i:i + img.shape[0], j:j + img.shape[1]]
               for i in range(k) for j in range(k)) / (k * k)


@pytest.mark.parametrize("top_db", [80.0, None])
def test_reassigned_image_matches_jax(top_db):
    x = _signal()
    got = TR.reassigned_spec_db(x, SR, top_db=top_db, **STFT, **CPU)
    want = np.asarray(JR.reassigned_spec_db(x, SR, top_db=top_db, **STFT))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got, TR.reassigned_spec_db(
        x, SR, top_db=top_db, **STFT, **CPU))  # run to run
    pg, pw = (10.0 ** (a.astype(np.float64) / 10.0) for a in (got, want))
    np.testing.assert_allclose(pg.sum(), pw.sum(), rtol=1e-5)
    np.testing.assert_allclose(_smooth(pg), _smooth(pw),
                               rtol=1e-3, atol=1e-6 * pw.max())
    with pytest.raises(ValueError):
        TR.reassigned_spec_db(x, SR, rel_thresh=-1.0, **STFT, **CPU)


@pytest.mark.gpu
def test_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = _signal()
    np.testing.assert_allclose(
        TC.cqt(x, SR, **CQT, device="cuda").cpu().numpy(),
        TC.cqt(x, SR, **CQT, **CPU).numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(
        TM.multitaper_spectrogram(x, SR, **STFT, device="cuda").cpu()
        .numpy(), TM.multitaper_spectrogram(x, SR, **STFT, **CPU).numpy(),
        rtol=2e-4, atol=2e-7)
    card = TR.reassigned_spec_db(x, SR, top_db=None, **STFT, device="cuda")
    np.testing.assert_array_equal(card, TR.reassigned_spec_db(
        x, SR, top_db=None, **STFT, device="cuda"))
    cpu = TR.reassigned_spec_db(x, SR, top_db=None, **STFT, **CPU)
    pc, pp = (10.0 ** (a.astype(np.float64) / 10.0) for a in (card, cpu))
    np.testing.assert_allclose(pc.sum(), pp.sum(), rtol=1e-5)
