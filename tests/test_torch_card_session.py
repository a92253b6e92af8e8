"""Card-only tests of the session's device-memory budget and adaptive
renders: what holds on the CPU (tests/test_torch_budget.py,
tests/test_torch_multires.py) must hold on cuBLAS too.  No JAX here, so
the file runs where the card is:
``python -m pytest --noconftest -m gpu tests/test_torch_*.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import msv_tpu_torch  # noqa: E402
from msv_tpu_torch.io.audio import write_wav  # noqa: E402
from msv_tpu_torch.kernels import pipeline  # noqa: E402
from msv_tpu_torch.ops import multires  # noqa: E402
from msv_tpu_torch.render.envelope import EnvelopeState  # noqa: E402
from msv_tpu_torch.utils import profiling  # noqa: E402

SR, SEC = 48000, 30.0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    # the process's flags on: every route below must turn them off itself
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield "cuda"
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _wavs(tmp_path, n=2):
    rng = np.random.default_rng(61)
    t = np.arange(int(SEC * SR)) / SR
    paths = []
    for i in range(n):
        x = (0.3 * np.sin(2 * np.pi * (220 + 110 * i) * t * (1 + 0.05 * t))
             + 0.03 * rng.standard_normal(len(t)))
        x[:: SR // 2] += 0.5
        p = str(tmp_path / f"t{i}.wav")
        write_wav(p, np.clip(x, -1, 1).astype(np.float32)[None], SR, bits=16)
        paths.append(p)
    return paths


@pytest.mark.gpu
def test_adaptive_forms_and_crops_bit_equal_on_the_card(card, tmp_path):
    rng = np.random.default_rng(5)
    n = 8 * SR
    wav = (rng.standard_normal(n) * 0.3).astype(np.float32)
    full, nf = multires.multires_mel_spec_db(wav, SR, device=card)
    for f0, f1 in [(0, 37), (300, 1100), (nf - 9, nf), (5, 6)]:
        s0, s1 = multires.range_sample_window(n, SR, None, f0, f1)
        db, _ = multires.multires_mel_spec_db_range(
            wav[s0:s1], SR, f0, f1, slice_start=s0, n_samples=n,
            device=card)
        assert torch.equal(db, full[f0:f1]), (f0, f1)
    mt = msv_tpu_torch.MultiTrack(device=card)
    mt.add_tracks([0], _wavs(tmp_path, 1))
    parts = [mt.get_adaptive_spec_image_crop(0, 400.0, 300, s, s + 3.0,
                                             wire="rgb")
             for s in (6.0, 9.0, 12.0)]
    union = mt.get_adaptive_spec_image_crop(0, 400.0, 300, 6.0, 15.0,
                                            wire="rgb")
    np.testing.assert_array_equal(np.concatenate(parts, axis=1), union)
    local = mt.get_adaptive_spec_image_crop(0, 20.0, 300, 0.0, SEC + 1.0)
    mt.ADAPTIVE_MAX_FRAMES = 512  # this session: the cached build
    mt.ADAPTIVE_CHUNK = 1024
    cached = mt.get_adaptive_spec_image_crop(0, 20.0, 300, 0.0, SEC + 1.0)
    assert mt._adaptive_db[0].full is not None
    np.testing.assert_array_equal(cached, local)


@pytest.mark.gpu
def test_spilling_a_grouped_track_frees_its_plane_on_the_card(card,
                                                              tmp_path):
    paths = _wavs(tmp_path, 2)  # one launch group
    ref = msv_tpu_torch.MultiTrack(device=card)
    ref.add_tracks([0, 1], paths)
    want = [ref.get_spec_image(i, 100.0, 200) for i in (0, 1)]
    del ref
    mt = msv_tpu_torch.MultiTrack(device=card)
    mt.add_tracks([0, 1], paths)
    plane = mt._state[1].spec_db.untyped_storage().nbytes()
    # a track's bytes after the add: its plane and its adopted row
    one = mt._track_device_bytes(1)
    assert one > plane and mt._track_device_bytes(0) == one
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    mt._spill_track(1)
    # the spill frees the row with the plane
    assert before - torch.cuda.memory_allocated() >= one
    mt.hbm_budget_bytes = one  # one track: each render spills the other
    for _ in range(2):
        for i in (0, 1):
            np.testing.assert_array_equal(mt.get_spec_image(i, 100.0, 200),
                                          want[i])
            assert mt.hbm_stats()["resident_bytes"] <= one
    assert mt.hbm_stats()["reuploads"] >= 3


@pytest.mark.gpu
def test_parity_torch_ops_ignore_the_process_tf32_flags(card):
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.standard_normal((300, 700)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((700, 5000)).astype(np.float32))
    a, b = a.to(card), b.to(card)
    got = pipeline.blocked_matmul(a, b, pipeline.RENDER_BLOCK)
    with msv_tpu_torch.config.precision_for("parity"):
        want = pipeline.blocked_matmul(a, b, pipeline.RENDER_BLOCK)
        f64 = (a.double() @ b.double()).float()
    assert torch.backends.cuda.matmul.allow_tf32  # given back
    # outside the scope TF32 runs (10-bit mantissa); inside it true f32
    assert (want - f64).abs().max().item() < 1e-3
    assert (got - f64).abs().max().item() > 1e-3
    db = torch.rand(24000, 347, device=card) * -100.0
    wv = torch.rand(500, 347, device=card)
    y = pipeline._resized_grey(db, 0.0, -100.0, wv,
                               torch.rand(1200, 24000, device=card),
                               height=347, banded=False)
    assert torch.backends.cuda.matmul.allow_tf32 and y.shape == (500, 1200)


@pytest.mark.gpu
def test_grouped_tracks_adopt_their_rows_on_the_card(card, tmp_path):
    """A 384 kHz and a 48 kHz PCM16 track: add_tracks and a first screen
    upload no wave for the envelopes (no "upload" span), and every crop of
    the adopted rows is bit-equal to one of a state uploaded from the
    carrier."""
    rng = np.random.default_rng(25)
    paths = []
    for sr in (384000, 48000):
        t = np.arange(int(10.0 * sr)) / sr
        x = (0.3 * np.sin(2 * np.pi * 3000 * t * (1 + 0.1 * t))
             + 0.05 * rng.standard_normal(len(t)))
        p = str(tmp_path / f"s{sr}.wav")
        write_wav(p, np.clip(x, -1, 1).astype(np.float32)[None], sr, bits=16)
        paths.append(p)
    views = [(100.0, 80, 0.0, 12.0), (2000.0, 80, 3.0, 3.6),
             (800000.0, 64, 5.0, 5.001)]
    mt = msv_tpu_torch.MultiTrack(device=card)
    profiling.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        mt.add_tracks([0, 1], paths)
        for i in (0, 1):
            mt.get_spec_image_crop(i, 100.0, 300, 0.0, 12.0)
            mt.get_wav_image_crop(i, 100.0, 80, -1.0, 1.0, 0.0, 12.0)
    spans = [s for s in profiling.recorded() if s.name == "session.envelope"]
    profiling.clear()
    assert sum(s.attrs["tracks"] for s in spans) == 2
    assert all(s.attrs["origin"] == "adopted" for s in spans)
    for i in (0, 1):
        tr, env = mt.tracks[i], mt._env_states[i]
        assert (env.origin == "adopted"
                and env.dev.device.type == torch.device(card).type)
        assert env.dev.dtype == torch.int16 and torch.equal(
            env.dev[env.offset : env.offset + tr.n_samples].cpu(),
            torch.from_numpy(tr._wav_int))
        got = [mt.get_wav_image_crop(i, pps, h, -1.0, 1.0, a, b)
               for pps, h, a, b in views]
        mt._env_states[i] = EnvelopeState(None, tr._wav_int,
                                          n=tr.n_samples, scale=tr.scale,
                                          device=card)
        for g, (pps, h, a, b) in zip(got, views):
            np.testing.assert_array_equal(
                g, mt.get_wav_image_crop(i, pps, h, -1.0, 1.0, a, b))


@pytest.mark.gpu
def test_blocked_matmul_holds_no_padded_copy_of_a_tall_grey(card):
    """The render's GEMM over a tall grey (a linear plane under a higher
    session rate) holds beside the grey only its column blocks, the
    blocks' product and the result laid out from it, no padded copy of the
    grey, and gives the bits of the padded-copy form."""
    g = torch.Generator(device=card).manual_seed(25)
    height, n = 3147, 6000
    grey = torch.rand(height, n, device=card, generator=g)
    wv = torch.rand(300, height, device=card, generator=g)
    block = pipeline.RENDER_BLOCK
    nb = -(-n // block)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with msv_tpu_torch.config.precision_for("parity"):
        got = pipeline.blocked_matmul(wv, grey, block)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert extra <= 4 * nb * block * (height + 2 * wv.shape[0]) + (1 << 20)
    bb = torch.nn.functional.pad(grey, (0, nb * block - n))
    bb = bb.reshape(height, nb, block).transpose(0, 1).contiguous()
    with msv_tpu_torch.config.precision_for("parity"):
        want = torch.stack([wv @ bb[i] for i in range(nb)])
    assert torch.equal(got, want.transpose(0, 1).reshape(300, -1)[:, :n])
