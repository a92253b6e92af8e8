"""The port's mel dB spectrogram kernel module against the JAX package.

On the CPU the wrapper runs the kernel's plain torch version; it is held to
the JAX ``spec_pipeline`` (parity mode) and to the Pallas kernel in
interpret mode with the bounds of ``tests/test_pallas_kernel.py``: atol
2e-3 dB, rtol 1e-4 (the kernel takes ln*20/ln10, the pipeline log10, so the
two differ at ULP level and are never compared bitwise).  The CUDA kernel
itself is compared with the plain version on the card only, where JAX is
absent: there run  python -m pytest --noconftest -m gpu tests/test_torch_kernel.py
(the JAX imports live in the ``jx`` fixture, so this module imports without
them).

Fast mode (bf16 operands, f32 accumulation) is held to the Pallas kernel
with bf16 operands with the split-mode bounds of
tests/test_pallas_kernel.py:266-271 (max < 0.47 dB, one 120 dB / 255 grey
step; p99 < 0.01 dB): the two compute the same function and differ only
where a sum lands by a rounding boundary of the bf16 magnitude.
"""

import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from msv_tpu_torch.config import SpecSetting, derive_stft_params  # noqa: E402
from msv_tpu_torch.kernels import spectrogram_cuda as K  # noqa: E402
from msv_tpu_torch.ops.dft import windowed_dft_matrices  # noqa: E402
from msv_tpu_torch.ops.framing import n_frames_for, reflect_pad_center  # noqa: E402
from msv_tpu_torch.ops.mel import calc_mel_fb_default  # noqa: E402
from msv_tpu_torch.ops.windows import default_stft_window  # noqa: E402
from msv_tpu_torch.utils import round_up_to  # noqa: E402

RATES = [8000, 16000, 22050, 24000, 44100, 48000]
ATOL, RTOL = 2e-3, 1e-4
GREY_STEP = 0.47  # dB: one 120 dB / 255 grey level


@pytest.fixture(scope="module")
def jx():
    """The JAX package's reference functions (absent on the card)."""
    jnp = pytest.importorskip("jax.numpy")
    from msv_tpu.kernels import pipeline, spectrogram_pallas

    return types.SimpleNamespace(jnp=jnp, pipeline=pipeline,
                                 pallas=spectrogram_pallas)


def _setup(sr, win_ms=40.0):
    p = derive_stft_params(sr, SpecSetting(win_ms=win_ms))
    window = default_stft_window(p.win_length, p.n_fft)
    c, s = windowed_dft_matrices(window, p.n_fft)
    return p.win_length, p.hop_length, c, s, calc_mel_fb_default(sr, p.n_fft)


def _p99(d):
    return float(np.percentile(np.abs(d), 99))


def _signal(rng, n, batch=None):
    shape = (n,) if batch is None else (batch, n)
    t = np.arange(n, dtype=np.float64)
    tone = 0.3 * np.sin(2 * np.pi * 0.0123 * t)
    return (tone + 0.2 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("sr", RATES)
def test_plain_matches_jax_spec_pipeline(sr, rng, jx):
    jnp = jx.jnp
    win, hop, c, s, fb = _setup(sr)
    wav = _signal(rng, int(0.3 * sr))
    n_frames = n_frames_for(len(wav), win, hop)
    padded = reflect_pad_center(wav, win)
    got = K.mel_spectrogram_cuda(
        torch.from_numpy(padded), *K.operands_from_numpy(c, s, fb),
        win=win, hop=hop, n_frames=n_frames,
    ).numpy()
    ref, _, _ = jx.pipeline.spec_pipeline(
        jnp.asarray(padded), jnp.asarray(c), jnp.asarray(s), jnp.asarray(fb),
        jnp.int32(n_frames), win=win, hop=hop, n_frames=n_frames,
        use_mel=True, mode="parity",
    )
    assert got.shape == (n_frames, fb.shape[1])
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("sr", [8000, 16000])
def test_plain_matches_pallas_interpret_batched(sr, rng, jx):
    jnp, pl = jx.jnp, jx.pallas
    win, hop, c, s, fb = _setup(sr)
    wav = _signal(rng, sr // 2, batch=2)
    n_frames = n_frames_for(wav.shape[1], win, hop)
    n_frames_pad = round_up_to(n_frames, pl.TILE_F)
    padded = np.stack([reflect_pad_center(w, win) for w in wav])
    c3, s3, fb3, n_mel = pl.prepare_matrices(c, s, fb, win)
    wav2d = np.stack([pl.prepare_wav2d(p, win, hop, n_frames_pad)
                      for p in padded])
    ref = pl.mel_spectrogram_pallas(
        jnp.asarray(wav2d), jnp.asarray(c3), jnp.asarray(s3), jnp.asarray(fb3),
        win=win, hop=hop, n_frames=n_frames_pad, interpret=True,
    )
    ref = np.asarray(ref)[:, :n_frames, :n_mel]
    got = K.mel_spectrogram_cuda(
        torch.from_numpy(padded), *K.operands_from_numpy(c, s, fb),
        win=win, hop=hop, n_frames=n_frames,
    ).numpy()
    assert got.shape == ref.shape == (2, n_frames, n_mel)
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("sr", [8000, 22050])
def test_int16_route_equals_f32_route(sr, rng):
    win, hop, c, s, fb = _setup(sr)
    i16 = (rng.standard_normal((2, sr // 4)) * 8000).astype(np.int16)
    f32 = i16.astype(np.float32) * np.float32(2.0**-15)
    n_frames = n_frames_for(i16.shape[1], win, hop)
    ops = K.operands_from_numpy(c, s, fb)
    out = {}
    for name, wav in (("i16", i16), ("f32", f32)):
        padded = np.stack([reflect_pad_center(w, win) for w in wav])
        out[name] = K.mel_spectrogram_cuda(
            torch.from_numpy(padded), *ops, win=win, hop=hop,
            n_frames=n_frames,
        ).numpy()
    np.testing.assert_array_equal(out["i16"], out["f32"])


@pytest.mark.parametrize("sr", [22050, 48000])
def test_operands_from_pallas_untiles_exactly(sr, jx):
    win, _, c, s, fb = _setup(sr)
    c3, s3, fb3, n_mel = jx.pallas.prepare_matrices(c, s, fb, win)
    got = K.operands_from_pallas(c3, s3, fb3, win, c.shape[1], n_mel)
    for g, ref in zip(got, (c, s, fb)):
        assert g.dtype == torch.float32 and g.is_contiguous()
        np.testing.assert_array_equal(g.numpy(), ref)
    for g, ref in zip(got, K.operands_from_numpy(c, s, fb)):
        assert torch.equal(g, ref)


def _bad_inputs():
    win, hop, n_freq, n_mel, nf = 320, 80, 257, 40, 10
    need = (nf - 1) * hop + win
    wave = torch.zeros(need)
    c = torch.zeros(win, n_freq)
    fb = torch.zeros(n_freq, n_mel)
    ok = dict(win=win, hop=hop, n_frames=nf)
    return [
        ("f64 wave", (wave.double(), c, c, fb), ok),
        ("int32 wave", (wave.int(), c, c, fb), ok),
        ("3-D wave", (wave[None, None], c, c, fb), ok),
        ("short wave", (wave[:-1], c, c, fb), ok),
        ("f64 c", (wave, c.double(), c, fb), ok),
        ("c rows != win", (wave, c[1:], c[1:], fb), ok),
        ("s shape != c", (wave, c, c[:, :-1], fb), ok),
        ("fb rows != n_freq", (wave, c, c, fb[1:]), ok),
        ("1-D fb", (wave, c, c, fb[:, 0]), ok),
        ("zero frames", (wave, c, c, fb), dict(ok, n_frames=0)),
        ("bad mode", (wave, c, c, fb), dict(ok, mode="bf16")),
        ("f32 operands in fast mode", (wave, c, c, fb), dict(ok, mode="fast")),
        ("bf16 operands in parity mode", (wave, *K.operands_bf16(c, c, fb)),
         ok),
        ("out of the wrong shape", (wave, c, c, fb),
         dict(ok, out=torch.empty(nf + 1, n_mel))),
        ("out of the wrong dtype", (wave, c, c, fb),
         dict(ok, out=torch.empty(nf, n_mel, dtype=torch.float64))),
    ]


@pytest.mark.parametrize("case", _bad_inputs(), ids=lambda t: t[0])
def test_wrapper_rejects_bad_dtype_or_shape(case):
    _, args, kw = case
    with pytest.raises(ValueError):
        K.mel_spectrogram_cuda(*args, **kw)


def test_cpu_route_is_not_counted_as_a_launch(rng):
    win, hop, c, s, fb = _setup(8000)
    padded = reflect_pad_center(_signal(rng, 4000), win)
    before = (K.LAUNCHES, dict(K.LAUNCHES_BY_MODE))
    ops = K.operands_from_numpy(c, s, fb)
    for mode, o in (("parity", ops), ("fast", K.operands_bf16(*ops))):
        K.mel_spectrogram_cuda(torch.from_numpy(padded), *o, win=win,
                               hop=hop, n_frames=n_frames_for(4000, win, hop),
                               mode=mode)
    assert (K.LAUNCHES, K.LAUNCHES_BY_MODE) == before


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_out_argument_is_written_in_place(rng, mode):
    win, hop, c, s, fb = _setup(8000)
    padded = torch.from_numpy(reflect_pad_center(_signal(rng, 4000), win))
    ops = K.operands_from_numpy(c, s, fb)
    if mode == "fast":
        ops = K.operands_bf16(*ops)
    nf = n_frames_for(4000, win, hop)
    plane = torch.full((nf + 7, fb.shape[1]), 5.0)
    got = K.mel_spectrogram_cuda(padded, *ops, win=win, hop=hop, n_frames=nf,
                                 mode=mode, out=plane[3 : 3 + nf])
    assert got.data_ptr() == plane[3].data_ptr()
    want = K.mel_spectrogram_plain(padded, *ops, win=win, hop=hop,
                                   n_frames=nf, mode=mode)
    assert torch.equal(plane[3 : 3 + nf], want)
    assert (plane[:3] == 5.0).all() and (plane[3 + nf :] == 5.0).all()


def _pallas_fast(jx, padded, c, s, fb, win, hop, n_frames):
    """The Pallas kernel in fast mode (bf16 operand tiles), interpreted."""
    import ml_dtypes

    jnp, pl = jx.jnp, jx.pallas
    n_frames_pad = round_up_to(n_frames, pl.TILE_F)
    c3, s3, fb3, n_mel = pl.prepare_matrices(c, s, fb, win)
    rows = [pl.prepare_wav2d(p, win, hop, n_frames_pad)
            for p in np.atleast_2d(padded)]
    bf = [jnp.asarray(a.astype(ml_dtypes.bfloat16)) for a in (c3, s3, fb3)]
    ref = pl.mel_spectrogram_pallas(
        jnp.asarray(np.stack(rows)), *bf, win=win, hop=hop,
        n_frames=n_frames_pad, interpret=True, mode="fast")
    ref = np.asarray(ref)[:, :n_frames, :n_mel]
    return ref if padded.ndim == 2 else ref[0]


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("sr", [8000, 16000])
def test_plain_fast_matches_pallas_fast_interpret(sr, batch, rng, jx):
    win, hop, c, s, fb = _setup(sr)
    wav = _signal(rng, sr // 2, batch=batch)
    n_frames = n_frames_for(wav.shape[-1], win, hop)
    padded = (reflect_pad_center(wav, win) if batch is None
              else np.stack([reflect_pad_center(w, win) for w in wav]))
    ref = _pallas_fast(jx, padded, c, s, fb, win, hop, n_frames)
    got = K.mel_spectrogram_cuda(
        torch.from_numpy(padded),
        *K.operands_bf16(*K.operands_from_numpy(c, s, fb)),
        win=win, hop=hop, n_frames=n_frames, mode="fast",
    ).numpy()
    assert got.shape == ref.shape
    d = got - ref
    print(f"fast plain vs Pallas fast, {sr} Hz B={batch}: max "
          f"{np.abs(d).max():.3g} dB, p99 {_p99(d):.3g} dB")
    assert np.abs(d).max() < GREY_STEP
    assert _p99(d) < 0.01


def _feature_setup(sr):
    """The ML frontend's operands at n_mel=64, 40/10 ms: unscaled hann and
    the slaney filterbank, the shapes of tests/test_features.py:65-83."""
    from msv_tpu_torch.ops.mel import calc_mel_fb
    from msv_tpu_torch.ops.windows import hann

    win, hop, n_fft = sr // 25, sr // 100, 512
    c, s = windowed_dft_matrices(hann(win, False), n_fft)
    return win, hop, c, s, calc_mel_fb(sr, n_fft, 64, 0.0, None, "slaney",
                                       np.float32)


@pytest.mark.parametrize("operands", ["features", "session"])
def test_fast_vs_parity_plain(operands, rng):
    """Fast against parity, both plain, on white noise.  On the frontend's
    64 wide bands (the JAX bound of tests/test_features.py:83) every bin is
    within one grey step.  On the session's bands, one or two bins wide, a
    bin near a null of |X| is swamped by the bf16 rounding of the frame and
    of C/S (about 2^-9 of the frame's loudest component): 99% of bins are
    within one grey step and deep nulls swing further, as msv_tpu's
    tests/test_session.py:241-244 notes for the TPU."""
    sr = 8000
    win, hop, c, s, fb = (_feature_setup if operands == "features"
                          else _setup)(sr)
    wav = (rng.standard_normal((2, sr)) * 0.4).astype(np.float32)
    padded = torch.from_numpy(np.stack([reflect_pad_center(w, win)
                                        for w in wav]))
    ops = K.operands_from_numpy(c, s, fb)
    kw = dict(win=win, hop=hop, n_frames=n_frames_for(sr, win, hop))
    d = (K.mel_spectrogram_plain(padded, *ops, mode="fast", **kw)
         - K.mel_spectrogram_plain(padded, *ops, mode="parity", **kw)).numpy()
    print(f"fast vs parity, {operands} operands: max {np.abs(d).max():.3g} "
          f"dB, p99 {_p99(d):.3g} dB, share > {GREY_STEP} dB "
          f"{(np.abs(d) > GREY_STEP).mean():.4f}")
    if operands == "features":
        assert np.abs(d).max() < GREY_STEP
    else:
        assert _p99(d) < GREY_STEP


@pytest.mark.parametrize("sr", [8000, 22050])
def test_fast_int16_route_equals_f32_route(sr, rng):
    win, hop, c, s, fb = _setup(sr)
    i16 = (rng.standard_normal((2, sr // 4)) * 8000).astype(np.int16)
    f32 = i16.astype(np.float32) * np.float32(2.0**-15)
    n_frames = n_frames_for(i16.shape[1], win, hop)
    ops = K.operands_bf16(*K.operands_from_numpy(c, s, fb))
    out = [K.mel_spectrogram_cuda(
        torch.from_numpy(np.stack([reflect_pad_center(w, win) for w in wav])),
        *ops, win=win, hop=hop, n_frames=n_frames, mode="fast").numpy()
        for wav in (i16, f32)]
    np.testing.assert_array_equal(out[0], out[1])


def test_operands_bf16_round_to_nearest_even():
    import ml_dtypes

    rng = np.random.default_rng(7)
    x = rng.standard_normal((64, 33)).astype(np.float32)
    # exact ties: a bf16 value plus half its last place, both parities
    bits = x.view(np.uint32) & np.uint32(0xFFFF0000)
    x[::2] = (bits[::2] | np.uint32(0x8000)).view(np.float32)
    x[1::4] = (bits[1::4] | np.uint32(0x18000)).view(np.float32)
    got = K.operands_bf16(*(torch.from_numpy(a) for a in (x, x[:, :5], x.T)))
    for g, a in zip(got, (x, x[:, :5], x.T)):
        assert g.dtype == torch.bfloat16 and g.is_contiguous()
        want = a.astype(ml_dtypes.bfloat16).astype(np.float32)
        np.testing.assert_array_equal(g.float().numpy(), want)


def test_mel_bands_bound_each_filter():
    _, _, _, _, fb = _setup(48000)
    fb[5, 7] = 0.25  # a gap inside a support stays inside [lo, hi)
    fb[:, 9] = 0.0   # an all-zero column has the empty support
    bands = K.mel_bands(torch.from_numpy(fb)).numpy()
    assert bands.shape == (fb.shape[1], 2) and bands.dtype == np.int32
    for m, (lo, hi) in enumerate(bands):
        nz = np.flatnonzero(fb[:, m])
        assert (lo, hi) == ((nz[0], nz[-1] + 1) if nz.size else (0, 0))


@pytest.mark.gpu
@pytest.mark.parametrize("sr,win_ms", [(8000, 40.0), (22050, 40.0),
                                       (48000, 40.0),   # 4 m-tiles
                                       (48000, 60.0),   # 2
                                       (48000, 80.0)])  # 2
def test_cuda_kernel_matches_plain_on_the_card(sr, win_ms):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(sr)
    win, hop, c, s, fb = _setup(sr, win_ms)
    i16 = (rng.standard_normal((2, 3 * sr)) * 3000).astype(np.int16)
    f32 = i16.astype(np.float32) * np.float32(2.0**-15)
    n_frames = n_frames_for(i16.shape[1], win, hop)
    ops = K.prepare_operands(*K.operands_from_numpy(c, s, fb, "cuda"))
    out = {}
    for name, wav in (("i16", i16), ("f32", f32)):
        padded = np.stack([reflect_pad_center(w, win) for w in wav])
        x = torch.from_numpy(padded).cuda()
        before = K.LAUNCHES
        out[name] = K.mel_spectrogram_cuda(x, ops, win=win, hop=hop,
                                           n_frames=n_frames)
        assert K.LAUNCHES == before + 1
    plain = K.mel_spectrogram_plain(x, ops.c, ops.s, ops.fb, win=win,
                                    hop=hop, n_frames=n_frames)
    one = K.mel_spectrogram_cuda(x[1], ops, win=win, hop=hop,
                                 n_frames=n_frames)
    torch.cuda.synchronize()
    assert torch.equal(out["i16"], out["f32"])
    assert torch.equal(one, out["f32"][1])  # batch rows are independent
    torch.testing.assert_close(out["f32"], plain, atol=ATOL, rtol=RTOL)


def _chip_smoke():
    """chip_smoke.py as a module: its f32_agree rule, swept tones and f64
    witness."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.gpu
def test_cuda_kernel_one_m_tile_on_the_card():
    """A 120 ms window at 48 kHz (one m-tile a block) on chip_smoke's swept
    tones, by chip_smoke's f32_agree rule as the split kernel's card test:
    int16 bit-equal to f32, batch rows independent."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = _chip_smoke()
    win, hop, c, s, fb = _setup(48000, 120.0)
    i16 = cs.make_signal(np.random.default_rng(48000), 48000, 3.0, 2)
    n_frames = n_frames_for(i16.shape[1], win, hop)
    ops = K.prepare_operands(*K.operands_from_numpy(c, s, fb, "cuda"))
    padded = np.stack([reflect_pad_center(w, win) for w in i16])
    x = {"i16": torch.from_numpy(padded).cuda(),
         "f32": torch.from_numpy(padded.astype(np.float32)
                                 * np.float32(2.0**-15)).cuda()}
    kw = dict(win=win, hop=hop, n_frames=n_frames)
    out = {k: K.mel_spectrogram_cuda(v, ops, **kw) for k, v in x.items()}
    one = K.mel_spectrogram_cuda(x["f32"][1], ops, **kw)
    plain = K.mel_spectrogram_plain(x["f32"], ops.c, ops.s, ops.fb, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out["i16"], out["f32"])
    assert torch.equal(one, out["f32"][1])
    cs.check_f32(out["f32"], plain, "parity kernel 48 kHz 120 ms")


@pytest.mark.gpu
def test_cuda_kernel_one_bin_bands_of_white_noise_vs_f64():
    """White noise through a 120 ms window at 48 kHz: 1392 bands, many of
    one DFT bin, some 70 dB under their frame's peak.  The kernel and its
    plain version (cuBLAS f32) are each held to an f64 witness of the same
    operands by chip_smoke's f32_agree rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = _chip_smoke()
    win, hop, c, s, fb = _setup(48000, 120.0)
    i16 = (np.random.default_rng(48000).standard_normal((2, 3 * 48000))
           * 3000).astype(np.int16)
    n_frames = n_frames_for(i16.shape[1], win, hop)
    padded = np.stack([reflect_pad_center(w, win) for w in i16])
    ops = K.prepare_operands(*K.operands_from_numpy(c, s, fb, "cuda"))
    x = torch.from_numpy(padded).cuda()
    kw = dict(win=win, hop=hop, n_frames=n_frames)
    got = K.mel_spectrogram_cuda(x, ops, **kw).cpu()
    plain = K.mel_spectrogram_plain(x, ops.c, ops.s, ops.fb, **kw).cpu()
    wit = cs.f64_witness(padded, ops.c, ops.s, ops.fb, **kw).float()
    for name, y in (("kernel", got), ("plain", plain)):
        err, note = cs.check_f32(y, wit, f"{name} vs the f64 witness")
        print(f"white noise 48 kHz 120 ms, {name} vs f64: max|err| "
              f"{err:.3g} dB ({note})")


@pytest.mark.gpu
@pytest.mark.parametrize("sr,win_ms", [(8000, 40.0), (22050, 40.0),
                                       (44100, 40.0), (48000, 40.0),
                                       (48000, 120.0)])  # 2 m-tiles
def test_fast_kernel_matches_plain_on_the_card(sr, win_ms):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(sr)
    win, hop, c, s, fb = _setup(sr, win_ms)
    i16 = (rng.standard_normal((2, 3 * sr)) * 3000).astype(np.int16)
    f32 = i16.astype(np.float32) * np.float32(2.0**-15)
    n_frames = n_frames_for(i16.shape[1], win, hop)
    ops = K.prepare_operands(
        *K.operands_bf16(*K.operands_from_numpy(c, s, fb, "cuda")), "fast")
    out = {}
    for name, wav in (("i16", i16), ("f32", f32)):
        padded = np.stack([reflect_pad_center(w, win) for w in wav])
        x = torch.from_numpy(padded).cuda()
        before = K.LAUNCHES_BY_MODE["fast"]
        out[name] = K.mel_spectrogram_cuda(x, ops, win=win, hop=hop,
                                           n_frames=n_frames, mode="fast")
        assert K.LAUNCHES_BY_MODE["fast"] == before + 1
    plain = K.mel_spectrogram_plain(x, ops.c, ops.s, ops.fb, win=win,
                                    hop=hop, n_frames=n_frames, mode="fast")
    one = K.mel_spectrogram_cuda(x[1], ops, win=win, hop=hop,
                                 n_frames=n_frames, mode="fast")
    torch.cuda.synchronize()
    assert torch.equal(out["i16"], out["f32"])
    assert torch.equal(one, out["f32"][1])  # batch rows are independent
    d = (out["f32"] - plain).abs().flatten()
    assert d.max().item() < GREY_STEP
    assert d.kthvalue(int(np.ceil(0.99 * d.numel()))).values.item() < 0.01


def _padded_tile_setup(name):
    """Operands whose n_freq - 1 is no multiple of either kernel's tile
    width (128 bins for parity, 256 for fast), so the last tile is
    zero-padded: 8 kHz at a 10 ms window and f_overlap=3 (n_fft 384, 192
    bins), and Whisper's 400-point DFT at 16 kHz (200 bins).  At the
    session's own settings n_fft / 2 is a multiple of 256, f_overlap=3
    included."""
    from msv_tpu_torch.ops.mel import calc_mel_fb
    from msv_tpu_torch.ops.windows import hann

    if name == "f_overlap3":
        sr = 8000
        p = derive_stft_params(sr, SpecSetting(win_ms=10.0, f_overlap=3))
        c, s = windowed_dft_matrices(default_stft_window(p.win_length,
                                                         p.n_fft), p.n_fft)
        return sr, p.win_length, p.hop_length, c, s, calc_mel_fb_default(
            sr, p.n_fft)
    sr, win, hop, n_fft = 16000, 400, 160, 400
    c, s = windowed_dft_matrices(hann(win, False), n_fft)
    return sr, win, hop, c, s, calc_mel_fb(sr, n_fft, 80, 0.0, None,
                                           "slaney", np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["parity", "fast"])
@pytest.mark.parametrize("setup", ["f_overlap3", "n_fft400"])
def test_cuda_kernels_match_plain_with_a_padded_last_tile(setup, mode):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    sr, win, hop, c, s, fb = _padded_tile_setup(setup)
    ops = K.operands_from_numpy(c, s, fb, "cuda")
    if mode == "fast":
        ops = K.operands_bf16(*ops)
    prep = K.prepare_operands(*ops, mode)
    assert prep.n_tiles * prep.nb > prep.n_freq - 1  # a padded last tile
    rng = np.random.default_rng(sr)
    i16 = (rng.standard_normal((2, 2 * sr)) * 3000).astype(np.int16)
    n_frames = n_frames_for(i16.shape[1], win, hop)
    padded = np.stack([reflect_pad_center(w, win) for w in i16])
    x = {"i16": torch.from_numpy(padded).cuda(),
         "f32": torch.from_numpy(padded.astype(np.float32)
                                 * np.float32(2.0**-15)).cuda()}
    before = K.LAUNCHES_BY_MODE[mode]
    got = {k: K.mel_spectrogram_cuda(v, prep, win=win, hop=hop,
                                     n_frames=n_frames, mode=mode)
           for k, v in x.items()}
    assert K.LAUNCHES_BY_MODE[mode] == before + 2
    plain = K.mel_spectrogram_plain(x["f32"], *ops, win=win, hop=hop,
                                    n_frames=n_frames, mode=mode)
    torch.cuda.synchronize()
    assert torch.equal(got["i16"], got["f32"])
    if mode == "parity":
        torch.testing.assert_close(got["f32"], plain, atol=ATOL, rtol=RTOL)
    else:
        d = (got["f32"] - plain).abs().flatten()
        assert d.max().item() < GREY_STEP
        assert d.kthvalue(int(np.ceil(0.99 * d.numel()))).values.item() < 0.01


# Rates of 7056-sample windows and more at the session's settings, and the
# tier each kernel takes there: no resident parity block holds them, and
# their n_fft (8192, 16 384) has an FFT plan; a resident fast block (bf16
# samples) holds them up to 250 kHz at one or two m-tiles.
ULTRASONIC = [176400, 192000, 250000, 384000]
TIER = {"parity": {sr: "fft" for sr in ULTRASONIC},
        "fast": {176400: "resident", 192000: "resident", 250000: "resident",
                 384000: "chunked"}}


# (sr, t_overlap, f_overlap) -> n_fft and the parity tier: the FFT tier
# exactly where no resident parity block fits and n_fft has a plan
FFT_SHAPES = [
    ((96000, 4, 1), 4096, "resident"),
    ((96000, 1, 1), 4096, "fft"),        # hop = win: 16 frames' rows overflow
    ((176400, 4, 1), 8192, "fft"),
    ((192000, 4, 1), 8192, "fft"),
    ((250000, 4, 1), 16384, "fft"),
    ((384000, 4, 1), 16384, "fft"),
    ((384000, 4, 2), 32768, "fft"),
    ((176400, 4, 3), 24576, "chunked"),  # not a power of two
    ((384000, 4, 4), 65536, "chunked"),  # no plan
]


def _dense(c, s, fb, mode, device="cuda"):
    """The mode's (C, S, fb) on ``device``: f32, or their bf16 copies."""
    ops = K.operands_from_numpy(c, s, fb, device)
    return K.operands_bf16(*ops) if mode == "fast" else ops


def _kernel_operands(c, s, fb, mode, device="cuda"):
    return K.prepare_operands(*_dense(c, s, fb, mode, device), mode)


def _tier(mode, win, hop, fb):
    """tier_for at this shape, fb the session's (n_freq, n_mel) filterbank."""
    return K.tier_for(mode, win, hop, 2 * (fb.shape[0] - 1), fb.shape[1],
                      K.band_weights(fb))


def _agree_with_plain(got, plain, mode, what):
    """The kernels' tolerance of the plain version: parity chip_smoke's
    f32_agree rule (atol/rtol, and in bins 60 dB or more under their
    frame's peak an f32 floor of 1e-6 of its amplitude, at most 0.1% of
    them: over long windows both f32 sums leave such bins a few hundredths
    of a dB apart), as the 120 ms windows above; fast one grey step at
    most and 0.01 dB at the 99th percentile."""
    if mode == "parity":
        _chip_smoke().check_f32(got, plain, what)
    else:
        d = (got - plain).abs().flatten()
        assert d.max().item() < GREY_STEP
        assert d.kthvalue(int(np.ceil(0.99 * d.numel()))).values.item() < 0.01


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["parity", "fast"])
@pytest.mark.parametrize("sr", ULTRASONIC)
def test_ultrasonic_tiers_match_plain_on_the_card(sr, mode):
    """One second of noise at each rate, B = 2 and B = 1: every launch
    takes the rate's tier on the record MelRoute makes, as the
    session's (parity the FFT tier, without C or S; fast resident or
    chunked), tier_for names it, int16 is bit-equal to f32, batch rows are
    independent, and the outputs keep their tolerance of the plain version:
    parity f32_agree and chip_smoke's window_agree (within twice the plain
    version's own f32 error against float64 at these windows), fast one
    grey step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    win, hop, c, s, fb = _setup(sr)
    assert _tier(mode, win, hop, fb) == TIER[mode][sr]
    n_fft = 2 * (fb.shape[0] - 1)
    ops = K.MelRoute(default_stft_window(win, n_fft), fb, win=win, hop=hop,
                     n_fft=n_fft, device="cuda",
                     dense=lambda: (c, s)).record(mode)
    assert ops.fft == (TIER[mode][sr] == "fft")
    if ops.fft:
        assert ops.c is None and ops.slabs is None and ops.tail is None
    i16 = (np.random.default_rng(sr).standard_normal((2, sr)) * 3000).astype(
        np.int16)
    padded = np.stack([reflect_pad_center(w, win) for w in i16])
    x = {"i16": torch.from_numpy(padded).cuda(),
         "f32": torch.from_numpy(padded.astype(np.float32)
                                 * np.float32(2.0**-15)).cuda()}
    kw = dict(win=win, hop=hop, n_frames=n_frames_for(i16.shape[1], win, hop),
              mode=mode)
    before = dict(K.LAUNCHES_BY_TIER)
    got = {k: K.mel_spectrogram_cuda(v, ops, **kw) for k, v in x.items()}
    one = K.mel_spectrogram_cuda(x["f32"][1], ops, **kw)
    tier = TIER[mode][sr]
    assert K.LAUNCHES_BY_TIER == dict(before, **{tier: before[tier] + 3})
    dense = K.operands_from_numpy(c, s, fb, "cuda")
    plain = K.mel_spectrogram_plain(x["f32"], *dense, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got["i16"], got["f32"])
    assert torch.equal(one, got["f32"][1])
    _agree_with_plain(got["f32"], plain, mode, f"{mode} {sr} Hz")
    if mode == "fast":
        return
    cs = _chip_smoke()
    wit = cs.f64_witness_cuda(x["f32"], *(t.double() for t in dense), win,
                              hop, kw["n_frames"])
    agree, _, own = cs.window_agree(got["f32"], plain, wit)
    assert bool(agree.all()), (sr, int((~agree).sum()), own)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_resident_tier_up_to_96_khz_on_the_card(mode):
    """Every rate up to 96 kHz at the session's settings keeps the resident
    tier (the launches of the songs and the hour), as tier_for says, within
    the kernels' tolerance of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    for sr in (*RATES, 88200, 96000):
        win, hop, c, s, fb = _setup(sr)
        ops = _kernel_operands(c, s, fb, mode)
        wav = (np.random.default_rng(sr).standard_normal(sr) * 3000).astype(
            np.int16)
        x = torch.from_numpy(reflect_pad_center(wav, win)).cuda()
        kw = dict(win=win, hop=hop, n_frames=n_frames_for(sr, win, hop),
                  mode=mode)
        before = K.LAUNCHES_BY_TIER["resident"]
        got = K.mel_spectrogram_cuda(x, ops, **kw)
        assert K.LAUNCHES_BY_TIER["resident"] == before + 1, sr
        assert _tier(mode, win, hop, fb) == "resident", sr
        _agree_with_plain(got, K.mel_spectrogram_plain(
            x, ops.c, ops.s, ops.fb, **kw), mode, f"{mode} {sr} Hz")


@pytest.mark.gpu
@pytest.mark.parametrize("shape,n_fft,tier",
                         [s for s in FFT_SHAPES if s[2] != "resident"],
                         ids=[f"{s[0][0]}-t{s[0][1]}-f{s[0][2]}"
                              for s in FFT_SHAPES if s[2] != "resident"])
def test_parity_tiers_past_the_resident_block_on_the_card(shape, n_fft, tier):
    """Parity launches where no resident block fits, at every FFT plan
    (n_fft 4096 to 32 768) and where n_fft has none (the chunked tier), on
    MelRoute's record: one second of noise, B = 2, each launch in
    tier_for's tier, int16 bit-equal to f32, within f32_agree and
    chip_smoke's window_agree of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    sr, t_overlap, f_overlap = shape
    p = derive_stft_params(sr, SpecSetting(t_overlap=t_overlap,
                                           f_overlap=f_overlap))
    win, hop = p.win_length, p.hop_length
    window = default_stft_window(win, p.n_fft)
    c, s = windowed_dft_matrices(window, p.n_fft)
    fb = calc_mel_fb_default(sr, p.n_fft)
    dense = K.operands_from_numpy(c, s, fb, "cuda")
    ops = K.MelRoute(window, fb, win=win, hop=hop, n_fft=p.n_fft,
                     device="cuda", dense=lambda: (c, s)).record("parity")
    assert ops.fft == (tier == "fft")
    i16 = (np.random.default_rng(sr).standard_normal((2, sr)) * 3000).astype(
        np.int16)
    padded = np.stack([reflect_pad_center(w, win) for w in i16])
    x = {"i16": torch.from_numpy(padded).cuda(),
         "f32": torch.from_numpy(padded.astype(np.float32)
                                 * np.float32(2.0**-15)).cuda()}
    kw = dict(win=win, hop=hop, n_frames=n_frames_for(sr, win, hop))
    before = dict(K.LAUNCHES_BY_TIER)
    got = {k: K.mel_spectrogram_cuda(v, ops, **kw) for k, v in x.items()}
    assert K.LAUNCHES_BY_TIER == dict(before, **{tier: before[tier] + 2})
    assert _tier("parity", win, hop, fb) == tier
    plain = K.mel_spectrogram_plain(x["f32"], *dense, **kw)
    cs = _chip_smoke()
    wit = cs.f64_witness_cuda(x["f32"], *(t.double() for t in dense), win,
                              hop, kw["n_frames"])
    torch.cuda.synchronize()
    assert torch.equal(got["i16"], got["f32"])
    _agree_with_plain(got["f32"], plain, "parity", f"parity {shape}")
    agree, _, own = cs.window_agree(got["f32"], plain, wit)
    assert bool(agree.all()), (shape, int((~agree).sum()), own)


# FFT_SHAPES' rates, t_overlap and f_overlap, every pairing
TIER_GRID = [(sr, t_overlap, f_overlap)
             for sr in (96000, 176400, 192000, 250000, 384000)
             for t_overlap in (1, 4) for f_overlap in (1, 2, 3, 4)]


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_tier_for_is_the_dense_launchers_choice_on_the_card(mode):
    """Over TIER_GRID, tier_for says "resident" exactly where the mode's
    dense launcher, given a record of slabs, takes its resident tier (it
    judges by the card's own shared-memory limit, tier_for by
    SMEM_BLOCK_BYTES): one frame launched on C and S of zeros, as the
    choice reads shapes alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lib = K.build()
    dtype = torch.float32 if mode == "parity" else torch.bfloat16
    stream = torch.cuda.current_stream().cuda_stream
    for sr, t_overlap, f_overlap in TIER_GRID:
        p = derive_stft_params(sr, SpecSetting(t_overlap=t_overlap,
                                               f_overlap=f_overlap))
        win, hop = p.win_length, p.hop_length
        fb = torch.from_numpy(calc_mel_fb_default(sr, p.n_fft)).cuda()
        zeros = torch.zeros((win, fb.shape[0]), dtype=dtype, device="cuda")
        ops = K.prepare_operands(zeros, zeros, fb.to(dtype), mode)
        n_mel = fb.shape[1]
        plan = K._launch(lib, mode, torch.zeros((1, win), device="cuda"),
                         ops, torch.empty((1, 1, n_mel), device="cuda"),
                         win, hop, 1, n_mel, stream)
        want = K.tier_for(mode, win, hop, p.n_fft, n_mel, ops.wts.shape[0])
        assert (plan["tier"] == "resident") == (want == "resident"), (
            sr, t_overlap, f_overlap, plan, want)
        del zeros, ops
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# The first 16 hex digits of the sha256 of each resident launch's plane: 30 s
# of seeded int16 noise (numpy's default_rng(sr)), B = 2, the session's
# settings, as the parity and bf16 kernels computed them before the FFT
# tier existed (mel_spectrogram.cu and mel_spectrogram_bf16.cu, then as
# now; the same launch plans), built by the CUDA toolkit of the card's
# machine for an NVIDIA H100 80GB HBM3.  Another toolkit may compile the
# kernels to other bits: recompute them there from those sources.
RESIDENT_DIGESTS = {
    "parity/8000": "37b6dfadd5254085", "fast/8000": "7613d384191a793b",
    "parity/16000": "2941a6629891a33d", "fast/16000": "e79309bdbefe3f93",
    "parity/22050": "732885214db18990", "fast/22050": "97c03da02247ee4d",
    "parity/24000": "39e0be9c58b0c828", "fast/24000": "e87a7746a1211a64",
    "parity/44100": "056f3ecb032da3a8", "fast/44100": "d4e0afe364a48d40",
    "parity/48000": "6233e2dc0f095e7a", "fast/48000": "55483e419ba22405",
    "parity/88200": "576e5bda8fc8b1a6", "fast/88200": "272d7b4ad20b8c93",
    "parity/96000": "9df025b0f04e2a95", "fast/96000": "33e1c614335043ea",
}


@pytest.mark.gpu
def test_resident_launches_keep_their_bits_beside_the_fft_tier_on_the_card():
    """The songs', the hour's and 88.2-96 kHz launches stay in the resident
    tier with the planes' bits the dense kernels gave before the FFT tier
    was added (RESIDENT_DIGESTS), in parity and fast."""
    import hashlib

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for key, want in RESIDENT_DIGESTS.items():
        mode, sr = key.split("/")
        sr = int(sr)
        win, hop, c, s, fb = _setup(sr)
        ops = _kernel_operands(c, s, fb, mode)
        i16 = (np.random.default_rng(sr).standard_normal((2, 30 * sr))
               * 3000).astype(np.int16)
        x = torch.from_numpy(np.stack([reflect_pad_center(w, win)
                                       for w in i16])).cuda()
        before = K.LAUNCHES_BY_TIER["resident"]
        y = K.mel_spectrogram_cuda(x, ops, win=win, hop=hop, mode=mode,
                                   n_frames=n_frames_for(30 * sr, win, hop))
        assert K.LAUNCHES_BY_TIER["resident"] == before + 1, key
        got = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]
        assert got == want, key


@pytest.mark.gpu
def test_split_kernel_raises_where_no_tier_fits_on_the_card():
    """The split kernel has no chunked tier: at 176.4 kHz it launches
    nothing and raises the ValueError that names the shape and the bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    win, hop, c, s, fb = _setup(176400)
    ops = K.prepare_operands(*K.operands_split(
        *K.operands_from_numpy(c, s, fb, "cuda")), "split")
    x = torch.zeros(win + 4 * hop, device="cuda")
    before = K.LAUNCHES
    with pytest.raises(ValueError, match=rf"split .*win={win}, hop={hop}"):
        K.mel_spectrogram_cuda(x, ops, win=win, hop=hop, n_frames=5,
                               mode="split")
    assert K.LAUNCHES == before


class _FakeLib:
    """A kernel library whose launcher reports ``plan`` and returns
    ``err``, launching nothing."""

    def __init__(self, plan, err):
        self.plan, self.err, self.called = plan, err, []
        for name in (*K.ENTRY_POINTS.values(), K.FFT_ENTRY_POINT,
                     K.LINEAR_ENTRY_POINT):
            setattr(self, name, functools.partial(self._entry, name))

    def _entry(self, name, *args):
        self.called.append(name)
        plan = args[-1]._obj
        for k, v in zip(("tier", "mt", "stages", "chunk", "smem", "avail"),
                        self.plan):
            setattr(plan, k, v)
        return self.err

    @staticmethod
    def msv_cuda_error_string(err):
        return b"invalid configuration argument"


def _fake_launch(plan, err, mode="parity", sr=8000, called=None):
    """K._launch on a fake library, with the record the rate's tier reads
    (tier_for: an FFT-tier record from 176.4 kHz on in parity); the entry
    points it called go to ``called``."""
    win, hop, c, s, fb = _setup(sr)
    if _tier(mode, win, hop, fb) == "fft":
        n_fft = 2 * (fb.shape[0] - 1)
        ops = K.prepare_fft_operands(default_stft_window(win, n_fft),
                                     torch.from_numpy(fb), n_fft)
    else:
        ops = K.prepare_operands(*K.operands_from_numpy(c, s, fb), mode)
    wave = torch.zeros((1, win + 3 * hop))
    out = torch.empty((4, fb.shape[1]))
    lib = _FakeLib(plan, err)
    got = K._launch(lib, mode, wave, ops, out, win, hop, 4, fb.shape[1], 0)
    if called is not None:
        called += lib.called
    return got


def test_launch_raises_value_error_where_no_tier_fits():
    with pytest.raises(ValueError) as e:
        _fake_launch((0, 0, 0, 0, 240000, 232448), 9)
    msg = str(e.value)
    for part in ("parity", "win=320", "hop=80", "n_mel=257", "240000",
                 "232448"):
        assert part in msg


def test_launch_reports_the_launchers_choice():
    assert _fake_launch((2, 4, 3, 512, 217988, 232448), 0) == {
        "tier": "chunked", "mt": 4, "stages": 3, "chunk": 512,
        "smem_bytes": 217988}
    with pytest.raises(RuntimeError, match="invalid configuration"):
        _fake_launch((1, 4, 3, 0, 100000, 232448), 9)


def test_launches_by_tier_counts_card_launches_alone(rng):
    """LAUNCHES_BY_TIER has one count per tier and, like LAUNCHES, does not
    count the CPU route."""
    assert set(K.LAUNCHES_BY_TIER) == set(K.TIERS) == {"resident", "chunked",
                                                       "fft"}
    win, hop, c, s, fb = _setup(8000)
    before = dict(K.LAUNCHES_BY_TIER)
    K.mel_spectrogram_cuda(
        torch.from_numpy(reflect_pad_center(_signal(rng, 4000), win)),
        *K.operands_from_numpy(c, s, fb), win=win, hop=hop,
        n_frames=n_frames_for(4000, win, hop))
    assert K.LAUNCHES_BY_TIER == before


# The FFT tier's rule and tables (CPU): tier_for against the launchers'
# shared-memory arithmetic, the twiddle table, and a numpy float32 model of
# csrc/mel_spectrogram_fft.cu's radix passes against np.fft.rfft.

SONGS_HOUR_48K = [8000, 16000, 22050, 24000, 44100, 48000]


@pytest.mark.parametrize("mode", ["parity", "fast", "split"])
@pytest.mark.parametrize("sr", SONGS_HOUR_48K)
def test_tier_for_keeps_every_songs_hour_and_48_khz_shape_resident(sr, mode):
    win, hop, _, _, fb = _setup(sr)
    assert _tier(mode, win, hop, fb) == "resident"


def test_resident_bytes_are_the_launchers():
    """The smallest resident block's bytes at the survey's rates, as the
    parity and bf16 launchers add them up (csrc/mel_spectrogram.cu,
    csrc/mel_spectrogram_bf16.cu): 229 KB at 176.4 kHz and 415 KB at 384
    kHz in parity, 240 KB at 384 kHz in fast, against 227 KB a block."""
    got = {}
    for mode, sr in (("parity", 176400), ("parity", 384000),
                     ("fast", 250000), ("fast", 384000)):
        win, hop, _, _, fb = _setup(sr)
        got[mode, sr] = K._resident_bytes(mode, win, hop, fb.shape[1],
                                          K.band_weights(fb))
    assert got == {("parity", 176400): 234944, ("parity", 384000): 425264,
                   ("fast", 250000): 198000, ("fast", 384000): 245712}
    assert K.SMEM_BLOCK_BYTES == 232448


@pytest.mark.parametrize("shape,n_fft,tier", FFT_SHAPES,
                         ids=[f"{s[0][0]}-t{s[0][1]}-f{s[0][2]}"
                              for s in FFT_SHAPES])
def test_tier_for_takes_fft_where_no_resident_parity_block_fits(shape, n_fft,
                                                                tier):
    sr, t_overlap, f_overlap = shape
    p = derive_stft_params(sr, SpecSetting(t_overlap=t_overlap,
                                           f_overlap=f_overlap))
    fb = calc_mel_fb_default(sr, p.n_fft)
    n_mel, n_wts = fb.shape[1], K.band_weights(fb)
    fits = K._resident_bytes("parity", p.win_length, p.hop_length, n_mel,
                             n_wts) <= K.SMEM_BLOCK_BYTES
    assert p.n_fft == n_fft
    assert fits == (tier == "resident")
    assert (tier == "fft") == (not fits and n_fft in K.FFT_PLANS)
    assert K.tier_for("parity", p.win_length, p.hop_length, n_fft, n_mel,
                      n_wts) == tier
    # fast mode has no FFT tier
    assert K.tier_for("fast", p.win_length, p.hop_length, n_fft, n_mel,
                      n_wts) in ("resident", "chunked")


@pytest.mark.parametrize("sr,tier", [(8000, "resident"), (384000, "fft"),
                                     (176400, "fft")])
def test_launch_takes_the_entry_point_of_the_records_tier(sr, tier):
    """A launch of the FFT tier's record calls the FFT kernel's entry point,
    and its plan reads as tier "fft"; a record of slabs the dense one."""
    called = []
    plan = (3, 1, 0, 0, 69632, 232448) if tier == "fft" else (
        1, 4, 3, 0, 100000, 232448)
    got = _fake_launch(plan, 0, sr=sr, called=called)
    assert got["tier"] == tier
    assert called == [K.FFT_ENTRY_POINT if tier == "fft"
                      else K.ENTRY_POINTS["parity"]]


@pytest.mark.parametrize("sr", [8000, 48000, 176400, 384000])
def test_kernel_record_makes_the_record_of_the_launchs_tier(sr, monkeypatch):
    """MelRoute on a card (the uploads and the move of the tables stubbed):
    the FFT tier's record, made from the window and fb alone (no C or S
    built), exactly where tier_for says "fft"; else prepare_operands of the
    route's C and S.  Off the card and in fast mode the route reads C and
    S (prepare builds them)."""
    monkeypatch.setattr(K.MelOperands, "to", lambda self, device: self)
    win, hop, c, s, fb = _setup(sr)
    n_fft = 2 * (fb.shape[0] - 1)
    window = default_stft_window(win, n_fft)
    asked = []
    real = K.operands_from_numpy

    def upload(c, s, fb, device):
        asked.append(str(device))
        return real(c, s, fb)

    monkeypatch.setattr(K, "operands_from_numpy", upload)

    def route(device="cuda"):
        return K.MelRoute(window, fb, win=win, hop=hop, n_fft=n_fft,
                          device=device)

    fft = _tier("parity", win, hop, fb) == "fft"
    assert fft == (sr > 96000)
    r = route()
    r.prepare("parity")
    assert r.tier("parity") == ("fft" if fft else "resident")
    assert asked == ([] if fft else ["cuda"])
    assert (r.record("parity").fft == fft
            and asked == ([] if fft else ["cuda"]))
    if fft:
        assert torch.equal(r.record("parity").window,
                           torch.from_numpy(window))
        with pytest.raises(ValueError, match="analysis window"):
            K.MelRoute(None, fb, win=win, hop=hop, n_fft=n_fft,
                       device="cuda", dense=lambda: (c, s)).record("parity")
    else:
        assert r.record("parity").slabs is not None
    asked.clear()
    route(device="cpu").prepare("parity")
    route().prepare("fast")
    assert asked == ["cpu", "cuda"]
    if not fft:
        cpu = route(device="cpu").record("parity")
        assert not cpu.fft and cpu.slabs is not None


def test_kernel_record_keeps_a_named_pairs_tables_once(monkeypatch):
    """With a key, the band weights and the FFT tier's host record of a
    named (window, fb) are made once a process, whatever route asks."""
    monkeypatch.setattr(K.MelOperands, "to", lambda self, device: self)
    monkeypatch.setattr(K.MelRoute, "_TABLES", {})
    win, hop, _, _, fb = _setup(192000)
    n_fft = 2 * (fb.shape[0] - 1)
    window = default_stft_window(win, n_fft)
    made = []
    real = K.prepare_fft_operands
    monkeypatch.setattr(K, "prepare_fft_operands",
                        lambda *a: made.append(1) or real(*a))
    kw = dict(win=win, hop=hop, n_fft=n_fft, device="cuda",
              key=("test", 192000))
    one = K.MelRoute(window, fb, **kw).record("parity")
    two = K.MelRoute(window, fb, **kw).record("parity")
    assert one is two and made == [1]
    assert set(K.MelRoute._TABLES[("test", 192000)]) == {"n_wts", "fft"}


def _tier_cases():
    win, hop, c, s, fb = _setup(8000)
    slab = K.prepare_operands(*K.operands_from_numpy(c, s, fb))
    win, hop, _, _, fb = _setup(192000)
    n_fft = 2 * (fb.shape[0] - 1)
    rec = K.prepare_fft_operands(default_stft_window(win, n_fft),
                                 torch.from_numpy(fb), n_fft)
    return [("plain-resident", None, "resident", None),
            ("plain-chunked", None, "chunked", None),
            ("plain-fft", None, "fft", "C/S operands given to a fft-tier"),
            ("slabs-resident", slab, "resident", None),
            ("slabs-chunked", slab, "chunked", None),
            ("slabs-fft", slab, "fft", "C/S operands given to a fft-tier"),
            ("fft-fft", rec, "fft", None),
            ("fft-resident", rec, "resident",
             "an FFT-tier record given to a resident-tier"),
            ("fft-chunked", rec, "chunked",
             "an FFT-tier record given to a chunked-tier")]


@pytest.mark.parametrize("case", _tier_cases(), ids=lambda c: c[0])
def test_a_launch_raises_on_another_tiers_operands(case):
    """The wrapper's check before a card launch: C/S (plain, or a record of
    slabs) at an FFT-tier shape and an FFT-tier record at any other raise
    ValueError and name MelRoute; it rebuilds nothing."""
    _, ops, tier, msg = case
    if msg is None:
        K._check_tier(ops, tier, 320, 80, 257)
    else:
        with pytest.raises(ValueError, match=msg) as e:
            K._check_tier(ops, tier, 320, 80, 257)
        assert "MelRoute" in str(e.value)


def test_streaming_makes_the_fft_record_from_the_window(monkeypatch):
    """Streaming given C, S and fb where its launches take the FFT tier
    makes a route whose record comes from ``window``, with no C or S
    shipped; with no window the record raises; a route passes as it
    is."""
    from msv_tpu_torch.parallel import streaming

    monkeypatch.setattr(K.MelOperands, "to", lambda self, device: self)
    win, hop, c, s, fb = _setup(192000)
    window = default_stft_window(win, 2 * (fb.shape[0] - 1))
    kw = dict(win=win, hop=hop)
    route = streaming._segment_operands(c, s, fb, "cuda", "dft", "auto",
                                        window=window, **kw)
    rec = route.record("parity")
    assert rec.fft and rec.c is None and "f32" not in route._forms
    assert torch.equal(rec.window, torch.from_numpy(window))
    with pytest.raises(ValueError, match="analysis window"):
        streaming._segment_operands(c, s, fb, "cuda", "dft", "auto",
                                    **kw).record("parity")
    assert streaming._segment_operands(route, None, None, None, "dft",
                                       "auto", **kw) is route


@pytest.mark.parametrize("engine", ["auto", "xla"])
@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_a_route_on_the_cpu_is_the_plain_version(mode, engine):
    """A MelRoute on the CPU, B = 2 into an ``out`` plane and B = 1: its
    plane is mel_spectrogram_plain's on the mode's dense operands bit for
    bit, under either engine; under "auto" each call is one ``mel.launch``
    span (tier "plain", the caller's rate), under "xla" none, as the
    session, streaming and the frontend recorded them before they held
    routes."""
    from msv_tpu_torch import config as tcfg
    from msv_tpu_torch.utils import profiling

    win, hop, c, s, fb = _setup(16000)
    n_fft = 2 * (fb.shape[0] - 1)
    route = K.MelRoute(default_stft_window(win, n_fft), fb, win=win,
                       hop=hop, n_fft=n_fft, device="cpu")
    dense = K.operands_from_numpy(c, s, fb)
    if mode == "fast":
        dense = K.operands_bf16(*dense)
    x = torch.from_numpy(_signal(np.random.default_rng(5), 4000, batch=2))
    n_frames = (x.shape[1] - win) // hop + 1
    kw = dict(win=win, hop=hop, n_frames=n_frames, mode=mode)
    want = K.mel_spectrogram_plain(x, *dense, **kw)
    want1 = K.mel_spectrogram_plain(x[1], *dense, **kw)
    out = torch.empty_like(want)
    profiling.clear()
    tcfg.set_engine(engine)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            got = route(x, n_frames, mode=mode, out=out, sr=16000)
            one = route(x[1], n_frames, mode=mode)
    finally:
        tcfg.set_engine("auto")
    spans = [(sp.attrs["sr"], sp.attrs["batch"], sp.attrs["mode"],
              sp.attrs["tier"]) for sp in profiling.recorded()
             if sp.name == "mel.launch"]
    profiling.clear()
    assert got is out and torch.equal(got, want) and torch.equal(one, want1)
    assert spans == ([] if engine == "xla" else [
        (16000, 2, mode, "plain"), (None, 1, mode, "plain")])


@pytest.mark.parametrize("n_fft", sorted(K.FFT_PLANS))
def test_fft_twiddles_match_exp_to_f32_rounding(n_fft):
    """Every entry of the table is exp(-2 pi i t) of its fraction of a turn
    t, rounded once to f32 (within half an f32 ulp of the float64 value,
    and no further than numpy's own f32 rounding of it)."""
    tw = K.fft_twiddles(n_fft)
    radices = K.FFT_PLANS[n_fft]
    turns = [np.arange(n_fft // 4 + 1) / n_fft]
    ns = radices[0]
    for r in radices[1:]:
        rr, k = np.meshgrid(np.arange(1, r), np.arange(ns), indexing="ij")
        turns.append((rr * k / (ns * r)).ravel())
        ns *= r
    assert ns == n_fft // 2
    want = np.exp(-2j * np.pi * np.concatenate(turns))
    assert tw.dtype == np.float32 and tw.shape == (len(want), 2)
    for got, ref in ((tw[:, 0], want.real), (tw[:, 1], want.imag)):
        assert np.array_equal(got, ref.astype(np.float32))
        ulp = np.spacing(np.abs(ref).astype(np.float32))
        assert np.all(np.abs(got - ref) <= 0.5 * ulp)


_COS32 = np.cos(2 * np.pi * np.arange(16) / 32).astype(np.float32)
_SIN32 = np.sin(2 * np.pi * np.arange(16) / 32).astype(np.float32)
_COS32[8] = 0.0  # cos(pi / 2): the kernel's table holds the exact zero


def _dft_in_registers(v):
    """The kernel's in-register DFT of the last axis (R points), in
    complex64: radix-2 decimation in frequency over W_32^t, then the
    bit-reversal."""
    v = v.copy()
    r_pts = v.shape[-1]
    size = r_pts
    while size >= 2:
        h = size // 2
        for i in range(0, r_pts, size):
            for j in range(h):
                a, b = v[..., i + j].copy(), v[..., i + j + h].copy()
                d = a - b
                t = j * (32 // size)
                v[..., i + j] = a + b
                v[..., i + j + h] = d if t == 0 else d * np.complex64(
                    complex(_COS32[t], -_SIN32[t]))
        size = h
    bits = r_pts.bit_length() - 1
    return v[..., [int(format(i, f"0{bits}b")[::-1], 2)
                   for i in range(r_pts)]]


def _fft_model(x, n_fft, linear=False):
    """|rfft| of real (F, n_fft) float32 frames by the kernel's plan: the
    packed half-length points, the Stockham radix passes with the table's
    twiddles, the split of bins k and M - k.  ``linear``: the linear
    epilogue's dB of every bin instead (20 ln / ln 10 in float32, -360 dB
    at or under 1e-18)."""
    tw = K.fft_twiddles(n_fft)
    tw = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    m = n_fft // 2
    z = (x[:, 0::2] + 1j * x[:, 1::2]).astype(np.complex64)
    off, ns = m // 2 + 1, 1
    for r in K.FFT_PLANS[n_fft]:
        j = np.arange(m // r)
        k = j & (ns - 1)
        v = z[:, j[:, None] + np.arange(r)[None, :] * (m // r)]
        if ns > 1:
            v[:, :, 1:] *= tw[off + (np.arange(1, r)[None, :] - 1) * ns
                              + k[:, None]][None]
            off += (r - 1) * ns
        z = np.empty_like(z)
        z[:, ((j - k) * r + k)[:, None] + np.arange(r)[None, :] * ns] = (
            _dft_in_registers(v))
        ns *= r
    kk = np.arange(m // 2 + 1)
    a, b = z[:, kk], z[:, (m - kk) & (m - 1)]
    e = np.float32(0.5) * (a + np.conj(b))
    o = (np.float32(0.5) * (a.imag + b.imag)
         + 1j * np.float32(0.5) * (b.real - a.real)).astype(np.complex64)
    t = o * tw[kk]
    mag = np.empty((x.shape[0], m + 1), np.float32)
    mag[:, m - kk] = np.abs(e - t)
    mag[:, kk] = np.abs(e + t)
    if linear:
        with np.errstate(divide="ignore"):
            return np.where(mag > np.float32(1e-18), np.log(mag) * np.float32(
                20.0 / np.log(10.0)), np.float32(-360.0)).astype(np.float32)
    return mag


@pytest.mark.parametrize("n_fft", [8192, 16384])
def test_fft_model_of_the_radix_passes_matches_rfft(n_fft):
    """The planned passes in float32 reproduce |rfft| (float64) of a windowed,
    zero-padded noise frame and of a tone within f32 error: at most 1e-6 of
    the frame's peak bin, and 3e-7 in rms relative to the spectrum's rms,
    as numpy's own float32 FFT."""
    rng = np.random.default_rng(n_fft)
    win = n_fft * 15 // 16
    left = (n_fft - win) // 2
    x = np.zeros((2, n_fft), np.float32)
    w = default_stft_window(win, n_fft)
    x[0, left:left + win] = w * rng.standard_normal(win).astype(np.float32)
    x[1, left:left + win] = w * np.sin(
        2 * np.pi * 0.0123 * np.arange(win)).astype(np.float32)
    got = _fft_model(x, n_fft)
    ref = np.abs(np.fft.rfft(x.astype(np.float64), axis=1))
    peak = ref.max(axis=1, keepdims=True)
    assert np.all(np.abs(got - ref) <= 1e-6 * peak)
    rms = np.sqrt(((got - ref) ** 2).mean(axis=1) / (ref ** 2).mean(axis=1))
    assert np.all(rms < 3e-7), rms


def test_fft_records_hold_no_dft_operands(rng):
    """An FFT-tier record carries the window, the twiddles and the band
    tables, and no C, S, slabs or tail; its plain operands are built on
    demand, and the CPU route on it equals the route on C, S and fb."""
    sr = 192000
    win, hop, c, s, fb = _setup(sr)
    n_fft = 2 * (fb.shape[0] - 1)
    window = default_stft_window(win, n_fft)
    rec = K.prepare_fft_operands(window, torch.from_numpy(fb), n_fft)
    assert rec.fft and (rec.c, rec.s, rec.slabs, rec.tail) == (None,) * 4
    assert (rec.win, rec.n_fft, rec.mode) == (win, n_fft, "parity")
    assert torch.equal(rec.window, torch.from_numpy(window))
    assert rec.twiddles.shape == K.fft_twiddles(n_fft).shape
    dense = K.prepare_operands(*K.operands_from_numpy(c, s, fb))
    for name in ("bands", "wts", "woff"):
        assert torch.equal(getattr(rec, name), getattr(dense, name))
    dc, ds, dfb = rec.dft()
    assert torch.equal(dc, torch.from_numpy(c)) and torch.equal(
        ds, torch.from_numpy(s)) and dfb is rec.fb
    x = torch.from_numpy(reflect_pad_center(_signal(rng, 3 * hop), win))
    kw = dict(win=win, hop=hop, n_frames=n_frames_for(3 * hop, win, hop))
    assert torch.equal(K.mel_spectrogram_cuda(x, rec, **kw),
                       K.mel_spectrogram_cuda(x, dense, **kw))
    with pytest.raises(ValueError, match="no plan"):
        K.prepare_fft_operands(window, torch.from_numpy(fb), 12288)
    with pytest.raises(ValueError, match="operands prepared for mode"):
        K.mel_spectrogram_cuda(x, rec, mode="fast", **kw)


@pytest.mark.parametrize("sr", [192000, 384000])
def test_fft_model_linear_epilogue_matches_linear_db(sr):
    """The linear epilogue over the planned passes, on frames windowed and
    zero-padded as the kernel loads them (the product rounded once), holds
    portbench's plain reference (``reference/spec.py::linear_db``:
    ``torch.fft.rfft`` in float32) at n_fft 8192 (192 kHz) and 16 384 (384
    kHz) within 0.01 dB over bins within 60 dB of their frame's peak: two
    float32 FFTs of another summation order differ by about 1e-6 of the
    peak in amplitude, a few thousandths of a dB 60 dB under it; here at
    most 0.00053 dB (the card's FFT tier read 0.00037-0.00045 dB on the
    survey's mel planes)."""
    from portbench import check
    from portbench.reference import spec

    setting = {"win_ms": 40.0, "t_overlap": 4, "f_overlap": 1,
               "freq_scale": "linear", "db_range": 120.0}
    win, hop, n_fft = spec.stft_params(sr, setting)
    rng = np.random.default_rng(sr)
    t = np.arange(win + 3 * hop) / sr
    mono = (0.3 * np.sin(2 * np.pi * 23000 * t * (1 + 2 * t))
            + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
    ref = spec.linear_db(mono, sr, setting, "cpu")
    padded = reflect_pad_center(mono, win)
    window = default_stft_window(win, n_fft)
    left = (n_fft - win) // 2
    x = np.zeros((ref.shape[0], n_fft), np.float32)
    for k in range(ref.shape[0]):
        x[k, left:left + win] = padded[k * hop:k * hop + win] * window
    got = torch.from_numpy(_fft_model(x, n_fft, linear=True))
    assert got.shape == ref.shape == (8, n_fft // 2 + 1)
    gap = check.db_gap(got, ref)
    assert gap < 0.01, gap


# The linear scale's tiers: tier_for with n_mel None, the FFT tier's
# linear record and entry point, and LinearRoute on the CPU and (stubbed)
# on a card.

@pytest.mark.parametrize("mode", ["parity", "fast"])
@pytest.mark.parametrize("sr,n_fft", [(8000, 512), (48000, 2048),
                                      (96000, 4096), (192000, 8192),
                                      (384000, 16384), (768000, 32768)])
def test_tier_for_takes_the_linear_fft_tier_where_n_fft_has_a_plan(
        sr, n_fft, mode):
    """On the linear scale (n_mel None) a parity call takes "fft" wherever
    n_fft has an FFT plan (4096 to 32 768) and "gemm" below; fast mode, the
    judge's control, keeps the TF32 GEMM pair at every rate."""
    p = derive_stft_params(sr, SpecSetting())
    assert p.n_fft == n_fft
    want = "fft" if mode == "parity" and n_fft in K.FFT_PLANS else "gemm"
    assert K.tier_for(mode, p.win_length, p.hop_length, n_fft, None) == want
    route = K.LinearRoute(default_stft_window(p.win_length, n_fft),
                          win=p.win_length, hop=p.hop_length, n_fft=n_fft,
                          device="cuda")
    assert route.tier(mode) == want and route.tier_here(mode) == want
    assert K.LinearRoute(None, win=p.win_length, hop=p.hop_length,
                         n_fft=n_fft, device="cpu",
                         dense=lambda: None).tier_here(mode) == "plain"


def test_linear_fft_records_hold_no_dft_operands():
    """The linear FFT tier's record carries the window and the twiddle
    table, and no C, S or filterbank; an n_fft without a plan raises."""
    win, hop, _, _, fb = _setup(384000)
    n_fft = 2 * (fb.shape[0] - 1)
    window = default_stft_window(win, n_fft)
    rec = K.prepare_linear_fft_operands(window, n_fft, "cpu")
    assert [f.name for f in dataclasses.fields(rec)] == [
        "window", "twiddles", "n_fft"]
    assert (rec.win, rec.n_fft) == (win, n_fft)
    assert torch.equal(rec.window, torch.from_numpy(window))
    assert torch.equal(rec.twiddles, torch.from_numpy(K.fft_twiddles(n_fft)))
    with pytest.raises(ValueError, match="no plan"):
        K.prepare_linear_fft_operands(window, 12288, "cpu")
    with pytest.raises(ValueError, match="on a card"):
        K.linear_spectrogram_cuda(torch.zeros(win + 3 * hop), rec, win=win,
                                  hop=hop, n_frames=4)


def test_a_linear_launch_takes_the_linear_entry_point():
    """A launch of a linear record calls the linear entry point and reads
    as tier "fft"; where its block does not fit it raises the ValueError
    that names the linear FFT kernel."""
    win, hop, _, _, fb = _setup(192000)
    n_fft = 2 * (fb.shape[0] - 1)
    rec = K.prepare_linear_fft_operands(default_stft_window(win, n_fft),
                                        n_fft, "cpu")
    wave = torch.zeros((1, win + 3 * hop))
    out = torch.empty((4, n_fft // 2 + 1))
    lib = _FakeLib((3, 1, 0, 0, 34816, 232448), 0)
    got = K._launch(lib, "parity", wave, rec, out, win, hop, 4, None, 0)
    assert lib.called == [K.LINEAR_ENTRY_POINT]
    assert got == {"tier": "fft", "mt": 1, "stages": 0, "chunk": 0,
                   "smem_bytes": 34816}
    with pytest.raises(ValueError, match="linear FFT kernel"):
        K._launch(_FakeLib((0, 0, 0, 0, 300000, 232448), 9), "parity", wave,
                  rec, out, win, hop, 4, None, 0)


@pytest.mark.parametrize("engine", ["auto", "xla"])
def test_a_linear_route_on_the_cpu_is_the_plain_pair(engine, rng):
    """A LinearRoute on the CPU gives spec_pipeline_batched's planes and
    min/max on its C and S bit for bit (B = 2 into ``out``, and an (L,)
    wave), under either engine, each call one ``linear.launch`` span of
    tier "plain"; the card's counter does not move."""
    from msv_tpu_torch import config as tcfg
    from msv_tpu_torch.kernels.pipeline import spec_pipeline_batched
    from msv_tpu_torch.utils import profiling

    win, hop, c, s, _ = _setup(16000)
    n_fft = 2 * (c.shape[1] - 1)
    route = K.LinearRoute(default_stft_window(win, n_fft), win=win, hop=hop,
                          n_fft=n_fft, device="cpu")
    x = torch.from_numpy(_signal(rng, 4000, batch=2))
    nf = (x.shape[1] - win) // hop + 1
    kw = dict(win=win, hop=hop, n_frames=nf, use_mel=False, mode="parity")
    n_valid = torch.tensor([nf, nf - 3])
    want = spec_pipeline_batched(x, *K.operands_from_numpy(c, s, None)[:2],
                                 None, n_valid, **kw)
    out = torch.empty_like(want[0])
    counts = dict(K.LINEAR_LAUNCHES_BY_TIER)
    profiling.clear()
    tcfg.set_engine(engine)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            got = route(x, nf, n_valid, mode="parity", out=out, sr=16000)
            one = route(x[1], nf, nf - 3, mode="parity")
    finally:
        tcfg.set_engine("auto")
    spans = [(sp.attrs["sr"], sp.attrs["batch"], sp.attrs["n_out"],
              sp.attrs["tier"]) for sp in profiling.recorded()
             if sp.name == "linear.launch"]
    profiling.clear()
    assert got[0] is out
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, w in zip(one, want):
        assert torch.equal(g, w[1])
    assert spans == [(16000, 2, n_fft // 2 + 1, "plain"),
                     (None, 1, n_fft // 2 + 1, "plain")]
    assert K.LINEAR_LAUNCHES_BY_TIER == counts


@pytest.mark.parametrize("sr", [48000, 96000, 192000, 384000])
def test_a_linear_route_on_a_card_builds_no_c_or_s_at_the_fft_tier(
        sr, monkeypatch):
    """LinearRoute on a card (the uploads recorded instead of made):
    ``prepare`` in parity builds no C or S where the route takes the FFT
    tier, and its record is made from the window alone; at 48 kHz, in fast
    mode and under the "xla" engine the route reads C and S."""
    from msv_tpu_torch import config as tcfg

    asked = []
    real = K.operands_from_numpy

    def upload(c, s, fb, device):
        asked.append(str(device))
        return real(c, s, fb)

    monkeypatch.setattr(K, "operands_from_numpy", upload)
    p = derive_stft_params(sr, SpecSetting())
    window = default_stft_window(p.win_length, p.n_fft)

    def route():
        return K.LinearRoute(window, win=p.win_length, hop=p.hop_length,
                             n_fft=p.n_fft, device="cuda")

    fft = sr > 48000
    r = route()
    r.prepare("parity")
    assert r.tier_here("parity") == ("fft" if fft else "gemm")
    assert asked == ([] if fft else ["cuda"])
    if fft:
        monkeypatch.setattr(K, "prepare_linear_fft_operands",
                            lambda w, n, d: K.LinearOperands(
                                torch.from_numpy(w), None, n))
        assert r.record().window.shape == (p.win_length,)
        assert sorted(r._forms) == ["record"]
    asked.clear()
    route().prepare("fast")
    tcfg.set_engine("xla")
    try:
        route().prepare("parity")
    finally:
        tcfg.set_engine("auto")
    assert asked == ["cuda", "cuda"]
