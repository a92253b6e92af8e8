"""The split-f32 mode of the port's mel dB kernel module against the JAX
package's Pallas kernel in split mode (tests/test_pallas_kernel.py:225-292).

On the CPU ``mel_spectrogram_cuda(mode="split")`` runs the plain version:
each f32 product as three f32 matmuls on bf16 values (hi.hi + hi.lo +
lo.hi).  Tolerances:

* against the Pallas kernel interpreted with split operands: atol 2e-3 dB,
  rtol 1e-4, the kernel bound of tests/test_pallas_kernel.py:65.  The two
  compute the same function; they differ by f32 summation order (the
  Pallas kernel adds three dense dots, the port sums products in another
  order and multiplies only each mel band's support);
* against parity, the JAX test's own bounds (:266-271): max < 0.47 dB (one
  120 dB / 255 grey step), under a twentieth of fast mode's max, p99 < 0.01
  dB;
* the int16 route equals the f32 route exactly: a 16-bit sample splits
  exactly into (hi, lo);
* a ``prepare_operands(mode="split")`` record gives the same bits as the
  hi/lo stacks it was made from (its layout is pinned in
  tests/test_torch_tf32.py).

The CUDA kernel is held to the plain version on the card only:
python -m pytest --noconftest -m gpu tests/test_torch_split.py
"""

import importlib.util
import os
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

ATOL, RTOL = 2e-3, 1e-4
GREY_STEP = 0.47  # dB: one 120 dB / 255 grey level
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jx():
    """The JAX package's reference functions (absent on the card)."""
    jnp = pytest.importorskip("jax.numpy")
    from msv_tpu.kernels import spectrogram_pallas

    return types.SimpleNamespace(jnp=jnp, pallas=spectrogram_pallas)


def _setup(sr, win_ms=40.0):
    p = derive_stft_params(sr, SpecSetting(win_ms=win_ms))
    window = default_stft_window(p.win_length, p.n_fft)
    c, s = windowed_dft_matrices(window, p.n_fft)
    return p.win_length, p.hop_length, c, s, calc_mel_fb_default(sr, p.n_fft)


def _two_tone(sr, rng):
    """tests/test_pallas_kernel.py:241-244's signal: two tones over faint
    noise, one second."""
    t = np.arange(sr) / sr
    return (0.4 * np.sin(2 * np.pi * 220 * t)
            + 0.2 * np.sin(2 * np.pi * 1367 * t)
            + 0.005 * rng.standard_normal(len(t))).astype(np.float32)


def _pallas(jx, padded, ops, win, hop, n_frames, n_mel, mode):
    """The Pallas kernel interpreted on one padded row, 128 frames."""
    jnp, pl = jx.jnp, jx.pallas
    wav2d = pl.prepare_wav2d(padded, win, hop, n_frames)
    out = pl.mel_spectrogram_pallas(
        jnp.asarray(wav2d), *(jnp.asarray(a) for a in ops), win=win, hop=hop,
        n_frames=n_frames, interpret=True, tile_f=128, mode=mode)
    return np.asarray(out)[:, :n_mel]


def _pallas_modes(jx, sr, rng):
    """(port split plain, Pallas split, Pallas parity, Pallas fast) on the
    JAX test's two-tone signal at 128 frames."""
    import ml_dtypes

    pl = jx.pallas
    win, hop, c, s, fb = _setup(sr)
    n_frames = 128  # zero-tailed past the second at 16 kHz, as there
    padded = reflect_pad_center(_two_tone(sr, rng), win)
    padded = np.pad(padded, (0, max(0, (n_frames - 1) * hop + win
                                    - len(padded))))
    c3, s3, fb3, n_mel = pl.prepare_matrices(c, s, fb, win)
    c4, s4, fb4, _ = pl.prepare_matrices_split(c, s, fb, win)
    bf = tuple(a.astype(ml_dtypes.bfloat16) for a in (c3, s3, fb3))
    kw = dict(win=win, hop=hop, n_frames=n_frames, n_mel=n_mel)
    ref = {mode: _pallas(jx, padded, ops, mode=mode, **kw)
           for mode, ops in (("split", (c4, s4, fb4)),
                             ("parity", (c3, s3, fb3)), ("fast", bf))}
    stacks = K.operands_split(*K.operands_from_numpy(c, s, fb))
    call = dict(win=win, hop=hop, n_frames=n_frames, mode="split")
    got = K.mel_spectrogram_cuda(torch.from_numpy(padded), *stacks,
                                 **call).numpy()
    ref["record"] = K.mel_spectrogram_cuda(
        torch.from_numpy(padded), K.prepare_operands(*stacks, "split"),
        **call).numpy()
    return got, ref


@pytest.fixture(scope="module")
def modes(jx):
    rng = np.random.default_rng(20261016)
    return {sr: _pallas_modes(jx, sr, rng) for sr in (16000, 48000)}


@pytest.mark.parametrize("sr", [16000, 48000])
def test_operands_split_equal_prepare_matrices_split(sr, jx):
    pl = jx.pallas
    win, _, c, s, fb = _setup(sr)
    got = K.operands_split(*K.operands_from_numpy(c, s, fb))
    c4, s4, fb4, n_mel = pl.prepare_matrices_split(c, s, fb, win)
    n_freq = c.shape[1]

    def untile(a4, rows, cols):  # (nk, 2, rows_p, 256) -> (2, rows, cols)
        a = np.asarray(a4, np.float32)
        return a.transpose(1, 2, 0, 3).reshape(2, a.shape[2], -1)[
            :, :rows, :cols]

    want = (untile(c4, win, n_freq), untile(s4, win, n_freq),
            np.asarray(fb4, np.float32).transpose(1, 0, 2, 3)
            .reshape(2, -1, fb4.shape[-1])[:, :n_freq, :n_mel])
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.is_contiguous()
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.float().numpy(), w)


@pytest.mark.parametrize("sr", [16000, 48000])
def test_plain_split_matches_pallas_split_interpret(sr, modes):
    got, ref = modes[sr]
    assert got.shape == ref["split"].shape == (128, ref["split"].shape[1])
    d = np.abs(got - ref["split"])
    print(f"split plain vs Pallas split, {sr} Hz: max {d.max():.3g} dB")
    np.testing.assert_allclose(got, ref["split"], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("sr", [16000, 48000])
def test_split_record_on_cpu_equals_stacks_route(sr, modes):
    got, ref = modes[sr]
    np.testing.assert_array_equal(ref["record"], got)
    np.testing.assert_allclose(ref["record"], ref["split"], atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("sr", [16000, 48000])
def test_split_accuracy_between_fast_and_parity(sr, modes):
    got, ref = modes[sr]
    d_split = np.abs(got - ref["parity"])
    d_fast = np.abs(ref["fast"] - ref["parity"]).max()
    print(f"{sr} Hz vs parity: split max {d_split.max():.3g} dB p99 "
          f"{np.percentile(d_split, 99):.3g} dB, fast max {d_fast:.3g} dB")
    assert d_split.max() < GREY_STEP
    assert d_split.max() < d_fast / 20
    assert np.percentile(d_split, 99) < 0.01


@pytest.mark.parametrize("sr", [8000, 22050])
def test_split_int16_route_equals_f32_route(sr, rng):
    win, hop, c, s, fb = _setup(sr)
    i16 = (rng.standard_normal((2, sr // 4)) * 8000).astype(np.int16)
    f32 = i16.astype(np.float32) * np.float32(2.0**-15)
    n_frames = n_frames_for(i16.shape[1], win, hop)
    ops = K.operands_split(*K.operands_from_numpy(c, s, fb))
    out = [K.mel_spectrogram_cuda(
        torch.from_numpy(np.stack([reflect_pad_center(w, win) for w in wav])),
        *ops, win=win, hop=hop, n_frames=n_frames, mode="split").numpy()
        for wav in (i16, f32)]
    np.testing.assert_array_equal(out[0], out[1])


def test_plain_split_takes_f32_or_split_operands(rng):
    win, hop, c, s, fb = _setup(8000)
    padded = torch.from_numpy(reflect_pad_center(
        (rng.standard_normal(4000) * 0.3).astype(np.float32), win))
    ops = K.operands_from_numpy(c, s, fb)
    kw = dict(win=win, hop=hop, n_frames=n_frames_for(4000, win, hop),
              mode="split")
    assert torch.equal(K.mel_spectrogram_plain(padded, *ops, **kw),
                       K.mel_spectrogram_plain(padded,
                                               *K.operands_split(*ops), **kw))


def _mixed():
    win, _, c, s, fb = _setup(8000)
    plain = K.operands_from_numpy(c, s, fb)
    split = K.operands_split(*plain)
    bf16 = K.operands_bf16(*plain)
    return [
        ("split c, plain s and fb", (split[0], *plain[1:]), "split"),
        ("split c, plain s and fb (parity)", (split[0], *plain[1:]),
         "parity"),
        ("bf16 fb among split", (*split[:2], bf16[2]), "split"),
        ("split stacks in fast mode", split, "fast"),
        ("bf16 operands in split mode", bf16, "split"),
        ("f32 operands in split mode", plain, "split"),
        ("three-plane stack", (torch.cat([split[0], split[0][:1]]),
                               *split[1:]), "split"),
    ]


@pytest.mark.parametrize("case", _mixed(), ids=lambda t: t[0])
def test_mixed_split_and_plain_operands_raise(case):
    _, ops, mode = case
    win, hop = 320, 80
    wave = torch.zeros(9 * hop + win)
    with pytest.raises(ValueError, match="c, s and fb must all be"):
        K.mel_spectrogram_cuda(wave, *ops, win=win, hop=hop, n_frames=10,
                               mode=mode)


def test_split_bands_cover_both_planes():
    _, _, c, s, fb = _setup(8000)
    fb[3, 2] = 1e-30  # hi and lo both keep it: inside the support
    stacks = K.operands_split(*K.operands_from_numpy(c, s, fb))
    assert torch.equal(K.mel_bands(stacks[2]),
                       K.mel_bands(torch.from_numpy(fb)))
    assert torch.equal(K.prepare_operands(*stacks, "split").bands,
                       K.mel_bands(torch.from_numpy(fb)))


@pytest.mark.parametrize("mode", ["parity", "fast"])
def test_record_of_another_mode_given_to_split_raises(mode, rng):
    win, hop, c, s, fb = _setup(8000)
    ops = K.operands_from_numpy(c, s, fb)
    rec = K.prepare_operands(*(K.operands_bf16(*ops) if mode == "fast"
                               else ops), mode)
    padded = torch.from_numpy(reflect_pad_center(
        (rng.standard_normal(4000) * 0.3).astype(np.float32), win))
    kw = dict(win=win, hop=hop, n_frames=n_frames_for(4000, win, hop))
    with pytest.raises(ValueError, match="prepared for mode"):
        K.mel_spectrogram_cuda(padded, rec, mode="split", **kw)
    split = K.prepare_operands(*K.operands_split(*ops), "split")
    with pytest.raises(ValueError, match="prepared for mode"):
        K.mel_spectrogram_cuda(padded, split, mode=mode, **kw)
    with pytest.raises(ValueError, match="prepared for win"):
        K.mel_spectrogram_cuda(padded, split, mode="split",
                               **dict(kw, win=win - 16))


def test_split_record_int16_route_equals_f32_route_and_out(rng):
    """The record on the CPU: int16 bit-equal to f32, and ``out=`` a row
    range of a larger plane."""
    win, hop, c, s, fb = _setup(22050)
    i16 = (rng.standard_normal((3, 22050 // 4)) * 8000).astype(np.int16)
    f32 = i16.astype(np.float32) * np.float32(2.0**-15)
    n_frames = n_frames_for(i16.shape[1], win, hop)
    rec = K.prepare_operands(
        *K.operands_split(*K.operands_from_numpy(c, s, fb)), "split")
    kw = dict(win=win, hop=hop, n_frames=n_frames, mode="split")
    got = [K.mel_spectrogram_cuda(
        torch.from_numpy(np.stack([reflect_pad_center(w, win) for w in wav])),
        rec, **kw) for wav in (i16, f32)]
    assert torch.equal(got[0], got[1])
    plane = torch.full((5, n_frames, fb.shape[1]), 7.0)
    x = torch.from_numpy(np.stack([reflect_pad_center(w, win) for w in f32]))
    assert K.mel_spectrogram_cuda(x, rec, out=plane[1:4], **kw) is not None
    assert torch.equal(plane[1:4], got[1])
    assert bool((plane[0] == 7.0).all()) and bool((plane[4] == 7.0).all())


def test_split_cpu_route_is_not_counted_as_a_launch(rng):
    win, hop, c, s, fb = _setup(8000)
    padded = reflect_pad_center((rng.standard_normal(4000) * 0.3)
                                .astype(np.float32), win)
    before = (K.LAUNCHES, dict(K.LAUNCHES_BY_MODE))
    K.mel_spectrogram_cuda(torch.from_numpy(padded), *K.operands_split(
        *K.operands_from_numpy(c, s, fb)), win=win, hop=hop,
        n_frames=n_frames_for(4000, win, hop), mode="split")
    assert (K.LAUNCHES, K.LAUNCHES_BY_MODE) == before
    assert "split" in K.MODES and K.SOURCES["split"].endswith(
        "mel_spectrogram_split.cu")


def _chip_smoke():
    """chip_smoke.py as a module: its f32_agree rule and f64 witness."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_plain_split_agrees_with_f64_witness_on_white_noise():
    """White noise through a 120 ms window at 48 kHz (1392 bands, many of a
    single DFT bin, so some bands sit 70 dB under their frame's peak): the
    plain split version is within f32_agree of an f64 witness of the same
    split operands in every bin."""
    cs = _chip_smoke()
    win, hop, c, s, fb = _setup(48000, 120.0)
    i16 = (np.random.default_rng(48000).standard_normal((2, 3 * 48000))
           * 8000).astype(np.int16)
    n_frames = n_frames_for(i16.shape[1], win, hop)
    padded = np.stack([reflect_pad_center(w, win) for w in i16])
    ops = K.operands_from_numpy(c, s, fb)
    got = K.mel_spectrogram_plain(torch.from_numpy(padded),
                                  *K.operands_split(*ops), win=win, hop=hop,
                                  n_frames=n_frames, mode="split")
    want = cs.f64_witness(padded, *ops, win, hop, n_frames).float()
    agree, _ = cs.f32_agree(got, want)
    assert bool(agree.all())


@pytest.mark.gpu
@pytest.mark.parametrize("sr,win_ms", [(8000, 40.0), (22050, 40.0),
                                       (44100, 40.0),   # odd hop, 4 m-tiles
                                       (48000, 40.0),   # 4
                                       (48000, 80.0),   # 2
                                       (48000, 120.0)])  # 1
def test_split_kernel_matches_plain_on_the_card(sr, win_ms):
    """Against the plain version by chip_smoke's f32_agree rule (atol 2e-3
    dB, rtol 1e-4, or, 60 dB or more under the frame's peak, within 1e-6 of
    that peak in amplitude, for at most 0.1% of bins: f32 summation order
    moves deep bins), int16 bit-equal to f32, batch rows independent."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = _chip_smoke()
    win, hop, c, s, fb = _setup(sr, win_ms)
    # chip_smoke's audio (swept tones over noise): on white noise a 120 ms
    # window puts one-bin bands 70 dB under their frame's peak, where the
    # tensor cores' f32 sums can pass f32_agree's floor, which was set for
    # SIMT sums
    i16 = cs.make_signal(np.random.default_rng(sr), sr, 3.0, 2)
    f32 = i16.astype(np.float32) * np.float32(2.0**-15)
    n_frames = n_frames_for(i16.shape[1], win, hop)
    ops = K.operands_split(*K.operands_from_numpy(c, s, fb, "cuda"))
    out = {}
    for name, wav in (("i16", i16), ("f32", f32)):
        padded = np.stack([reflect_pad_center(w, win) for w in wav])
        x = torch.from_numpy(padded).cuda()
        before = K.LAUNCHES_BY_MODE["split"]
        out[name] = K.mel_spectrogram_cuda(x, *ops, win=win, hop=hop,
                                           n_frames=n_frames, mode="split")
        assert K.LAUNCHES_BY_MODE["split"] == before + 1
    plain = K.mel_spectrogram_plain(x, *ops, win=win, hop=hop,
                                    n_frames=n_frames, mode="split")
    one = K.mel_spectrogram_cuda(x[1], *ops, win=win, hop=hop,
                                 n_frames=n_frames, mode="split")
    torch.cuda.synchronize()
    assert torch.equal(out["i16"], out["f32"])
    assert torch.equal(one, out["f32"][1])
    cs.check_f32(out["f32"], plain, f"split kernel {sr} Hz {win_ms} ms")


def _card_case(name):
    """(sr, win, hop, c, s, fb, seconds, rows): shapes the frame and bin
    tiling must mask."""
    if name == "odd hop":  # 44.1 kHz: hop 441, 111 slabs padded to 112
        return (44100, *_setup(44100)[:5], 3.0, 2)
    if name == "n_fft 400":  # Whisper's DFT: 200 bins, a padded last tile
        from msv_tpu_torch.ops.mel import calc_mel_fb
        from msv_tpu_torch.ops.windows import hann

        c, s = windowed_dft_matrices(hann(400, False), 400)
        return (16000, 400, 160, c, s, calc_mel_fb(
            16000, 400, 80, 0.0, None, "slaney", np.float32), 2.0, 2)
    if name == "few frames":  # 37 frames: under one frame tile
        return (8000, *_setup(8000)[:5], 0.36, 2)
    assert name == "ragged batch of 3"  # 24 kHz, 301 frames: 4 tiles + 45
    return (24000, *_setup(24000)[:5], 3.0, 3)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["odd hop", "n_fft 400", "few frames",
                                  "ragged batch of 3"])
def test_split_kernel_takes_a_record_on_the_card(case):
    """The prepared record on the card against the plain version
    (f32_agree): int16 bit-equal to f32, two launches bit-identical, one
    launch counted per call, ``out=`` a row range of a larger plane."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = _chip_smoke()
    sr, win, hop, c, s, fb, seconds, rows = _card_case(case)
    stacks = K.operands_split(*K.operands_from_numpy(c, s, fb, "cuda"))
    rec = K.prepare_operands(*stacks, "split")
    if case == "n_fft 400":
        assert rec.n_tiles * rec.nb > rec.n_freq - 1  # a padded last tile
    i16 = cs.make_signal(np.random.default_rng(sr), sr, seconds, rows)
    n_frames = n_frames_for(i16.shape[1], win, hop)
    if case == "few frames":
        assert n_frames < 64
    padded = np.stack([reflect_pad_center(w, win) for w in i16])
    x = {"i16": torch.from_numpy(padded).cuda(),
         "f32": torch.from_numpy(padded.astype(np.float32)
                                 * np.float32(2.0**-15)).cuda()}
    kw = dict(win=win, hop=hop, n_frames=n_frames, mode="split")
    before = K.LAUNCHES_BY_MODE["split"]
    got = {k: K.mel_spectrogram_cuda(v, rec, **kw) for k, v in x.items()}
    assert K.LAUNCHES_BY_MODE["split"] == before + 2
    again = K.mel_spectrogram_cuda(x["f32"], rec, **kw)
    plane = torch.full((rows + 2, n_frames, fb.shape[1]), 7.0, device="cuda")
    K.mel_spectrogram_cuda(x["f32"], rec, out=plane[1 : rows + 1], **kw)
    assert K.LAUNCHES_BY_MODE["split"] == before + 4
    plain = K.mel_spectrogram_plain(x["f32"], *stacks, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got["i16"], got["f32"])
    assert torch.equal(again, got["f32"])
    assert torch.equal(plane[1 : rows + 1], got["f32"])
    assert bool((plane[0] == 7.0).all()) and bool((plane[-1] == 7.0).all())
    cs.check_f32(got["f32"], plain, f"split kernel, {case}")


@pytest.mark.gpu
def test_split_kernel_one_bin_bands_of_white_noise_vs_f64():
    """White noise through a 120 ms window at 48 kHz (one-bin bands 70 dB
    under their frame's peak): the kernel adds each slab's tensor-core sums
    by FADD, so it, like its plain version, is held to an f64 witness of
    the same split operands by chip_smoke's f32_agree rule."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cs = _chip_smoke()
    win, hop, c, s, fb = _setup(48000, 120.0)
    i16 = (np.random.default_rng(48000).standard_normal((2, 3 * 48000))
           * 8000).astype(np.int16)
    n_frames = n_frames_for(i16.shape[1], win, hop)
    padded = np.stack([reflect_pad_center(w, win) for w in i16])
    ops = K.operands_from_numpy(c, s, fb, "cuda")
    stacks = K.operands_split(*ops)
    x = torch.from_numpy(padded).cuda()
    kw = dict(win=win, hop=hop, n_frames=n_frames)
    got = K.mel_spectrogram_cuda(x, K.prepare_operands(*stacks, "split"),
                                 mode="split", **kw).cpu()
    plain = K.mel_spectrogram_plain(x, *stacks, mode="split", **kw).cpu()
    wit = cs.f64_witness(padded, *ops, **kw).float()
    for name, y in (("kernel", got), ("plain", plain)):
        err, note = cs.check_f32(y, wit, f"split {name} vs the f64 witness")
        print(f"white noise 48 kHz 120 ms, split {name} vs f64: max|err| "
              f"{err:.3g} dB ({note})")
