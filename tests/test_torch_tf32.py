"""The three kernels' prepared operands and the parity kernel's 3xTF32
arithmetic, on the CPU.

* ``prepare_operands`` lays C and S out as the kernels' ring stages: its
  slabs un-tile to C and S (for split: to the four hi/lo planes, out of the
  8 x 8 core matrices a wgmma descriptor reads) bit-exactly, with zeros in
  the padding; the last bin's columns are kept apart, so tiles cover
  n_freq - 1 bins (no launch walks K for a tile of one bin); ``bands`` are
  ``mel_bands(fb)``; every slab is a 16-byte multiple.
* ``split_tf32`` rounds as ``cvt.rna.tf32.f32`` does, and a 16-bit sample
  splits exactly.
* A 3xTF32 emulation of the parity function (three f32 matmuls over tf32
  hi/lo values, whose products are exact in f32) is held to msv_tpu's
  parity pipeline on JAX's CPU backend by chip_smoke's ``f32_agree`` rule,
  on chip_smoke's swept tones at the six default rates and on white noise
  through a 120 ms window at 48 kHz (one-bin bands 70 dB under their
  frame's peak).

The kernels themselves run on the card only (tests/test_torch_kernel.py).

And the precision scopes of the torch-op GEMMs (``config.precision_for``):
"fast" turns TF32 on as "parity" turns it off, each giving the caller's
flags back; scopes of the two modes never overlap across threads (the
other mode waits, in arrival order) and raise on one thread; the linear
routes (``spec_pipeline``, ``spec_pipeline_batched``, streaming's torch
step, the session) run in the scope of their mode, while the routes that
emulate bf16 (``_features_core``, the kernels' plain versions) stay in
true f32; a linear session in fast mode equals msv_tpu's on the CPU within
tests/test_torch_linear.py's bounds (TF32 flags change nothing on the CPU,
so this pins the plumbing, not the card's numbers).
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
from msv_tpu_torch.ops.stft import frame_device  # noqa: E402
from msv_tpu_torch.ops.windows import default_stft_window  # noqa: E402

RATES = [8000, 16000, 22050, 24000, 44100, 48000]
MODES = ["parity", "fast", "split"]
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """chip_smoke.py as a module: its f32_agree rule and swept tones."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.fixture(scope="module")
def cs():
    return _chip_smoke()


@pytest.fixture(scope="module")
def jx():
    """The JAX package's parity pipeline (absent on the card)."""
    jnp = pytest.importorskip("jax.numpy")
    from msv_tpu.kernels import pipeline

    return types.SimpleNamespace(jnp=jnp, pipeline=pipeline)


def _setup(sr, setting=SpecSetting()):
    p = derive_stft_params(sr, setting)
    c, s = windowed_dft_matrices(default_stft_window(p.win_length, p.n_fft),
                                 p.n_fft)
    return p.win_length, p.hop_length, c, s, calc_mel_fb_default(sr, p.n_fft)


def _operands(sr, mode, setting=SpecSetting()):
    win, hop, c, s, fb = _setup(sr, setting)
    ops = K.operands_from_numpy(c, s, fb)
    if mode == "split":
        return K.operands_split(*ops)
    return K.operands_bf16(*ops) if mode == "fast" else ops


def _planes(c, s):
    """The planes the ring carries: C, S, or Ch, Cl, Sh, Sl."""
    return [*c.reshape(-1, *c.shape[-2:]), *s.reshape(-1, *s.shape[-2:])]


def _untile(prep):
    """(planes, win_p, n_tiles * nb) from the slabs.  Parity and fast: the
    rows' columns [0, nb).  Split: element by element out of the core
    matrices, written apart from prepare_operands' reshape: slab (t, j)
    holds row j*ks + 8*a + r, bin t*nb + 8*b + q of plane p at byte offset
    ((((p*2 + a) * (nb/8) + b) * 8 + r) * 8 + q) * 2."""
    if prep.mode != "split":
        t, k, _, ks, _ = prep.slabs.shape
        body = prep.slabs[..., : prep.nb].permute(2, 1, 3, 0, 4)
        return body.reshape(2, k * ks, t * prep.nb)
    n_t, n_k = prep.slabs.shape[:2]
    flat = prep.slabs.reshape(n_t, n_k, -1).float().numpy()
    ks, nb = prep.ks, prep.nb
    out = np.empty((4, n_k * ks, n_t * nb), np.float32)
    p, row, col = np.meshgrid(np.arange(4), np.arange(ks), np.arange(nb),
                              indexing="ij")
    a, r, b, q = row // 8, row % 8, col // 8, col % 8
    off = (((p * (ks // 8) + a) * (nb // 8) + b) * 8 + r) * 8 + q
    for t in range(n_t):
        for j in range(n_k):
            out[:, j * ks : (j + 1) * ks, t * nb : (t + 1) * nb] = (
                flat[t, j][off])
    return torch.from_numpy(out).to(prep.slabs.dtype)


def _n_slabs(prep):
    """Slabs per tile: the window's rows in slabs of ks; split pads them to
    an even number (its slab loop runs in pairs)."""
    n_k = -(-prep.win // prep.ks)
    return n_k + n_k % 2 if prep.mode == "split" else n_k


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sr", RATES)
def test_prepare_operands_untiles_exactly(sr, mode):
    c, s, fb = _operands(sr, mode)
    prep = K.prepare_operands(c, s, fb, mode)
    win, n_freq = c.shape[-2:]
    ks, nb, row = K.SLAB_LAYOUT[mode]
    assert (prep.mode, prep.ks, prep.nb, prep.row) == (mode, ks, nb, row)
    assert (prep.win, prep.n_freq) == (win, n_freq)
    assert prep.slabs.dtype == c.dtype and prep.slabs.is_contiguous()
    # tiles cover n_freq - 1 bins, none of them padded, at every default rate
    assert (n_freq - 1) % nb == 0 and prep.n_tiles * nb == n_freq - 1
    body = _untile(prep)
    planes = _planes(c, s)
    assert body.shape[0] == len(planes) == (4 if mode == "split" else 2)
    for got, want in zip(body, planes):
        assert torch.equal(got[:win, : n_freq - 1], want[:, :-1])
    assert not body[:, win:].any()  # rows past win
    if mode != "split":
        assert not prep.slabs[..., nb:].any()  # the row padding
    assert torch.equal(prep.tail,
                       torch.stack([p[:, -1] for p in planes], dim=1))
    assert prep.tail.is_contiguous() and prep.tail.shape == (win, len(planes))
    assert torch.equal(prep.bands, K.mel_bands(fb))
    assert torch.equal(prep.fb, fb) and prep.fb.is_contiguous()
    # the compact filterbank: each band's weights over its own bins (split:
    # as (hi, lo) pairs)
    for m, (lo, hi) in enumerate(prep.bands.tolist()):
        w0 = int(prep.woff[m])
        want = fb[:, lo:hi, m].T if mode == "split" else fb[lo:hi, m]
        assert torch.equal(prep.wts[w0 : w0 + hi - lo], want)
    assert prep.wts.is_contiguous() and prep.wts.shape[0] == int(
        (prep.bands[:, 1] - prep.bands[:, 0]).sum())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sr", RATES)
def test_slabs_are_whole_16_byte_runs(sr, mode):
    prep = K.prepare_operands(*_operands(sr, mode), mode)
    slab_bytes = prep.slabs[0, 0].numel() * prep.slabs.element_size()
    # C and S rows at the padded stride, or four planes of whole core
    # matrices (128 bytes each)
    elems = (4 * prep.ks * prep.nb if mode == "split"
             else 2 * prep.ks * prep.row)
    assert slab_bytes == elems * prep.slabs.element_size()
    assert slab_bytes % 16 == 0 and prep.slabs.data_ptr() % 16 == 0
    if mode == "split":
        assert prep.row == 8 and prep.ks % 8 == 0 and prep.nb % 8 == 0
        assert prep.tail.data_ptr() % 8 == 0 and prep.wts.data_ptr() % 4 == 0
    # slab q = (t, j) starts q * slab_bytes in: a whole number of 16 bytes
    assert prep.slabs.stride(1) * prep.slabs.element_size() == slab_bytes
    assert prep.slabs.shape[1] == _n_slabs(prep)


@pytest.mark.parametrize("mode", MODES)
def test_padded_last_tile_untiles_exactly(mode):
    """8 kHz at a 10 ms window and f_overlap=3: n_fft 384, 192 bins, no
    multiple of either tile width, so the last tile is zero-padded."""
    c, s, fb = _operands(8000, mode, SpecSetting(win_ms=10.0, f_overlap=3))
    prep = K.prepare_operands(c, s, fb, mode)
    win, n_freq = c.shape[-2:]
    assert n_freq - 1 == 192
    assert prep.n_tiles == -(-(n_freq - 1) // prep.nb)
    assert prep.n_tiles * prep.nb > n_freq - 1
    body = _untile(prep)
    planes = _planes(c, s)
    for got, want in zip(body, planes):
        assert torch.equal(got[:win, : n_freq - 1], want[:, :-1])
    assert not body[:, :, n_freq - 1 :].any() and not body[:, win:].any()
    assert torch.equal(prep.tail,
                       torch.stack([p[:, -1] for p in planes], dim=1))


def _rna_reference(x):
    """tf32 rounding (10 explicit mantissa bits, nearest, ties away from
    zero) in float64 arithmetic, independent of the bit trick."""
    x = np.asarray(x, np.float64)
    m, e = np.frexp(x)  # x = m * 2^e, 0.5 <= |m| < 1
    q = np.sign(m) * np.floor(np.abs(m) * 2.0**11 + 0.5)
    return (q * 2.0 ** (e - 11)).astype(np.float32)


def test_split_tf32_rounds_as_cvt_rna():
    rng = np.random.default_rng(11)
    x = rng.standard_normal(4096).astype(np.float32) * np.float32(1e3)
    bits = x.view(np.uint32) & np.uint32(0xFFFFE000)
    # exact ties (half a tf32 unit), both signs, and values one bit off
    x[:512] = (bits[:512] | np.uint32(0x1000)).view(np.float32)
    x[512:768] = (bits[512:768] | np.uint32(0x0FFF)).view(np.float32)
    x[768:1024] = (bits[768:1024] | np.uint32(0x1001)).view(np.float32)
    x[1024:1100] = bits[1024:1100].view(np.float32)  # already tf32
    edge = np.array([0.0, -0.0, 1.0, -1.0, 2.0**-126, 1.5 * 2.0**-130,
                     np.inf, -np.inf], np.float32)
    x = np.concatenate([x, edge])
    hi, lo = (t.numpy() for t in K.split_tf32(torch.from_numpy(x)))
    fin = np.isfinite(x)
    np.testing.assert_array_equal(hi[fin], _rna_reference(x[fin]))
    np.testing.assert_array_equal(hi[~fin], x[~fin])
    np.testing.assert_array_equal(lo[fin], _rna_reference(
        x[fin].astype(np.float64) - hi[fin].astype(np.float64)))
    # ties round away from zero
    t = x[:512]
    assert (np.abs(hi[:512]) > np.abs(t)).all()
    # hi has 11 significant bits at most, lo too, and hi + lo is within
    # 2^-21 of x
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    err = np.abs(hi[fin].astype(np.float64) + lo[fin] - x[fin])
    assert (err <= np.abs(x[fin]) * 2.0**-21).all()


def test_int16_samples_split_exactly():
    x = (np.arange(-32768, 32768, dtype=np.int32).astype(np.float32)
         * np.float32(2.0**-15))
    hi, lo = K.split_tf32(torch.from_numpy(x))
    assert torch.equal(hi + lo, torch.from_numpy(x))
    # the products of two splits are exact in f32: 11 x 11 bits
    a, b = hi[::97].double(), lo[::89].double()
    n = min(len(a), len(b))
    assert torch.equal((hi[::97][:n] * lo[::89][:n]).double(), a[:n] * b[:n])


def tf32x3_parity(padded, c, s, fb, *, win, hop, n_frames):
    """The parity kernel's function as it computes it on the card, in torch
    ops: each DFT product as xh*ch + xl*ch + xh*cl over ``split_tf32``
    values (three f32 matmuls; every product is exact in f32), the f32
    magnitude, the f32 mel product and the kernel's dB."""
    x = padded.to(torch.float32)
    if padded.dtype == torch.int16:
        x = x * 2.0**-15
    fh, fl = K.split_tf32(frame_device(x, win, hop, n_frames))
    (ch, cl), (sh, sl) = K.split_tf32(c), K.split_tf32(s)
    re = fh @ ch + fl @ ch + fh @ cl
    im = fh @ sh + fl @ sh + fh @ sl
    mel = torch.sqrt(re * re + im * im) @ fb
    return torch.where(mel > 1e-18, torch.log(mel) * (20.0 / np.log(10.0)),
                       -360.0)


def _jax_parity(jx, padded, c, s, fb, win, hop, n_frames):
    jnp = jx.jnp
    rows = np.atleast_2d(padded).astype(np.float32)
    if padded.dtype == np.int16:
        rows = rows * np.float32(2.0**-15)
    out = [np.asarray(jx.pipeline.spec_pipeline(
        jnp.asarray(r), jnp.asarray(c), jnp.asarray(s), jnp.asarray(fb),
        jnp.int32(n_frames), win=win, hop=hop, n_frames=n_frames,
        use_mel=True, mode="parity")[0]) for r in rows]
    return torch.from_numpy(np.stack(out))


def _hold_to_jax(cs, jx, i16, sr, setting=SpecSetting()):
    win, hop, c, s, fb = _setup(sr, setting)
    n_frames = n_frames_for(i16.shape[1], win, hop)
    padded = np.stack([reflect_pad_center(w, win) for w in i16])
    f32 = padded.astype(np.float32) * np.float32(2.0**-15)
    ops = K.operands_from_numpy(c, s, fb)
    kw = dict(win=win, hop=hop, n_frames=n_frames)
    got = tf32x3_parity(torch.from_numpy(f32), *ops, **kw)
    got16 = tf32x3_parity(torch.from_numpy(padded), *ops, **kw)
    assert torch.equal(got, got16)  # int16 splits exactly
    want = _jax_parity(jx, f32, c, s, fb, win, hop, n_frames)
    agree, close = cs.f32_agree(got, want)
    floor_share = (agree & ~close).float().mean().item()
    err = (got - want).abs()
    print(f"3xTF32 vs JAX parity, {sr} Hz: max {err.max().item():.3g} dB, "
          f"{int((~close).sum())} bins by the f32 floor")
    assert bool(agree.all()) and floor_share <= cs.FLOOR_SHARE


@pytest.mark.parametrize("sr", RATES)
def test_tf32x3_parity_matches_jax_on_swept_tones(sr, cs, jx):
    i16 = cs.make_signal(np.random.default_rng(sr), sr, 1.0, 2)
    _hold_to_jax(cs, jx, i16, sr)


def test_tf32x3_parity_matches_jax_on_white_noise_one_bin_bands(cs, jx):
    """A 120 ms window at 48 kHz: 1392 bands, many of one DFT bin, on white
    noise (the case that broke the split kernel's first card test)."""
    i16 = (np.random.default_rng(48000).standard_normal((2, 48000))
           * 8000).astype(np.int16)
    _hold_to_jax(cs, jx, i16, 48000, SpecSetting(win_ms=120.0))


@pytest.mark.parametrize("mode", MODES)
def test_cpu_route_takes_a_prepared_record(mode, rng):
    ops = _operands(8000, mode)
    win, hop = 320, 80
    padded = torch.from_numpy(reflect_pad_center(
        (rng.standard_normal(4000) * 0.3).astype(np.float32), win))
    kw = dict(win=win, hop=hop, n_frames=n_frames_for(4000, win, hop),
              mode=mode)
    prep = K.prepare_operands(*ops, mode)
    before = (K.LAUNCHES, dict(K.LAUNCHES_BY_MODE))
    assert torch.equal(K.mel_spectrogram_cuda(padded, prep, **kw),
                       K.mel_spectrogram_plain(padded, *ops, **kw))
    assert (K.LAUNCHES, K.LAUNCHES_BY_MODE) == before
    other = "fast" if mode == "parity" else "parity"  # a record of `mode`
    with pytest.raises(ValueError, match="prepared for mode"):
        K.mel_spectrogram_cuda(padded, prep, **dict(kw, mode=other))
    with pytest.raises(ValueError, match="prepared for win"):
        K.mel_spectrogram_cuda(padded, prep, **dict(kw, win=win - 1))
    with pytest.raises(TypeError):
        K.mel_spectrogram_cuda(padded, prep, ops[2], **kw)


@pytest.mark.parametrize("case", ["split", "bf16 in parity", "f32 in fast",
                                  "fb rows", "stacks in parity",
                                  "bf16 in split", "split fb rows",
                                  "no such mode"])
def test_prepare_operands_rejects_what_no_kernel_takes(case):
    c, s, fb = _operands(8000, "parity")
    stacks = K.operands_split(c, s, fb)
    args = {"split": ((c, s, fb), "split"),
            "bf16 in parity": (K.operands_bf16(c, s, fb), "parity"),
            "f32 in fast": ((c, s, fb), "fast"),
            "fb rows": ((c, s, fb[1:]), "parity"),
            "stacks in parity": (stacks, "parity"),
            "bf16 in split": (K.operands_bf16(c, s, fb), "split"),
            "split fb rows": ((*stacks[:2], stacks[2][:, 1:]), "split"),
            "no such mode": ((c, s, fb), "exact")}[case]
    with pytest.raises(ValueError):
        K.prepare_operands(*args[0], args[1])


# ------------------------------------------------------ precision scopes


def _tf32():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.fixture()
def caller_flags():
    """The caller's flags for a test: matmul off, cudnn on (a mix neither
    scope sets), restored after."""
    saved = _tf32()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    yield (False, True)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _in_thread(fn):
    import threading

    th = threading.Thread(target=fn, daemon=True)
    th.start()
    return th


def test_fast_scope_turns_tf32_on_nests_and_restores(caller_flags):
    import threading

    from msv_tpu_torch.config import precision_for

    with precision_for("fast"):
        assert _tf32() == (True, True)
        with precision_for("fast"):
            assert _tf32() == (True, True)
        assert _tf32() == (True, True)
    assert _tf32() == caller_flags
    # overlapping fast blocks in two threads: on until the last one leaves
    inside, go = threading.Event(), threading.Event()

    def other():
        with precision_for("fast"):
            inside.set()
            go.wait(10)

    th = _in_thread(other)
    assert inside.wait(10)
    with precision_for("fast"):
        assert _tf32() == (True, True)
    assert _tf32() == (True, True)  # the other block is still open
    go.set()
    th.join(10)
    assert not th.is_alive()
    assert _tf32() == caller_flags


@pytest.mark.parametrize("first", ["parity", "fast"])
def test_other_mode_waits_for_open_scopes(first, caller_flags):
    """A scope of the other mode opened in a second thread waits while the
    first is open; each reads its own mode's flags for as long as it is
    open, and the caller's come back after both."""
    import threading

    from msv_tpu_torch.config import precision_for

    second = "fast" if first == "parity" else "parity"
    want = {"parity": (False, False), "fast": (True, True)}
    entered, seen = threading.Event(), []

    def other():
        with precision_for(second):
            entered.set()
            seen.append(_tf32())

    with precision_for(first):
        th = _in_thread(other)
        assert not entered.wait(0.3)  # waits for the open scope
        assert _tf32() == want[first]
    th.join(10)
    assert not th.is_alive() and entered.is_set()
    assert seen == [want[second]]
    assert _tf32() == caller_flags


def test_waiting_mode_goes_before_later_arrivals(caller_flags):
    """Arrival order: while a fast scope waits for an open parity scope, a
    parity scope asked for later (not nested) waits behind it, so a stream
    of parity renders cannot starve a fast add."""
    import threading
    import time

    from msv_tpu_torch.config import _SCOPE_QUEUE, precision_for

    order = []

    def run(mode, tag):
        with precision_for(mode):
            order.append(tag)

    with precision_for("parity"):
        order.append("first parity")
        fast = _in_thread(lambda: run("fast", "fast"))
        deadline = time.time() + 10
        while not _SCOPE_QUEUE and time.time() < deadline:
            time.sleep(0.01)
        late = _in_thread(lambda: run("parity", "late parity"))
        time.sleep(0.2)
        with precision_for("parity"):  # nested: joins its own block
            order.append("nested parity")
    for th in (fast, late):
        th.join(10)
        assert not th.is_alive()
    assert order == ["first parity", "nested parity", "fast", "late parity"]
    assert _tf32() == caller_flags


@pytest.mark.parametrize("outer", ["parity", "fast"])
def test_other_mode_on_the_same_thread_raises(outer, caller_flags):
    from msv_tpu_torch.config import precision_for

    inner = "fast" if outer == "parity" else "parity"
    with precision_for(outer):
        with pytest.raises(RuntimeError, match="same thread"):
            with precision_for(inner):
                pass
        with precision_for(outer):  # the block is intact
            pass
    assert _tf32() == caller_flags
    with precision_for(inner):  # and the other mode opens afterwards
        assert _tf32()[0] is (inner == "fast")
    with pytest.raises(ValueError):
        precision_for("bf16")


def test_scopes_under_thread_stress(caller_flags):
    """Sixteen threads open parity and fast scopes in turns under a short
    switch interval: every block reads its own mode's flags the whole time
    it is open, and the caller's flags come back at the end."""
    import sys
    import threading

    from msv_tpu_torch import config as tcfg

    want = {"parity": (False, False), "fast": (True, True)}
    errors = []

    def worker(k):
        for i in range(40):
            mode = "fast" if (i + k) % 3 == 0 else "parity"
            with tcfg.precision_for(mode):
                for _ in range(3):
                    if _tf32() != want[mode]:
                        errors.append((k, i, mode, _tf32()))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ths = [_in_thread(lambda k=k: worker(k)) for k in range(16)]
        for th in ths:
            th.join(60)
        assert not any(th.is_alive() for th in ths)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert tcfg._SCOPE_OPEN == {"parity": 0, "fast": 0}
    assert tcfg._SCOPE_QUEUE == []
    assert _tf32() == caller_flags


def test_linear_routes_run_in_their_mode_s_scope(monkeypatch, rng,
                                                 caller_flags):
    """spec_pipeline, spec_pipeline_batched and streaming's torch step open
    precision_for(mode) around their GEMMs: TF32 on in fast, off in
    parity."""
    from msv_tpu_torch import config as tcfg
    from msv_tpu_torch.kernels import pipeline
    from msv_tpu_torch.parallel import streaming

    seen, scopes = [], []

    def spy_flags(mod):
        real = mod.dft_magnitude

        def wrapped(*a, **kw):
            seen.append(_tf32())
            return real(*a, **kw)

        monkeypatch.setattr(mod, "dft_magnitude", wrapped)

    def spy_scope(mod):
        def wrapped(mode):
            scopes.append(mode)
            return tcfg.precision_for(mode)

        monkeypatch.setattr(mod, "precision_for", wrapped)

    for mod in (pipeline, streaming):
        spy_flags(mod)
        spy_scope(mod)
    win, hop, c, s, _ = _setup(8000)
    c, s = torch.from_numpy(c), torch.from_numpy(s)
    x = torch.from_numpy((rng.standard_normal((2, 8000)) * 0.3)
                         .astype(np.float32))
    want = {"parity": (False, False), "fast": (True, True)}
    for mode in ("fast", "parity"):
        seen.clear()
        scopes.clear()
        kw = dict(win=win, hop=hop, n_frames=96, use_mel=False, mode=mode)
        pipeline.spec_pipeline(x[0], c, s, None, 90, **kw)
        pipeline.spec_pipeline_batched(x, c, s, None, [90, 90], **kw)
        with tcfg.precision_mode_scope(mode):
            streaming.streaming_spec_db(
                (rng.standard_normal(40000) * 3000).astype(np.int16), win,
                hop, c, s, None)
        assert scopes[:2] == [mode, mode] and set(scopes) == {mode}
        assert len(seen) >= 3 and set(seen) == {want[mode]}, mode
    assert _tf32() == caller_flags


def test_bf16_emulating_routes_stay_true_f32(monkeypatch, rng):
    """The routes that round their operands to bf16 keep their numbers:
    _features_core and the kernels' plain versions run true f32 GEMMs in
    fast mode too, whatever the process's flags."""
    from msv_tpu_torch import features

    seen = {}

    def spy(mod, name, route):
        real = getattr(mod, name)

        def wrapped(*a, **kw):
            seen.setdefault(route, []).append(_tf32())
            return real(*a, **kw)

        monkeypatch.setattr(mod, name, wrapped)

    spy(features, "frame_device", "features")
    spy(K, "_plain_mel", "plain kernel")
    saved = _tf32()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        x = torch.from_numpy((rng.standard_normal((1, 8000)) * 0.3)
                             .astype(np.float32))
        features.log_mel_spectrogram(x, 8000, n_mel=32, log="power_db",
                                     precision="fast")
        ops = _operands(8000, "fast")
        padded = torch.from_numpy(reflect_pad_center(x[0].numpy(), 320))
        K.mel_spectrogram_cuda(padded, *ops, win=320, hop=80, n_frames=90,
                               mode="fast")
        assert sorted(seen) == ["features", "plain kernel"]
        for route, flags in seen.items():
            assert set(flags) == {(False, False)}, route
        assert _tf32() == (True, True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


@pytest.mark.parametrize("mode", ["fast", "parity"])
def test_linear_session_in_fast_mode_matches_jax(mode, tmp_path, rng):
    """A linear session under precision_mode_scope(mode) equals msv_tpu's
    in the same mode on the CPU: planes by f32_agree, rgb images within one
    u8 step, the dB range within atol/rtol."""
    jax_pkg = pytest.importorskip("msv_tpu")
    import msv_tpu_torch
    from msv_tpu.config import precision_mode_scope as jax_scope
    from msv_tpu_torch.io.audio import write_wav

    cs = _chip_smoke()
    paths = []
    for i, sr in enumerate((8000, 16000)):
        t = np.arange(int(1.5 * sr)) / sr
        x = (0.4 * np.sin(2 * np.pi * (300 + 170 * i) * t)
             + 0.02 * rng.standard_normal(len(t))).astype(np.float32)
        paths.append(str(tmp_path / f"f{i}.wav"))
        write_wav(paths[-1], x[None], sr)
    ids = [0, 1]
    with jax_scope(mode):
        ref = jax_pkg.MultiTrack(jax_pkg.SpecSetting(
            freq_scale=jax_pkg.FreqScale.LINEAR))
        ref.add_tracks(ids, paths)
    with msv_tpu_torch.precision_mode_scope(mode):
        port = msv_tpu_torch.MultiTrack(msv_tpu_torch.SpecSetting(
            freq_scale=msv_tpu_torch.FreqScale.LINEAR), device="cpu")
        port.add_tracks(ids, paths)
    for tid in ids:
        got, want = port.get_spec_db(tid), ref.get_spec_db(tid)
        assert got.shape == want.shape
        cs.check_f32(torch.from_numpy(got), torch.from_numpy(np.array(want)),
                     f"linear {mode} track {tid}")
        a = port.get_spec_image(tid, 100.0, 80, wire="rgb").astype(np.int16)
        b = ref.get_spec_image(tid, 100.0, 80, wire="rgb").astype(np.int16)
        assert a.shape == b.shape and np.abs(a - b).max() <= 1
    for g, w in ((port.get_max_db(), ref.get_max_db()),
                 (port.get_min_db(), ref.get_min_db())):
        assert abs(g - w) <= cs.ATOL + cs.RTOL * abs(w)
