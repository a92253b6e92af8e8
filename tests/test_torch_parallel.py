"""The port's mesh and sharded pipelines (``msv_tpu_torch/parallel/mesh.py``,
``sharded.py``) and the sharded log-mel route, on a mesh of eight ``cpu``
devices, against msv_tpu's on the 8-device CPU mesh of tests/conftest.py.

Tolerances: the sharded, streamed and frequency-sharded dB planes by
tests/test_parallel.py's ``_assert_db_close`` (cap 2.5e-3 dB, p99.9 1e-4,
the amplitude-error curve past ~33 dB depth); the dB max within 1e-4 and
the min (the deepest null) within 0.05 dB, as there; the envelope bit for
bit, including the shape where msv_tpu raises only for its placeholder
columns (ADVICE.md:5) and the port must equal the single-device envelope;
the sharded log-mel batch equal to the unsplit call.  The card test runs
where the card is (``-m gpu``; no JAX there): a (2, 4) mesh over
``cuda:0`` against (1, 1).
"""

import importlib
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from msv_tpu_torch import features as tfeat  # noqa: E402
from msv_tpu_torch.config import SpecSetting, derive_stft_params  # noqa: E402
from msv_tpu_torch.ops.dft import windowed_dft_matrices  # noqa: E402
from msv_tpu_torch.ops.framing import n_frames_for, reflect_pad_center  # noqa: E402
from msv_tpu_torch.ops.mel import calc_mel_fb_default  # noqa: E402
from msv_tpu_torch.ops.windows import default_stft_window  # noqa: E402
from msv_tpu_torch.parallel import (make_mesh, sharded_envelope_minmax,  # noqa: E402
                                    sharded_spec_pipeline,
                                    sharded_streaming_spec_db)
from msv_tpu_torch.parallel.sharded import (ShardedArray,  # noqa: E402
                                            freq_sharded_spec, shard_array)
from msv_tpu_torch.render.envelope import column_windows  # noqa: E402

CPU8 = [torch.device("cpu")] * 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)
MESHES = [(1, 8), (2, 4), (8, 1)]


@pytest.fixture(scope="module")
def jx():
    """msv_tpu's parallel modules and tests/test_parallel.py's dB rule
    (absent on the card's machine)."""
    pytest.importorskip("jax")
    from test_parallel import _assert_db_close

    return (importlib.import_module("msv_tpu.parallel"),
            importlib.import_module("msv_tpu.parallel.sharded"),
            _assert_db_close)


def _setup(sr=16000):
    p = derive_stft_params(sr, SpecSetting())
    c, s = windowed_dft_matrices(default_stft_window(p.win_length, p.n_fft),
                                 p.n_fft)
    return p.win_length, p.hop_length, c, s, calc_mel_fb_default(sr, p.n_fft)


def _padded_batch(rng, B, n_sp, win, hop, L=16000):
    wavs = (rng.standard_normal((B, L)) * 0.3).astype(np.float32)
    n_frames = n_frames_for(L, win, hop)
    padded = np.stack([reflect_pad_center(w, win) for w in wavs])
    need = (n_frames + n_sp) * hop + win
    padded = np.pad(padded, ((0, 0), (0, max(0, need - padded.shape[1]))))
    return padded, n_frames


def _oracle_envelope(wav, n_cols):
    n = len(wav)
    starts, ends = column_windows(np.arange(n_cols, dtype=np.float32),
                                  n_cols, n, n)
    return (np.array([wav[a:b].max() for a, b in zip(starts, ends)]),
            np.array([wav[a:b].min() for a, b in zip(starts, ends)]))


@pytest.mark.parametrize("mod,name", [
    ("mesh", "make_mesh"), ("sharded", "sharded_spec_pipeline"),
    ("sharded", "sharded_streaming_spec_db"), ("sharded", "freq_sharded_spec"),
    ("sharded", "sharded_envelope_minmax"),
    ("multihost", "initialize_distributed"),
    ("multihost", "assign_tracks_by_host"), ("multihost", "make_global_mesh")])
def test_signatures_are_msv_tpu_s(jx, mod, name):
    """msv_tpu's parameters, names and defaults, in order; the port's
    ``make_global_mesh`` adds ``local_devices`` after them."""
    import inspect

    ref = inspect.signature(getattr(importlib.import_module(
        f"msv_tpu.parallel.{mod}"), name)).parameters
    got = inspect.signature(getattr(importlib.import_module(
        f"msv_tpu_torch.parallel.{mod}"), name)).parameters
    assert [(p.name, p.default) for p in list(got.values())[:len(ref)]] == \
        [(p.name, p.default) for p in ref.values()]
    assert list(got)[len(ref):] == (["local_devices"]
                                    if name == "make_global_mesh" else [])


def test_mesh_shape_validation_and_identity(jx):
    jpar = jx[0]
    with pytest.raises(ValueError) as port_err:
        make_mesh(4, 4, CPU8)
    with pytest.raises(ValueError) as jax_err:
        jpar.make_mesh(4, 4)
    assert str(port_err.value) == str(jax_err.value)
    m = make_mesh(2, 4, CPU8)
    assert m.shape == jpar.make_mesh(2, 4).shape == {"dp": 2, "sp": 4}
    assert m.axis_names == ("dp", "sp") and m.devices.shape == (2, 4)
    assert m == make_mesh(2, 4, CPU8) and hash(m) == hash(make_mesh(2, 4,
                                                                      CPU8))
    assert m != make_mesh(1, 8, CPU8)
    assert make_mesh(2, None, CPU8).shape == {"dp": 2, "sp": 4}


@pytest.mark.parametrize("n_dp,n_sp", MESHES)
def test_sharded_pipeline_matches_jax(jx, rng, n_dp, n_sp):
    jpar, _, db_close = jx
    win, hop, c, s, fb = _setup()
    padded, n_frames = _padded_batch(rng, n_dp * 2, n_sp, win, hop)
    db, gmin, gmax, n_total = sharded_spec_pipeline(
        make_mesh(n_dp, n_sp, CPU8), padded, win, hop, c, s, fb, n_frames)
    jdb, jmin, jmax, jn = jpar.sharded_spec_pipeline(
        jpar.make_mesh(n_dp, n_sp), padded, win, hop, c, s, fb, n_frames)
    assert n_total == jn >= n_frames
    assert isinstance(db, ShardedArray) and db.spec == ("dp", "sp", None)
    assert len(db.addressable_shards) == n_dp * n_sp
    whole = db.gather()
    for sh in db.addressable_shards:
        assert torch.equal(whole[sh.index], sh.data)
    db_close(whole.numpy()[:, :n_frames], np.asarray(jdb)[:, :n_frames])
    assert float(gmax) == pytest.approx(float(jmax), abs=1e-4)
    assert float(gmin) == pytest.approx(float(jmin), abs=0.05)


def test_sharded_streaming_matches_jax(jx, rng):
    _, jsh, db_close = jx
    win, hop, c, s, fb = _setup()
    i16 = (rng.standard_normal(16000 * 2) * 8000).astype(np.int16)
    db, n, lo, hi = sharded_streaming_spec_db(
        make_mesh(1, 8, CPU8), i16, win, hop, c, s, fb, chunk_frames=32)
    jdb, jn, jlo, jhi = jsh.sharded_streaming_spec_db(
        jx[0].make_mesh(1, 8), i16, win, hop, c, s, fb, chunk_frames=32)
    assert n == jn and db.shape == np.asarray(jdb).shape
    db_close(db.gather().numpy()[:n], np.asarray(jdb)[:n])
    assert abs(hi - jhi) < 1e-4 and abs(lo - jlo) < 0.05


@pytest.mark.parametrize("use_mel", [True, False])
def test_freq_sharded_matches_jax(jx, rng, use_mel):
    _, jsh, db_close = jx
    win, hop, c, s, fb = _setup()
    fb = fb if use_mel else None
    wav = (rng.standard_normal(16000) * 0.3).astype(np.float32)
    db, n = freq_sharded_spec(make_mesh(1, 8, CPU8), wav, win, hop, c, s, fb)
    jdb, jn = jsh.freq_sharded_spec(jx[0].make_mesh(1, 8), wav, win, hop, c,
                                    s, fb)
    assert n == jn and tuple(db.shape) == np.asarray(jdb).shape
    db_close(db.numpy(), np.asarray(jdb))


@pytest.mark.parametrize("n_dp,n_sp", MESHES)
def test_envelope_bit_equal_to_jax(jx, rng, n_dp, n_sp):
    for n, n_cols in [(48000, 441), (9973, 37), (1_000_000, 16)]:
        wav = (rng.standard_normal(n) * 0.3).astype(np.float32)
        mx, mn = sharded_envelope_minmax(make_mesh(n_dp, n_sp, CPU8), wav,
                                         n_cols)
        jmx, jmn = jx[1].sharded_envelope_minmax(
            jx[0].make_mesh(n_dp, n_sp), wav, n_cols)
        np.testing.assert_array_equal(mx, jmx)
        np.testing.assert_array_equal(mn, jmn)
        omx, omn = _oracle_envelope(wav, n_cols)
        np.testing.assert_array_equal(mx, omx)
        np.testing.assert_array_equal(mn, omn)


def test_envelope_without_placeholder_columns(jx, rng):
    """9 columns over 8 devices: the last three spans hold no column.
    msv_tpu's placeholder columns there widen its halo past the span and
    it raises (ADVICE.md:5); the port equals the single-device envelope."""
    wav = (rng.standard_normal(9000) * 0.3).astype(np.float32)
    with pytest.raises(ValueError, match="shards too small"):
        jx[1].sharded_envelope_minmax(jx[0].make_mesh(1, 8), wav, 9)
    mx, mn = sharded_envelope_minmax(make_mesh(1, 8, CPU8), wav, 9)
    omx, omn = _oracle_envelope(wav, 9)
    np.testing.assert_array_equal(mx, omx)
    np.testing.assert_array_equal(mn, omn)


def test_envelope_validation():
    mesh = make_mesh(1, 8, CPU8)
    with pytest.raises(ValueError):
        sharded_envelope_minmax(mesh, np.zeros(100, np.float32), 200)
    with pytest.raises(ValueError, match="shards too small"):
        # a real column's window (1.5 * spp = 48 samples) reaches past its
        # neighbour's 32-sample span: no halo can cover it
        sharded_envelope_minmax(mesh, np.zeros(64, np.float32), 2)


def test_shard_array_indices_and_gather(rng):
    x = torch.from_numpy(rng.standard_normal((4, 8, 8)).astype(np.float32))
    mesh = make_mesh(2, 4, CPU8)
    for spec, n in [(("dp", "sp"), 8), (("dp",), 2), ((None, None, "sp"), 4),
                    ((("dp", "sp"),), None)]:
        if n is None:
            with pytest.raises(ValueError, match="does not split"):
                shard_array(x, mesh, spec)
            continue
        a = shard_array(x, mesh, spec)
        assert len(a.shards) == n and a.shape == tuple(x.shape)
        for sh in a.shards:
            assert torch.equal(sh.data, x[sh.index])
        assert torch.equal(a.gather(), x)


def _counting(monkeypatch):
    calls = []
    real = tfeat.mel_spectrogram_cuda

    def wrapper(padded, *a, **kw):
        calls.append(tuple(padded.shape))
        return real(padded, *a, **kw)

    monkeypatch.setattr(tfeat, "mel_spectrogram_cuda", wrapper)
    return calls


def test_log_mel_dp_split_runs_per_shard(jx, rng, monkeypatch):
    """A dp-split batch: one launch per shard, the split kept, equal to the
    unsplit call; msv_tpu's shard_map route (here its XLA core on the CPU
    mesh) by chip_smoke's f32_agree."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from msv_tpu import log_mel_spectrogram as jlog_mel

    x = (rng.standard_normal((8, 4000)) * 0.3).astype(np.float32)
    calls = _counting(monkeypatch)
    whole = tfeat.log_mel_spectrogram(x, 16000, n_mel=40,
                                      precision="parity", device="cpu")
    calls.clear()
    sharded = tfeat.log_mel_spectrogram(
        shard_array(x, make_mesh(2, 4, CPU8), ("dp", None)), 16000,
        n_mel=40, precision="parity")
    assert len(calls) == 2 and all(shape[0] == 4 for shape in calls)
    assert isinstance(sharded, ShardedArray)
    assert sharded.spec == ("dp", None, None)
    assert [sh.index[0] for sh in sharded.shards] == [slice(0, 4),
                                                      slice(4, 8)]
    assert torch.equal(sharded.gather(), whole)
    jmesh = jx[0].make_mesh(2, 4)
    jx_sharded = __import__("jax").device_put(
        x, NamedSharding(jmesh, P("dp", None)))
    want = np.array(jlog_mel(jx_sharded, 16000, n_mel=40,
                               precision="parity"))
    agree, _ = cs.f32_agree(whole, torch.from_numpy(want))
    assert bool(agree.all())


def test_log_mel_other_split_takes_the_core(rng, monkeypatch):
    """A time-split batch is gathered and runs the torch-op core (no
    launch), as msv_tpu's partitioned XLA route."""
    x = (rng.standard_normal((4, 4000)) * 0.3).astype(np.float32)
    calls = _counting(monkeypatch)
    got = tfeat.log_mel_spectrogram(
        shard_array(x, make_mesh(2, 4, CPU8), ("dp", "sp")), 16000,
        n_mel=40, precision="parity")
    assert calls == [] and isinstance(got, torch.Tensor)
    want = tfeat.log_mel_spectrogram(x, 16000, n_mel=40, precision="parity",
                                     device="cpu")
    agree, _ = cs.f32_agree(got, want)
    assert bool(agree.all())


@pytest.mark.gpu
def test_card_mesh_matches_one_device():
    """A (2, 4) mesh listing cuda:0 eight times against (1, 1): the same
    values (per-shard GEMMs of other shapes: by chip_smoke's f32_agree),
    the same range, and the envelope bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    win, hop, c, s, fb = _setup(48000)
    padded, n_frames = _padded_batch(rng, 4, 4, win, hop, L=48000 * 4)
    card8 = [torch.device("cuda", 0)] * 8
    one = sharded_spec_pipeline(make_mesh(1, 1, card8), padded, win, hop, c,
                                s, fb, n_frames)
    many = sharded_spec_pipeline(make_mesh(2, 4, card8), padded, win, hop, c,
                                 s, fb, n_frames)
    a = one[0].gather()[:, :n_frames]
    b = many[0].gather()[:, :n_frames]
    assert b.device.type == "cuda" and a.shape == b.shape
    cs.check_f32(b, a, "(2, 4) mesh against (1, 1)")
    assert abs(float(one[2]) - float(many[2])) <= 1e-4
    wav = (rng.standard_normal(480000) * 0.3).astype(np.float32)
    for got, want in zip(sharded_envelope_minmax(make_mesh(2, 4, card8),
                                                 wav, 1200),
                         _oracle_envelope(wav, 1200)):
        np.testing.assert_array_equal(got, want)
