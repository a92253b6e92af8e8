"""The port's render modules against the JAX package on the same dB input:
grey normalization (atol 1e-6), Lanczos3 resize on both sides of
DENSE_LIMIT (atol 1e-5) and the colormap (exact u8 on identical grey)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the JAX reference: absent where the card-only tests run
jnp = pytest.importorskip("jax.numpy")

from msv_tpu.kernels import pipeline as jpipe  # noqa: E402
from msv_tpu.render import colormap as jcmap  # noqa: E402
from msv_tpu.render import grey as jgrey  # noqa: E402
from msv_tpu.render import resize as jresize  # noqa: E402
from msv_tpu_torch.kernels import pipeline as tpipe  # noqa: E402
from msv_tpu_torch.render import colormap as tcmap  # noqa: E402
from msv_tpu_torch.render import grey as tgrey  # noqa: E402
from msv_tpu_torch.render import resize as tresize  # noqa: E402


def _db(rng, n_frames, n_mel):
    return (rng.standard_normal((n_frames, n_mel)) * 25 - 60).astype(np.float32)


@pytest.mark.parametrize("n_freq,up_ratio", [(257, 1.0), (308, 1.2345),
                                             (385, 1.0917)])
def test_grey_height_matches(n_freq, up_ratio):
    assert tgrey.grey_height(n_freq, up_ratio) == jgrey.grey_height(
        n_freq, up_ratio)


@pytest.mark.parametrize("max_db,min_db", [(-3.25, -110.5), (0.0, -120.0),
                                           (-40.0, -40.0)])
def test_spec_to_grey_matches(max_db, min_db, rng):
    db = _db(rng, 300, 64)
    height = 80
    got = tgrey.spec_to_grey(torch.from_numpy(db), max_db, min_db,
                             height=height).numpy()
    ref = np.asarray(jgrey.spec_to_grey(
        jnp.asarray(db), jnp.float32(max_db), jnp.float32(min_db),
        height=height))
    assert got.shape == (height, 300)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    if max_db == min_db:  # degenerate range renders grey 0, not NaN
        assert not got.any()


@pytest.mark.parametrize("n", [500, 2048, 4096 + 37])
def test_blocked_matmul_equals_the_padded_block_form(n, rng):
    """The blocks written straight from b give the bits of a zero-padded,
    contiguous copy of b cut into blocks: the same GEMMs on the same
    operands."""
    a = torch.from_numpy(rng.standard_normal((30, 70)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((70, n)).astype(np.float32))
    block = tpipe.RENDER_BLOCK
    nb = -(-n // block)
    bb = torch.nn.functional.pad(b, (0, nb * block - n))
    bb = bb.reshape(70, nb, block).transpose(0, 1).contiguous()
    want = torch.cat([a @ bb[i] for i in range(nb)], dim=1)[:, :n]
    got = tpipe.blocked_matmul(a, b, block)
    assert got.shape == (30, n) and torch.equal(got, want)


@pytest.mark.parametrize(
    "shape,out_h,out_w",
    [((120, 700), 90, 1500),   # dense: both widths <= DENSE_LIMIT
     ((64, 2600), 40, 1900),   # banded: input width above the limit
     ((64, 1200), 50, 3000)],  # banded: output width above the limit
)
def test_lanczos3_resize_matches(shape, out_h, out_w, rng):
    grey = rng.random(shape, dtype=np.float32)
    got = tresize.lanczos3_resize(torch.from_numpy(grey), out_h, out_w).numpy()
    ref = np.asarray(jresize.lanczos3_resize(jnp.asarray(grey), out_h, out_w))
    assert got.shape == (out_h, out_w)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_lanczos3_resize_logical_size_ignores_padding(rng):
    grey = rng.random((70, 1300), dtype=np.float32)
    grey[:, 1000:] = 1e9  # padding that the weights must never read
    got = tresize.lanczos3_resize(torch.from_numpy(grey), 50, 2500,
                                  in_w=1000).numpy()
    ref = np.asarray(jresize.lanczos3_resize(jnp.asarray(grey), 50, 2500,
                                             in_w=1000))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def test_apply_banded_cols_matches_and_clamps(rng):
    x = rng.random((6, 900), dtype=np.float32)
    left, w = jresize.resize_weights(900, 1300)
    left = left.copy()
    left[-3:] = 898  # windows that run past the last column are clamped
    got = tresize._apply_banded_cols(torch.from_numpy(x),
                                     torch.from_numpy(left),
                                     torch.from_numpy(w), chunk=256).numpy()
    ref = np.asarray(jresize._apply_banded_cols(
        jnp.asarray(x), jnp.asarray(left), jnp.asarray(w), chunk=256))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


def _grey_samples(rng):
    g = rng.random((37, 211), dtype=np.float32)
    edges = np.float32(np.arange(11) / 10.0)  # colormap stop boundaries
    g[0, :11] = edges
    g[1, :11] = np.nextafter(edges, np.float32(0))
    g[2, :3] = [0.0, 1.0, 0.95]
    return g


def test_grey_to_rgb_planar_exact(rng):
    g = _grey_samples(rng)
    got = tcmap.grey_to_rgb_planar(torch.from_numpy(g)).numpy()
    ref = np.asarray(jcmap.grey_to_rgb_planar(jnp.asarray(g)))
    assert got.dtype == np.uint8 and got.shape == (3, 37, 211)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("bits", [8, 16])
def test_paint_grey_wire_exact(bits, rng):
    q = rng.integers(0, 1 << bits, size=(20, 33)).astype(
        np.uint8 if bits == 8 else np.uint16)
    np.testing.assert_array_equal(tcmap.paint_grey_wire(q, bits),
                                  jcmap.paint_grey_wire(q, bits))
    np.testing.assert_array_equal(tcmap._host_lut(bits), jcmap._host_lut(bits))


def _render_inputs(rng, banded):
    n_valid, n_pad, n_mel, height, nheight = 900, 1024, 96, 110, 70
    nwidth = 2300 if banded else 600
    db = _db(rng, n_pad, n_mel)
    wv = jresize.resize_weights_dense(height, nheight)
    if banded:
        left, wb = jresize.resize_weights(n_valid, nwidth)
        return db, wv, (left, wb), height
    wh = np.zeros((nwidth, n_pad), np.float32)
    wh[:, :n_valid] = jresize.resize_weights_dense(n_valid, nwidth)
    return db, wv, wh, height


def _both(x, banded, to):
    return tuple(to(a) for a in x) if banded else to(x)


@pytest.mark.parametrize("banded", [False, True])
@pytest.mark.parametrize("wire", ["rgb", "grey8", "grey16"])
def test_render_pipelines_within_one_step(wire, banded, rng):
    db, wv, wh, height = _render_inputs(rng, banded)
    args_t = (torch.from_numpy(db), -2.0, -118.0, torch.from_numpy(wv),
              _both(wh, banded, torch.from_numpy))
    args_j = (jnp.asarray(db), jnp.float32(-2.0), jnp.float32(-118.0),
              jnp.asarray(wv), _both(wh, banded, jnp.asarray))
    if wire == "rgb":
        got = tpipe.render_rgb(*args_t, height=height, banded=banded).numpy()
        ref = np.asarray(jpipe.render_rgb(*args_j, height=height,
                                          banded=banded))
    else:
        bits = int(wire[4:])
        got = tpipe.render_grey_q(*args_t, height=height, banded=banded,
                                  bits=bits).numpy()
        ref = np.asarray(jpipe.render_grey_q(*args_j, height=height,
                                             banded=banded, bits=bits))
    assert got.shape == ref.shape
    diff = np.abs(got.astype(np.int64) - ref.astype(np.int64))
    assert diff.max() <= 1
