"""Spectrogram and render pipelines as torch ops, ported from
``msv_tpu/kernels/pipeline.py``.

``spec_pipeline`` / ``spec_pipeline_batched`` (the linear route's "gemm"
tier, ``kernels/spectrogram_cuda.py::LinearRoute``; ``use_mel=True`` is kept
for tests):

    frames (a strided view) -> windowed-DFT GEMM pair -> magnitude
    -> [mel GEMM] -> amp_to_db (log10) -> masked min/max

``render_rgb`` / ``render_grey_q``:

    normalize+flip+pad -> vertical Lanczos GEMM -> clamp
    -> horizontal Lanczos GEMM or banded gather -> clamp
    -> colormap (rgb) or quantized grey (grey8/grey16)

The spectrogram GEMMs run under ``precision_for(mode)``: true f32 (TF32
off) in parity, TF32 in fast, as msv_tpu's take the mode's matmul
precision.  The render GEMMs run under ``precision_for("parity")`` in every
mode (msv_tpu renders at HIGHEST in every mode).  Either scope gives the
caller's flags back after the call.  The vertical resize GEMM runs
over fixed ``RENDER_BLOCK``-column blocks, so a frame's column meets one
cuBLAS kernel whatever the plane's width: a render of a slice-local plane
then equals the same columns of a wider plane bit for bit (adaptive crops
stitch).  The session's mel route does not come here: it runs the fused
kernels of ``kernels/spectrogram_cuda.py``.
"""

import torch

from ..config import precision_for
from ..ops.decibel import amp_to_db
from ..ops.stft import dft_magnitude
from ..render.colormap import grey_to_rgb_planar
from ..render.grey import spec_to_grey
from ..render.resize import _apply_banded_cols
from ..utils.debug import check_nan

# Column block of the vertical resize GEMM (see the module docstring).
RENDER_BLOCK = 2048


def spec_pipeline(padded, c, s, mel_fb, n_valid, *, win, hop, n_frames,
                  use_mel, mode=None, scale=2.0**-15):
    """padded wav (..., L) -> (spec_db (..., n_frames, n_out), spec_min,
    spec_max), min/max per leading row.

    ``n_frames`` is the bucketed frame count; ``n_valid`` the true one (an
    int, or a tensor of one per row).  Rows >= n_valid come from zero
    padding and are left out of the min/max.  ``mode`` must be given, as in
    msv_tpu: parity computes true f32 (TF32 off), fast TF32.  ``scale`` is the
    exact f32 value of one integer-carrier unit when ``padded`` is
    int16/int32; ignored for f32 input.  ``mel_fb`` is read only when
    ``use_mel``.

    Equivalent of MultiTrack::calc_spec_of (lib.rs:112-136) + the per-spec
    part of the global dB reduce (lib.rs:194-207).
    """
    if mode is None:
        raise ValueError(
            "spec_pipeline requires an explicit precision mode "
            "(pass mode=get_precision_mode())")
    if mode not in ("parity", "fast"):
        raise ValueError(f"unknown precision mode: {mode!r}")
    if padded.dtype in (torch.int16, torch.int32):
        # integer carrier: exact power-of-two scale on the device
        padded = padded.to(torch.float32) * scale
    with precision_for(mode):
        spec = dft_magnitude(padded, c, s, win=win, hop=hop,
                             n_frames=n_frames)
        if use_mel:
            spec = spec @ mel_fb
    db = amp_to_db(spec)
    smin, smax = masked_minmax(db, n_valid)
    return db, smin, smax


def masked_minmax(db, n_valid):
    """(smin, smax) of dB planes (..., n_frames, n_out) over their first
    ``n_valid`` frames (an int, or a tensor of one per leading row): the
    rows of a bucket's zero padding are left out."""
    n_valid = torch.as_tensor(n_valid, device=db.device)
    frame = torch.arange(db.shape[-2], device=db.device)
    fmask = (frame < n_valid[..., None])[..., None]
    smax = torch.where(fmask, db, -torch.inf).amax(dim=(-2, -1))
    smin = torch.where(fmask, db, torch.inf).amin(dim=(-2, -1))
    return smin, smax


def spec_pipeline_batched(padded_b, c, s, mel_fb, n_valid, *, win, hop,
                          n_frames, use_mel, mode=None, scale=2.0**-15):
    """:func:`spec_pipeline` over a leading batch of same-bucket tracks
    (B, L), in one pass of batched GEMMs.  ``scale`` is shared by the batch
    (the session groups tracks by carrier).  Returns (db (B, n_frames,
    n_out), smin (B,), smax (B,))."""
    if mode is None:
        raise ValueError("spec_pipeline_batched requires an explicit mode")
    if padded_b.ndim != 2:
        raise ValueError("padded_b must be (B, L)")
    return spec_pipeline(padded_b, c, s, mel_fb, n_valid, win=win, hop=hop,
                         n_frames=n_frames, use_mel=use_mel, mode=mode,
                         scale=scale)


def blocked_matmul(a, b, block):
    """``a @ b`` for a (M, K) and b (K, N), over fixed ``block``-column
    blocks of b (the last zero-padded to the block): every block is one GEMM
    of one shape and one contiguous layout, so a column's result does not
    depend on N."""
    k, n = b.shape
    nb, full = -(-n // block), n // block
    # the blocks written straight from b: a padded copy beside them would
    # hold a third b-sized buffer (a tall grey's is 1.5 GB)
    bb = b.new_empty((nb, k, block))
    bb[:full].copy_(b[:, : full * block].reshape(k, full, block)
                    .transpose(0, 1))
    if full < nb:
        bb[full, :, : n - full * block].copy_(b[:, full * block :])
        bb[full, :, n - full * block :].zero_()
    out = a.new_empty((nb, a.shape[0], block))
    for i in range(nb):
        torch.matmul(a, bb[i], out=out[i])
    return out.transpose(0, 1).reshape(a.shape[0], nb * block)[:, :n]


def _resized_grey(spec_db, max_db, min_db, wv, wh_or_weights, *, height,
                  banded):
    grey = spec_to_grey(spec_db, max_db, min_db, height=height)  # (H, W)
    with precision_for("parity"):
        x = torch.clamp(blocked_matmul(wv, grey, RENDER_BLOCK), 0.0, 1.0)
        if banded:
            left, wb = wh_or_weights
            y = _apply_banded_cols(x, left, wb)
        else:
            y = x @ wh_or_weights.T
    y = torch.clamp(y, 0.0, 1.0)
    check_nan(y, "the spectrogram render")
    return y


def render_rgb(spec_db, max_db, min_db, wv, wh_or_weights, *, height, banded):
    """dB spec -> channel-planar (3, out_h, out_w) u8 RGB.

    wv: dense vertical weights (out_h, height).
    wh_or_weights: dense horizontal weights (out_w, W) when banded=False,
    else a (left (out_w,), w (out_w, M)) pair.
    """
    return grey_to_rgb_planar(_resized_grey(
        spec_db, max_db, min_db, wv, wh_or_weights, height=height,
        banded=banded))


def render_grey_q(spec_db, max_db, min_db, wv, wh_or_weights, *, height,
                  banded, bits):
    """Same resize as :func:`render_rgb`, but the output is the resized grey
    quantized to ``bits`` (8 or 16), round-half-away via floor(x + 0.5) on
    [0, 1] grey; the host paints it with ``colormap.paint_grey_wire``.
    Returns uint8 for 8 bits, int32 holding the u16 levels for 16."""
    y = _resized_grey(spec_db, max_db, min_db, wv, wh_or_weights,
                      height=height, banded=banded)
    scale = torch.tensor(float((1 << bits) - 1), dtype=torch.float32,
                         device=y.device)
    q = torch.floor(y * scale + 0.5)
    return q.to(torch.uint8 if bits == 8 else torch.int32)
