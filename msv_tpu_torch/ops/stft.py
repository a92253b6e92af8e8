"""Device framing, ported from ``msv_tpu/ops/stft.py::frame_device``.

Only the framing is ported so far; the rest of ``ops/stft.py``
(``perform_stft``, ``inverse_stft``, ``impl="fft"``) waits for the linear
scale (ROADMAP queue 1: linear scale).
"""


def frame_device(padded, win: int, hop: int, n_frames: int):
    """(..., n_frames, win) view of a padded signal over its last axis:
    frame k is ``padded[..., k*hop : k*hop + win]``.  ``unfold`` makes a
    strided view (no gather, no copy); any hop is allowed."""
    return padded[..., : (n_frames - 1) * hop + win].unfold(-1, win, hop)
