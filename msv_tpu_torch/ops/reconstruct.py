"""Spectrogram -> audio reconstruction, ported from
``msv_tpu/ops/reconstruct.py``: Griffin-Lim phase recovery and
mel-filterbank inversion.

The whole Griffin-Lim iteration (istft -> stft -> phase projection) runs
as GEMMs and an overlap-add on the device, ``n_iter`` steps of a Python
loop with no host sync inside it.  The overlap-add is
``torch.nn.functional.fold`` (one output sample is the sum of its frames'
contributions, in a fixed order), not ``index_add_``, whose CUDA atomics
sum in a varying order: two identical calls give identical audio.  Every
GEMM is true f32 (``precision_for("parity")``: TF32 off), as msv_tpu's
default-precision dots are on its CPU.

msv_tpu padded the frame count to 128 to bound its compile cache; the pad
frames have zero magnitude and the normalizer comes from the true frames,
so the port runs the exact frame count.

Conventions match :func:`msv_tpu_torch.ops.stft.perform_stft`: centered
frames, reflect padding, any analysis window (defaults to the session's
hann/n_fft); magnitudes produced by the session/export pipeline invert
directly.
"""

import functools

import numpy as np
import torch

from ..config import precision_for
from ..utils.device import as_f32
from .dft import inverse_rdft, n_pad_split, windowed_dft_matrices
from .stft import frame_device
from .windows import default_stft_window



def _ola_constants(n_frames: int, win: int, hop: int, window: np.ndarray):
    """Host-built overlap-add scatter index + COLA normalizer."""
    total = (n_frames - 1) * hop + win
    idx = (
        np.arange(n_frames)[:, None] * hop + np.arange(win)[None, :]
    ).ravel()
    wsq = np.zeros(total, np.float32)
    np.add.at(wsq, idx, np.tile((window * window).astype(np.float32),
                                n_frames))
    return idx.astype(np.int32), np.maximum(wsq, np.float32(1e-24)), total


def _ola_norm(n_frames: int, win: int, hop: int, window: np.ndarray):
    """``_ola_constants``' normalizer, bit for bit, without its scatter
    index (an hour's index is 2.7 GB and ``np.add.at`` over it takes
    seconds).  Away from the first and last window each sample sums the
    same window taps in the same frame order, so its value repeats with
    period ``hop``: a short run of ``2q + 1`` frames (``q`` frames overlap
    a sample) gives the head, one period and the tail."""
    q = -(-win // hop)
    m = 2 * q + 1
    if n_frames <= m:
        return _ola_constants(n_frames, win, hop, window)[1]
    small = _ola_constants(m, win, hop, window)[1]
    mid = np.tile(small[q * hop:(q + 1) * hop], n_frames - q)
    return np.concatenate([small[:q * hop], mid, small[m * hop:]])


def overlap_add(frames, syn, hop: int, wsq):
    """(n_frames, win) synthesis frames, times the window ``syn``,
    overlap-added by ``fold`` (each sample sums its frames in a fixed
    order, never by atomics) and divided by the normalizer ``wsq``."""
    n_frames, win = frames.shape
    total = (n_frames - 1) * hop + win
    sig = torch.nn.functional.fold(
        (frames * syn).T[None], (1, total), (1, win), stride=(1, hop))
    return sig.reshape(total) / wsq


def _griffin_lim_core(mag, c, s, syn, wsq, *, win, hop, n_fft, n_iter,
                      momentum):
    """The iteration on the padded timeline: istft produces the full
    (n_frames-1)*hop + win overlap-added signal and stft re-frames it
    directly — an adjoint-consistent (istft, stft) projection pair with no
    per-iteration slice or re-pad, for any win/hop parity."""
    pl, _ = n_pad_split(n_fft, win)
    n_frames = mag.shape[0]
    mfac = momentum / (1.0 + momentum)

    def istft(re, im):
        return overlap_add(inverse_rdft((re, im), n_fft)[:, pl:pl + win],
                           syn, hop, wsq)

    def stft(x):
        frames = frame_device(x, win, hop, n_frames)
        return frames @ c, frames @ s

    ang_re, ang_im = torch.ones_like(mag), torch.zeros_like(mag)
    reb_re, reb_im = torch.zeros_like(mag), torch.zeros_like(mag)
    for _ in range(n_iter):
        nre, nim = stft(istft(mag * ang_re, mag * ang_im))
        are = nre - mfac * reb_re
        aim = nim - mfac * reb_im
        norm = torch.sqrt(are * are + aim * aim) + 1e-16
        ang_re, ang_im, reb_re, reb_im = are / norm, aim / norm, nre, nim
    return istft(mag * ang_re, mag * ang_im)


def griffin_lim(
    mag,
    win_length: int,
    hop_length: int,
    n_fft: int,
    *,
    n_iter: int = 32,
    momentum: float = 0.99,
    window=None,
    length: int | None = None,
    device=None,
):
    """Reconstruct audio from an STFT magnitude by Griffin-Lim.

    ``mag``: (n_frames, n_fft//2+1) linear magnitude in the
    :func:`perform_stft` convention, numpy (to the card unless ``device``
    says otherwise) or a tensor (on its own device); ``window`` defaults to
    the session's hann/n_fft (pass the unscaled analysis window for
    feature-frontend magnitudes).  Returns host float32 of ``length``
    samples (default ``(n_frames-1)*hop_length``, the centered-STFT
    inverse length).

    The accelerated (momentum) variant: each iteration projects onto the
    consistent-spectrogram set via istft->stft and renormalizes phase,
    with the classic 1983 method at ``momentum=0``.
    """
    mag = as_f32(mag, device)
    if mag.ndim != 2 or mag.shape[1] != n_fft // 2 + 1:
        raise ValueError(
            f"mag must be (n_frames, {n_fft // 2 + 1}), got "
            f"{tuple(mag.shape)}"
        )
    if not (0.0 <= momentum < 1.0):
        raise ValueError(f"momentum must be in [0, 1), got {momentum}")
    n_frames = mag.shape[0]
    if length is None:
        length = (n_frames - 1) * hop_length
    half = win_length // 2
    if length < half + 1:
        raise ValueError(
            f"too few frames to reconstruct: length {length} < "
            f"win_length//2+1 = {half + 1} (need more frames or an "
            "explicit length)"
        )
    if window is None:
        window = default_stft_window(win_length, n_fft)
    window = np.ascontiguousarray(window, dtype=np.float32)
    c, s = windowed_dft_matrices(window, n_fft)
    wsq = _ola_norm(n_frames, win_length, hop_length, window)
    dev = mag.device
    with precision_for("parity"):
        out = _griffin_lim_core(
            mag, torch.from_numpy(c).to(dev), torch.from_numpy(s).to(dev),
            torch.from_numpy(window).to(dev), torch.from_numpy(wsq).to(dev),
            win=win_length, hop=hop_length, n_fft=n_fft,
            n_iter=int(n_iter), momentum=float(momentum),
        )
    return out[half:half + int(length)].cpu().numpy()



@functools.lru_cache(maxsize=16)
def _mel_pinv_cached(fb_key: bytes, shape: tuple) -> np.ndarray:
    fb = np.frombuffer(fb_key, dtype=np.float32).reshape(shape)
    return np.linalg.pinv(fb.astype(np.float64)).astype(np.float32)

def mel_to_linear(mel, fb, *, device=None):
    """Least-squares inversion of the mel projection: given
    ``mel = linspec @ fb`` (fb: (n_freq, n_mel), the calc_mel_fb layout),
    return the minimum-norm non-negative estimate ``clip(mel @ pinv(fb),
    0)`` as a tensor on the device.  The pseudo-inverse is built host-side
    in f64 (cached per fb) and applied as one true-f32 GEMM; feed the
    result to :func:`griffin_lim` to turn mel dB exports back into
    audio."""
    fb = np.ascontiguousarray(fb, dtype=np.float32)
    if fb.ndim != 2:
        raise ValueError(f"fb must be (n_freq, n_mel), got {fb.shape}")
    mel = as_f32(mel, device)
    if mel.shape[-1] != fb.shape[1]:
        raise ValueError(
            f"mel last dim {mel.shape[-1]} != fb n_mel {fb.shape[1]}"
        )
    pinv = torch.from_numpy(_mel_pinv_cached(fb.tobytes(), fb.shape))
    with precision_for("parity"):
        return torch.clamp(mel @ pinv.to(mel.device), min=0.0)
