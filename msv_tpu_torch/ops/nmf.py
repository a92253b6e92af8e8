"""NMF spectrogram decomposition and source separation, ported from
``msv_tpu/ops/nmf.py``.

Lee-Seung multiplicative updates for the KL divergence, four true-f32
GEMMs an iteration (``precision_for("parity")``), as a Python loop of
torch ops with no host sync inside it (msv_tpu's ``fori_loop``).  The
masked resynthesis is the STFT round trip of ``ops/hpss.py`` (a ``fold``
overlap-add, msv_tpu's 128-frame bucket).

Update rule (Lee & Seung 2001, KL):
  H <- H * (W^T (V / (W H))) / (W^T 1)
  W <- W * ((V / (W H)) H^T) / (1 H^T)
which never leaves the nonnegative orthant and monotonically decreases
  D_KL(V || WH) = sum V log(V / WH) - V + WH.

``separate`` keeps msv_tpu's bucket because it changes the result: the
initial activations are drawn for ``round_up_to(n_frames, 128)`` columns
(the same numpy stream), and the pad columns' activations enter the
templates' update through ``1 H^T``.  ``kl_divergence`` is a copy of
msv_tpu's host f64 code, pinned by tests/test_torch_host.py.
"""

import numpy as np
import torch

from ..config import precision_for
from ..utils.device import as_f32, host_f32, target_device
from .framing import n_frames_for
from .hpss import _masked_istft, _roundtrip, _spectrum

_EPS = 1e-12


def _nmf_core(v, w, h, *, n_iter):
    eps = float(np.float32(_EPS))
    ones_f = torch.ones((v.shape[0], 1), dtype=v.dtype, device=v.device)
    ones_t = torch.ones((1, v.shape[1]), dtype=v.dtype, device=v.device)
    for _ in range(n_iter):
        r = v / (w @ h + eps)
        h = h * (w.T @ r) / ((w.T @ ones_f) @ ones_t + eps)
        r = v / (w @ h + eps)
        w = w * (r @ h.T) / (ones_f @ (ones_t @ h.T) + eps)
    return w, h


def kl_divergence(v, w, h):
    """D_KL(V || WH) with the 0*log0 = 0 convention (host, f64)."""
    v = np.asarray(v, np.float64)
    wh = np.asarray(w, np.float64) @ np.asarray(h, np.float64) + _EPS
    lg = np.where(v > 0, np.log(np.maximum(v, _EPS) / wh), 0.0)
    return float((v * lg - v + wh).sum())


def nmf(v, n_components: int, *, n_iter: int = 200, seed: int = 0,
        device=None):
    """Factor a nonnegative (F, T) matrix: returns host (W (F, K), H (K, T)).

    Deterministic mean-scaled uniform init from ``seed``; ``n_iter``
    KL multiplicative updates on ``device`` (numpy input goes to the card
    unless ``device`` says otherwise; a tensor's own device).  Columns of
    W are the learned spectral templates, rows of H their time
    activations.
    """
    dev = target_device(v, device)
    v = host_f32(v)
    if v.ndim != 2:
        raise ValueError(f"v must be 2-D (n_freq, n_frames), got {v.shape}")
    if v.size == 0:
        raise ValueError(f"v is empty: {v.shape}")
    if (v < 0).any():
        raise ValueError("v must be nonnegative")
    k = int(n_components)
    if not 1 <= k <= min(v.shape):
        raise ValueError(
            f"n_components must be in [1, min(F, T)={min(v.shape)}], "
            f"got {n_components}"
        )
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    rng = np.random.default_rng(seed)
    scale = np.sqrt(max(v.mean(), _EPS) / k)
    w0 = (scale * (0.1 + rng.random((v.shape[0], k)))).astype(np.float32)
    h0 = (scale * (0.1 + rng.random((k, v.shape[1])))).astype(np.float32)
    with precision_for("parity"):
        w, h = _nmf_core(*(as_f32(a, dev) for a in (v, w0, h0)),
                         n_iter=int(n_iter))
    return w.cpu().numpy(), h.cpu().numpy()


def separate(
    wav,
    win_length: int,
    hop_length: int,
    n_fft: int,
    *,
    n_components: int = 4,
    n_iter: int = 200,
    seed: int = 0,
    window=None,
    device=None,
):
    """Split ``wav`` into ``n_components`` source estimates, computed on
    ``device`` (numpy input goes to the card unless ``device`` says
    otherwise; a tensor's own device).

    Returns host ``(parts, w, h)``: parts (K, len(wav)) float32 whose sum
    reconstructs the input to OLA rounding (the Wiener masks sum to 1
    pointwise), W (n_freq, K) spectral templates, H (K, n_frames)
    activations.  STFT conventions match :func:`perform_stft`
    (centered, reflect pad; ``window`` defaults to the session's
    hann/n_fft — its scale cancels through the masked roundtrip).
    """
    dev = target_device(wav, device)
    wav = host_f32(wav)
    if wav.ndim != 1:
        raise ValueError(f"wav must be 1-D, got {wav.shape}")
    half = win_length // 2
    if len(wav) < half + 1:
        raise ValueError(
            f"signal too short for win_length={win_length}: need at "
            f"least {half + 1} samples, got {len(wav)}"
        )
    if n_iter < 1:
        raise ValueError(f"n_iter must be >= 1, got {n_iter}")
    n_freq = n_fft // 2 + 1
    n_frames = n_frames_for(len(wav), win_length, hop_length)
    k = int(n_components)
    if not 1 <= k <= min(n_freq, n_frames):
        raise ValueError(
            f"n_components must be in [1, min(n_freq={n_freq}, "
            f"n_frames={n_frames})], got {n_components}"
        )
    padded, c, s, syn, wsq, _, n_pad = _roundtrip(
        wav, win_length, hop_length, n_fft, window, dev)
    rng = np.random.default_rng(seed)
    # scale-free init (actual mag scale multiplies in within a few
    # iterations; 0.1 floor keeps no entry at a multiplicative zero)
    w0 = (0.1 + rng.random((n_freq, k))).astype(np.float32)
    h0 = (0.1 + rng.random((k, n_pad))).astype(np.float32)
    geo = {"win": win_length, "hop": hop_length}
    with precision_for("parity"):
        re, im = _spectrum(padded, c, s, n_frames=n_frames, n_pad=n_pad,
                           **geo)
        w, h = _nmf_core(torch.sqrt(re * re + im * im).T,
                         as_f32(w0, dev), as_f32(h0, dev), n_iter=int(n_iter))
        wh = w @ h + float(np.float32(_EPS))
        parts = torch.stack([
            _masked_istft(re, im, (w[:, kk:kk + 1] * h[kk:kk + 1, :] / wh).T,
                          syn, wsq, n_fft=n_fft, **geo)
            for kk in range(k)])
    return (parts[:, half:half + len(wav)].cpu().numpy(), w.cpu().numpy(),
            h[:, :n_frames].cpu().numpy())
