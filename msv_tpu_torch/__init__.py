"""msv_tpu_torch — the multi-track spectrogram viewer on PyTorch and CUDA.

A port of the ``msv_tpu`` package to one NVIDIA H100: decode audio ->
centered STFT -> Slaney mel -> dB through hand-written CUDA kernels
(``kernels/spectrogram_cuda.py``: f32 parity, bf16 fast and split-f32), or
the linear scale as PyTorch ops, streamed in segments for long files, then
globally-normalized grey -> Lanczos3 resize -> colormapped RGB images and
min/max waveform images as PyTorch ops; and the log-mel ML frontend
(``features.py``) on the same kernels.  Module paths
mirror ``msv_tpu`` so each counterpart is easy to find; every function
takes tensors on an explicit ``device``.
"""

from .config import (FreqScale, SpecSetting, StftParams, derive_stft_params,
                     precision_mode_scope, set_precision_mode)
from .features import log_mel_spectrogram, log_mel_spectrogram_ragged
from .parallel import streaming_spec_db, streaming_spec_db_mmap
from .session import AudioTrack, MultiTrack

__all__ = [
    "AudioTrack",
    "FreqScale",
    "MultiTrack",
    "SpecSetting",
    "StftParams",
    "derive_stft_params",
    "log_mel_spectrogram",
    "log_mel_spectrogram_ragged",
    "precision_mode_scope",
    "set_precision_mode",
    "streaming_spec_db",
    "streaming_spec_db_mmap",
]
