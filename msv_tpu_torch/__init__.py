"""msv_tpu_torch — the multi-track spectrogram viewer on PyTorch and CUDA.

A port of the ``msv_tpu`` package to one NVIDIA H100: decode audio ->
centered STFT -> Slaney mel -> dB through hand-written CUDA kernels
(``kernels/spectrogram_cuda.py``: f32 parity, bf16 fast and split-f32), or
the linear scale as PyTorch ops, streamed in segments for long files, then
globally-normalized grey -> Lanczos3 resize -> colormapped RGB images,
min/max waveform images and adaptive multi-resolution images
(``ops/multires.py``) as PyTorch ops, under a session device-memory budget;
the log-mel ML frontend (``features.py``) on the same kernels, and the rest
of the feature set, filtering, Griffin-Lim, loudness, rhythm, resampling,
pitch, Viterbi and DTW, LPC and formants, tonal features, segmentation,
transcription, the phase vocoder, trimming and alignment as PyTorch ops.
Module paths mirror ``msv_tpu`` so each counterpart is easy to find;
every function takes tensors on an explicit ``device``.
"""

from .config import (FreqScale, SpecSetting, StftParams, derive_stft_params,
                     get_precision_mode, get_session_hbm_budget,
                     precision_mode_scope, set_precision_mode,
                     set_session_hbm_budget)
from .features import (chroma_filterbank, chroma_stft, delta,
                       log_mel_spectrogram, log_mel_spectrogram_ragged, mfcc,
                       onset_detect, onset_strength, pcen, spectral_contrast,
                       spectral_features, whisper_log_mel)
from .ops import (align_offset, beat_track, butter_sos, dtw, estimate_key,
                  filtfilt, firwin, griffin_lim, integrated_loudness,
                  loudness_range, mel_to_linear, pitch_shift, resample,
                  resample_poly, resample_streamed, segment,
                  segment_boundaries, self_similarity, smooth_f0_viterbi,
                  sosfilt, split, tempogram_from_envelope, time_stretch,
                  tonnetz, trim, true_peak, viterbi, yin, yin_smoothed)
from .parallel import streaming_spec_db, streaming_spec_db_mmap
from .render.colormap import get_colormap
from .session import AudioTrack, MultiTrack

__all__ = [
    "align_offset",
    "AudioTrack",
    "beat_track",
    "butter_sos",
    "chroma_filterbank",
    "chroma_stft",
    "delta",
    "derive_stft_params",
    "dtw",
    "estimate_key",
    "filtfilt",
    "firwin",
    "FreqScale",
    "get_colormap",
    "get_precision_mode",
    "get_session_hbm_budget",
    "griffin_lim",
    "integrated_loudness",
    "log_mel_spectrogram",
    "log_mel_spectrogram_ragged",
    "loudness_range",
    "mel_to_linear",
    "mfcc",
    "MultiTrack",
    "onset_detect",
    "onset_strength",
    "pcen",
    "pitch_shift",
    "precision_mode_scope",
    "resample",
    "resample_poly",
    "resample_streamed",
    "segment",
    "segment_boundaries",
    "self_similarity",
    "set_precision_mode",
    "set_session_hbm_budget",
    "smooth_f0_viterbi",
    "sosfilt",
    "SpecSetting",
    "spectral_contrast",
    "spectral_features",
    "split",
    "StftParams",
    "streaming_spec_db",
    "streaming_spec_db_mmap",
    "tempogram_from_envelope",
    "time_stretch",
    "tonnetz",
    "trim",
    "true_peak",
    "viterbi",
    "whisper_log_mel",
    "yin",
    "yin_smoothed",
]
