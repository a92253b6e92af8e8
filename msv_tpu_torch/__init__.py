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
transcription, the phase vocoder, trimming, alignment, HPSS, spectral
editing, denoising, NMF separation, de-clicking, the CQT, the multitaper
and reassigned spectrograms and the ``analyze`` report as PyTorch ops.
Module paths mirror ``msv_tpu`` so each counterpart is easy to find;
every function takes tensors on an explicit ``device``.  ``__all__`` is
msv_tpu's list; ``precision_mode_scope`` and the streaming entry points are
bound here too.
"""

from .config import (FreqScale, SpecSetting, StftParams, derive_stft_params,
                     get_precision_mode, get_session_hbm_budget,
                     precision_mode_scope, set_precision_mode,
                     set_session_hbm_budget)
from .features import (analyze, chroma_filterbank, chroma_stft, delta,
                       log_mel_spectrogram, log_mel_spectrogram_ragged, mfcc,
                       onset_detect, onset_strength, pcen, spectral_contrast,
                       spectral_features, whisper_log_mel)
from .ops import (align_offset, beat_track, butter_sos, cqt, cqt_frequencies,
                  declick, denoise, dtw, estimate_key, filtfilt,
                  find_clicks, firwin, griffin_lim, hpss, hpss_masks,
                  integrated_loudness, loudness_range, mel_to_linear,
                  pitch_shift, resample, resample_poly, resample_streamed,
                  segment, segment_boundaries, self_similarity,
                  smooth_f0_viterbi, sosfilt, split, tempogram_from_envelope,
                  time_stretch, tonnetz, trim, true_peak, viterbi, yin,
                  yin_smoothed)
from .parallel import streaming_spec_db, streaming_spec_db_mmap
from .render.colormap import get_colormap
from .session import AudioTrack, MultiTrack

__version__ = "0.3.0"

__all__ = [
    "align_offset",
    "declick",
    "denoise",
    "find_clicks",
    "butter_sos",
    "sosfilt",
    "filtfilt",
    "firwin",
    "analyze",
    "FreqScale",
    "SpecSetting",
    "StftParams",
    "derive_stft_params",
    "get_precision_mode",
    "set_precision_mode",
    "set_session_hbm_budget",
    "get_session_hbm_budget",
    "AudioTrack",
    "MultiTrack",
    "get_colormap",
    "griffin_lim",
    "mel_to_linear",
    "resample",
    "resample_poly",
    "resample_streamed",
    "hpss",
    "hpss_masks",
    "pitch_shift",
    "time_stretch",
    "split",
    "trim",
    "yin",
    "cqt",
    "cqt_frequencies",
    "integrated_loudness",
    "loudness_range",
    "true_peak",
    "beat_track",
    "tempogram_from_envelope",
    "estimate_key",
    "tonnetz",
    "dtw",
    "smooth_f0_viterbi",
    "viterbi",
    "yin_smoothed",
    "segment",
    "segment_boundaries",
    "self_similarity",
    "chroma_filterbank",
    "chroma_stft",
    "delta",
    "onset_detect",
    "onset_strength",
    "log_mel_spectrogram",
    "log_mel_spectrogram_ragged",
    "mfcc",
    "pcen",
    "spectral_contrast",
    "spectral_features",
    "whisper_log_mel",
    "__version__",
]
