"""Host-side constant builders (windows, mel filterbank, DFT matrices,
framing, filter design), the dB conversions, and device framing, the STFT,
the adaptive multi-resolution spectrogram, filtering, Griffin-Lim,
loudness, rhythm, resampling, pitch, Viterbi and DTW, LPC, tonal analysis,
segmentation, transcription, the phase vocoder, alignment, HPSS, spectral
editing, denoising, NMF separation, de-clicking, the CQT, the multitaper
and reassigned spectrograms as torch ops.  ``__all__`` is msv_tpu's list;
the other names bound here are the package's own imports.  ``lpc`` and
``segment`` stay in their modules (``ops.lpc.lpc``,
``ops.segment.segment``): bound here, each would hide its module."""

from .align import AlignResult, align_offset
from .cqt import cqt, cqt_frequencies
from .declick import declick, find_clicks
from .decibel import (a_weighting, amp_to_db, db_to_amp, db_to_power,
                      power_to_db)
from .denoise import denoise, wiener_gain
from .dft import inverse_rdft, n_pad_split, windowed_dft_matrices
from .filter import (butter_sos, filtfilt, fir_filter, firwin, high_shelf,
                     low_shelf, notch, peaking_eq, sosfilt, sosfilt_streamed)
from .effects import pitch_shift, split, time_stretch, trim
from .framing import n_frames_for, reflect_pad_center
from .hpss import hpss, hpss_masks
from .mel import calc_mel_fb, calc_mel_fb_default, hz_to_mel, mel_to_hz
from .loudness import (integrated_loudness, k_weighting_coeffs,
                       loudness_range, short_term_loudness, true_peak)
from .lpc import formant_track, lpc_envelope_db
from .multires import multires_mel_spec_db
from .pitch import yin
from .reconstruct import griffin_lim, mel_to_linear
from .resample import resample, resample_poly, resample_streamed
from .rhythm import (beat_track, beat_track_from_envelope,
                     tempo_from_tempogram, tempogram_from_envelope)
from .segment import novelty_from_ssm, segment_boundaries, self_similarity
from .sequence import (dtw, smooth_f0_viterbi, viterbi, viterbi_log,
                       yin_smoothed)
from .stft import frame_device, inverse_stft, perform_stft, stft_magnitude
from .tonal import (KEY_NAMES, estimate_key, estimate_key_from_chroma,
                    tonnetz, tonnetz_basis, tonnetz_from_chroma)
from .transcribe import transcribe_notes, write_midi
from .windows import (blackman, blackman_harris, cosine_window,
                      default_stft_window, hamming, hann)

__all__ = [
    "align_offset",
    "AlignResult",
    "declick",
    "denoise",
    "find_clicks",
    "wiener_gain",
    "butter_sos",
    "peaking_eq",
    "low_shelf",
    "high_shelf",
    "notch",
    "sosfilt",
    "sosfilt_streamed",
    "filtfilt",
    "firwin",
    "fir_filter",
    "integrated_loudness",
    "loudness_range",
    "short_term_loudness",
    "true_peak",
    "k_weighting_coeffs",
    "beat_track",
    "beat_track_from_envelope",
    "tempo_from_tempogram",
    "tempogram_from_envelope",
    "cqt",
    "cqt_frequencies",
    "yin",
    "hpss",
    "hpss_masks",
    "a_weighting",
    "resample",
    "resample_poly",
    "griffin_lim",
    "mel_to_linear",
    "hann",
    "cosine_window",
    "hamming",
    "blackman",
    "blackman_harris",
    "hz_to_mel",
    "mel_to_hz",
    "calc_mel_fb",
    "calc_mel_fb_default",
    "amp_to_db",
    "power_to_db",
    "db_to_amp",
    "db_to_power",
    "perform_stft",
    "stft_magnitude",
    "inverse_stft",
    "inverse_rdft",
    "windowed_dft_matrices",
    "n_frames_for",
    "reflect_pad_center",
    "multires_mel_spec_db",
]
