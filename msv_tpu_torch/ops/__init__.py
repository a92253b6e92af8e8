"""Host-side constant builders (windows, mel filterbank, DFT matrices,
framing, filter design), the dB conversions, and device framing, the STFT,
the adaptive multi-resolution spectrogram, filtering, Griffin-Lim,
loudness, rhythm, resampling, pitch, Viterbi and DTW, LPC, tonal analysis,
segmentation, transcription, the phase vocoder and alignment as torch
ops.  ``lpc`` and ``segment`` stay in their modules (``ops.lpc.lpc``,
``ops.segment.segment``): bound here, each would hide its module."""

from .align import AlignResult, align_offset
from .decibel import (a_weighting, amp_to_db, db_to_amp, db_to_power,
                      power_to_db)
from .dft import n_pad_split, windowed_dft_matrices
from .filter import (butter_sos, filtfilt, fir_filter, firwin, high_shelf,
                     low_shelf, notch, peaking_eq, sosfilt, sosfilt_streamed)
from .effects import pitch_shift, split, time_stretch, trim
from .framing import n_frames_for, reflect_pad_center
from .mel import calc_mel_fb_default, hz_to_mel, mel_to_hz
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
from .windows import default_stft_window, hann

__all__ = [
    "a_weighting",
    "align_offset",
    "AlignResult",
    "amp_to_db",
    "beat_track",
    "beat_track_from_envelope",
    "butter_sos",
    "calc_mel_fb_default",
    "db_to_amp",
    "db_to_power",
    "default_stft_window",
    "dtw",
    "estimate_key",
    "estimate_key_from_chroma",
    "filtfilt",
    "fir_filter",
    "firwin",
    "formant_track",
    "frame_device",
    "griffin_lim",
    "hann",
    "high_shelf",
    "hz_to_mel",
    "integrated_loudness",
    "inverse_stft",
    "k_weighting_coeffs",
    "KEY_NAMES",
    "loudness_range",
    "low_shelf",
    "lpc_envelope_db",
    "mel_to_hz",
    "mel_to_linear",
    "multires_mel_spec_db",
    "n_frames_for",
    "n_pad_split",
    "notch",
    "novelty_from_ssm",
    "peaking_eq",
    "perform_stft",
    "pitch_shift",
    "power_to_db",
    "reflect_pad_center",
    "resample",
    "resample_poly",
    "resample_streamed",
    "segment_boundaries",
    "self_similarity",
    "short_term_loudness",
    "smooth_f0_viterbi",
    "sosfilt",
    "sosfilt_streamed",
    "split",
    "stft_magnitude",
    "tempo_from_tempogram",
    "tempogram_from_envelope",
    "time_stretch",
    "tonnetz",
    "tonnetz_basis",
    "tonnetz_from_chroma",
    "transcribe_notes",
    "trim",
    "true_peak",
    "viterbi",
    "viterbi_log",
    "windowed_dft_matrices",
    "write_midi",
    "yin",
    "yin_smoothed",
]
