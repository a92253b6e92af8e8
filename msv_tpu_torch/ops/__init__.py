"""Host-side constant builders (windows, mel filterbank, DFT matrices,
framing, filter design), the dB conversions, and device framing, the STFT,
the adaptive multi-resolution spectrogram, filtering, Griffin-Lim,
loudness and rhythm as torch ops."""

from .decibel import (a_weighting, amp_to_db, db_to_amp, db_to_power,
                      power_to_db)
from .dft import n_pad_split, windowed_dft_matrices
from .filter import (butter_sos, filtfilt, fir_filter, firwin, high_shelf,
                     low_shelf, notch, peaking_eq, sosfilt, sosfilt_streamed)
from .framing import n_frames_for, reflect_pad_center
from .mel import calc_mel_fb_default, hz_to_mel, mel_to_hz
from .loudness import (integrated_loudness, k_weighting_coeffs,
                       loudness_range, short_term_loudness, true_peak)
from .multires import multires_mel_spec_db
from .reconstruct import griffin_lim, mel_to_linear
from .rhythm import (beat_track, beat_track_from_envelope,
                     tempo_from_tempogram, tempogram_from_envelope)
from .stft import frame_device, inverse_stft, perform_stft, stft_magnitude
from .windows import default_stft_window, hann

__all__ = [
    "a_weighting",
    "amp_to_db",
    "beat_track",
    "beat_track_from_envelope",
    "butter_sos",
    "calc_mel_fb_default",
    "db_to_amp",
    "db_to_power",
    "default_stft_window",
    "filtfilt",
    "fir_filter",
    "firwin",
    "frame_device",
    "griffin_lim",
    "hann",
    "high_shelf",
    "hz_to_mel",
    "integrated_loudness",
    "inverse_stft",
    "k_weighting_coeffs",
    "loudness_range",
    "low_shelf",
    "mel_to_hz",
    "mel_to_linear",
    "multires_mel_spec_db",
    "n_frames_for",
    "n_pad_split",
    "notch",
    "peaking_eq",
    "perform_stft",
    "power_to_db",
    "reflect_pad_center",
    "short_term_loudness",
    "sosfilt",
    "sosfilt_streamed",
    "stft_magnitude",
    "tempo_from_tempogram",
    "tempogram_from_envelope",
    "true_peak",
    "windowed_dft_matrices",
]
