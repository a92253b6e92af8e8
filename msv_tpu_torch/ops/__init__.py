"""Host-side constant builders (windows, mel filterbank, DFT matrices,
framing), the dB conversions, and device framing, the STFT and the
adaptive multi-resolution spectrogram as torch ops."""

from .decibel import amp_to_db, power_to_db
from .dft import n_pad_split, windowed_dft_matrices
from .framing import n_frames_for, reflect_pad_center
from .mel import calc_mel_fb_default, hz_to_mel, mel_to_hz
from .multires import multires_mel_spec_db
from .stft import frame_device, inverse_stft, perform_stft, stft_magnitude
from .windows import default_stft_window, hann

__all__ = [
    "amp_to_db",
    "calc_mel_fb_default",
    "default_stft_window",
    "frame_device",
    "hann",
    "hz_to_mel",
    "inverse_stft",
    "mel_to_hz",
    "multires_mel_spec_db",
    "n_frames_for",
    "n_pad_split",
    "perform_stft",
    "power_to_db",
    "reflect_pad_center",
    "stft_magnitude",
    "windowed_dft_matrices",
]
