"""Audio decode (host numpy + the native C++ decoder) and the PNG and FLAC
encoders, copied from ``msv_tpu.io``."""

from .audio import open_audio_mono_ex, write_wav
from .png import encode_png, write_png

__all__ = ["encode_png", "open_audio_mono_ex", "write_png", "write_wav"]
