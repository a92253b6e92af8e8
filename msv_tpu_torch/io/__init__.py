"""Audio decode (host numpy + the native C++ decoder) and the PNG and FLAC
encoders, copied from ``msv_tpu.io``.  ``__all__`` is msv_tpu's list;
``open_audio_mono_ex`` is bound here too."""

from .audio import (open_audio_file, open_audio_file_ex, open_audio_mono_ex,
                    write_wav)
from .png import encode_png, write_png

__all__ = [
    "open_audio_file",
    "open_audio_file_ex",
    "write_wav",
    "encode_png",
    "write_png",
]
