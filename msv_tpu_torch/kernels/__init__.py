"""Device compute: the fused mel dB spectrogram kernels (CUDA C++, f32
parity and bf16 fast, ``spectrogram_cuda``) and the render pipelines as
torch ops (``pipeline``)."""

from .pipeline import render_grey_q, render_rgb
from .spectrogram_cuda import (mel_spectrogram_cuda, mel_spectrogram_plain,
                               operands_bf16)

__all__ = [
    "mel_spectrogram_cuda",
    "mel_spectrogram_plain",
    "operands_bf16",
    "render_grey_q",
    "render_rgb",
]
