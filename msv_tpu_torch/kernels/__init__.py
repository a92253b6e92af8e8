"""Device compute: the fused mel dB spectrogram kernels (CUDA C++, f32
parity, bf16 fast and split-f32, ``spectrogram_cuda``), the linear-scale
spectrogram and the render pipelines as torch ops (``pipeline``)."""

from .pipeline import (render_grey_q, render_rgb, spec_pipeline,
                       spec_pipeline_batched)
from .spectrogram_cuda import (mel_spectrogram_cuda, mel_spectrogram_plain,
                               operands_bf16, operands_split)

__all__ = [
    "mel_spectrogram_cuda",
    "mel_spectrogram_plain",
    "operands_bf16",
    "operands_split",
    "render_grey_q",
    "render_rgb",
    "spec_pipeline",
    "spec_pipeline_batched",
]
