"""Device compute: the fused mel dB spectrogram kernels (CUDA C++, f32
parity in 3xTF32 and its FFT tier, bf16 fast and split-f32,
``spectrogram_cuda``), the linear scale's route (``LinearRoute``: the FFT
tier's linear form, or the dense pair), and the linear-scale spectrogram
and the render pipelines as torch ops (``pipeline``)."""

from .pipeline import (render_grey_q, render_rgb, spec_pipeline,
                       spec_pipeline_batched)
from .spectrogram_cuda import (LinearOperands, LinearRoute, MelOperands,
                               MelRoute, linear_spectrogram_cuda,
                               mel_spectrogram_cuda, mel_spectrogram_plain,
                               operands_bf16, operands_split,
                               prepare_fft_operands,
                               prepare_linear_fft_operands, prepare_operands,
                               tier_for)

__all__ = [
    "LinearOperands",
    "LinearRoute",
    "MelOperands",
    "MelRoute",
    "linear_spectrogram_cuda",
    "mel_spectrogram_cuda",
    "mel_spectrogram_plain",
    "operands_bf16",
    "operands_split",
    "prepare_fft_operands",
    "prepare_linear_fft_operands",
    "prepare_operands",
    "render_grey_q",
    "render_rgb",
    "spec_pipeline",
    "spec_pipeline_batched",
    "tier_for",
]
