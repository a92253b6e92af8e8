"""Rendering: dB spec -> normalized grey -> Lanczos3 resize -> colormap;
the waveform's min/max envelope (``envelope``)."""

from .colormap import COLORMAP, WAVECOLOR, grey_to_rgb_planar, paint_grey_wire
from .envelope import EnvelopeState, wav_to_image
from .grey import grey_height, spec_to_grey
from .resize import DENSE_LIMIT, lanczos3_resize, resize_weights

__all__ = [
    "COLORMAP",
    "DENSE_LIMIT",
    "EnvelopeState",
    "WAVECOLOR",
    "grey_height",
    "grey_to_rgb_planar",
    "lanczos3_resize",
    "paint_grey_wire",
    "resize_weights",
    "spec_to_grey",
    "wav_to_image",
]
