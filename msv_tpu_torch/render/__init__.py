"""Rendering: dB spec -> normalized grey -> Lanczos3 resize -> colormap;
the waveform's min/max envelope (``envelope``).  ``__all__`` is msv_tpu's
list; the port's own names (``EnvelopeState``, ``grey_to_rgb_planar``,
``paint_grey_wire``, ``grey_height``, ``DENSE_LIMIT``) are bound here too."""

from .colormap import (COLORMAP, WAVECOLOR, get_colormap, grey_to_rgb_array,
                       grey_to_rgb_planar, paint_grey_wire)
from .envelope import EnvelopeState, wav_to_image
from .grey import grey_height, spec_to_grey
from .resize import DENSE_LIMIT, lanczos3_resize, resize_weights

__all__ = [
    "COLORMAP",
    "WAVECOLOR",
    "get_colormap",
    "grey_to_rgb_array",
    "spec_to_grey",
    "lanczos3_resize",
    "resize_weights",
    "wav_to_image",
]
