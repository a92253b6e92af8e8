#!/usr/bin/env python3
"""Readings of the numbers of ``correct`` with a render fault planted in
every spectrogram crop of the program's opens: the upper reading of
``spec_level_err`` in a cell whose control (``calibrate.py --precision
fast``) paints the images as the sound runs do, as on the linear scale,
where a pixel row of the grey averages the TF32 pair's dB errors away.

    python3 portbench/render_fault.py --fault row_shift \
        --workload <cell> --seeds 1,2,3 [--seconds 5]

``row_shift``: each crop one pixel row lower (its top row twice, its last
row gone), as a render one row off paints it; ``unwritten``: each crop
left black.  The other arguments are calibrate.py's, and so is the output,
one JSON line a seed.  The benchmark's own runs never run this.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

FAULTS = {
    "row_shift": lambda img: np.concatenate([img[:1], img[:-1]]),
    "unwritten": np.zeros_like,
}


def plant(fault):
    """Plant ``fault`` in ``MultiTrack.get_spec_image_crop``; returns the
    callable that takes it out again."""
    from msv_tpu_torch.session.multitrack import MultiTrack

    real = MultiTrack.get_spec_image_crop

    def crop(self, *a, **kw):
        return FAULTS[fault](np.asarray(real(self, *a, **kw)))

    MultiTrack.get_spec_image_crop = crop
    return lambda: setattr(MultiTrack, "get_spec_image_crop", real)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    args, rest = ap.parse_known_args(argv)

    from portbench import calibrate

    print(f"render_fault: {args.fault} in every spectrogram crop",
          file=sys.stderr)
    unplant = plant(args.fault)
    try:
        return calibrate.main(rest)
    finally:
        unplant()


if __name__ == "__main__":
    sys.exit(main())
