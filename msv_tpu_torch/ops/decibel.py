"""Amplitude to decibels as a torch op (reference: ``src_rust/decibel.rs``,
which follows librosa 0.8), with the exact floor semantics of
decibel.rs:33-56:

    log_ref = log10(ref)  if ref  > amin else log10(amin)
    out     = log10(x) - log_ref  if x > amin else log10(amin) - log_ref
    amp_to_db   = 20 * out,  amin default 1e-18  (decibel.rs:7)
    power_to_db = 10 * out,  amin default 1e-36  (decibel.rs:8)

The branch is the strict ``>`` (not >=), so it is ``torch.where`` on exactly
that predicate.  ``db_to_amp`` and ``db_to_power`` invert them on tensors;
``a_weighting`` is msv_tpu's host builder of the IEC 61672-1 curve, copied.
"""

import math

import torch

REF_DEFAULT = 1.0
AMIN_AMP_DEFAULT = 1e-18
AMIN_POWER_DEFAULT = 1e-36


def _log_for_db(x, ref_value, amin: float):
    if amin < 0:
        raise ValueError("amin must be >= 0 (decibel.rs:34-38)")
    log_amin = math.log10(amin) if amin > 0 else -math.inf
    if ref_value == "max":
        # DeciBelRef::Max (decibel.rs:11-13,41): reference = max of the
        # array, with the same ref > amin fallback rule; stays on device.
        ref = torch.max(x)
        log_ref = torch.where(
            ref > amin, torch.log10(torch.clamp(ref, min=amin)),
            torch.tensor(log_amin, dtype=x.dtype, device=x.device),
        )
    else:
        if not isinstance(ref_value, (int, float)):
            raise ValueError(
                f"ref_value must be a non-negative number or 'max', "
                f"got {ref_value!r}"
            )
        if ref_value < 0:
            raise ValueError("reference must be >= 0 (decibel.rs:34-38)")
        log_ref = math.log10(ref_value) if ref_value > amin else log_amin
    log_amin = torch.tensor(log_amin, dtype=x.dtype, device=x.device)
    return torch.where(x > amin, torch.log10(x) - log_ref, log_amin - log_ref)


def amp_to_db(x, ref_value=REF_DEFAULT, amin: float = AMIN_AMP_DEFAULT):
    """20*log10 with floor (decibel.rs:68-76, defaults decibel.rs:78-88).

    ``ref_value``: a non-negative float, or the string "max" for the
    reference's DeciBelRef::Max variant (reference = array maximum).
    """
    return 20.0 * _log_for_db(x, ref_value, amin)


def power_to_db(x, ref_value=REF_DEFAULT, amin: float = AMIN_POWER_DEFAULT):
    """10*log10 with floor (decibel.rs:58-66, defaults decibel.rs:90-100).
    ``ref_value`` may be "max" (DeciBelRef::Max)."""
    return 10.0 * _log_for_db(x, ref_value, amin)


def db_to_amp(x, ref_value: float = REF_DEFAULT):
    """Inverse of amp_to_db (decibel.rs:102-104; unused by the reference app
    but part of its public trait surface)."""
    return ref_value * torch.pow(10.0, 0.05 * x)


def db_to_power(x, ref_value: float = REF_DEFAULT):
    """Inverse of power_to_db (decibel.rs:106-108)."""
    return ref_value * torch.pow(10.0, 0.1 * x)


def a_weighting(frequencies, min_db: float | None = -80.0):
    """IEC 61672-1 A-weighting in dB for ``frequencies`` (Hz).

    Host-side numpy constant builder (weights are per-bin constants; add
    them to a power-dB spectrogram for perceptual weighting — the
    librosa.A_weighting/perceptual_weighting equivalents; librosa is not
    in this image, so the curve is pinned against the standard's anchor
    values in tests/test_decibel.py: 0 dB at 1 kHz, -19.1 at 100 Hz,
    -2.5 at 10 kHz).  ``min_db`` floors the rolloff (None = no floor).
    """
    import numpy as np

    f2 = np.asarray(frequencies, dtype=np.float64) ** 2
    c1, c2, c3, c4 = 20.6**2, 107.7**2, 737.9**2, 12194.0**2
    ra = (c4 * f2**2) / (
        (f2 + c1) * np.sqrt((f2 + c2) * (f2 + c3)) * (f2 + c4)
    )
    with np.errstate(divide="ignore"):
        db = 20.0 * np.log10(ra) + 2.0
    if min_db is not None:
        db = np.maximum(db, min_db)
    return db.astype(np.float32)
