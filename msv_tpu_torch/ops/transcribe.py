"""Monophonic note transcription, ported from ``msv_tpu/ops/transcribe.py``:
audio -> note events -> MIDI.

The event grammar is host numpy over the port's device analyses: YIN
candidates and the Viterbi voicing and contour decodes
(:func:`msv_tpu_torch.ops.sequence.yin_smoothed`) and spectral-flux onsets
(:func:`msv_tpu_torch.features.onset_detect`), all on ``device``.  Voiced
frames group into notes, split on pitch jumps and detected onsets, with a
loudness-derived velocity; ``write_midi`` serializes them as a format-0
Standard MIDI File.  ``transcribe_notes`` (with a ``device``),
``_frame_rms_db``, ``_varlen`` and ``write_midi`` are copies of msv_tpu's,
pinned by tests/test_torch_host.py.
"""

import numpy as np


def _frame_rms_db(wav: np.ndarray, centers: np.ndarray, half: int):
    """RMS dBFS of +-half samples around each center (host; the note
    list is tiny)."""
    out = np.empty(len(centers), np.float32)
    for i, c in enumerate(centers):
        a = max(0, int(c) - half)
        b = min(len(wav), int(c) + half)
        seg = wav[a:b] if b > a else wav[:1] * 0.0
        out[i] = 10.0 * np.log10(max(float((seg * seg).mean()), 1e-12))
    return out


def transcribe_notes(
    wav,
    sr: int,
    *,
    fmin: float = 65.0,
    fmax: float = 2093.0,
    frame_length: int = 2048,
    hop_length: int | None = None,
    min_note_ms: float = 60.0,
    pitch_tol: float = 0.6,
    split_on_onsets: bool = True,
    level_drop_db: float = 40.0, device=None,
):
    """Note events from monophonic audio.

    Returns a list of dicts ``{start, end, midi, hz, velocity}`` —
    start/end in seconds, ``midi`` the nearest integer note number,
    ``hz`` the note's median f0, ``velocity`` 1-127 mapped from the
    note's RMS level.  Segmentation: consecutive Viterbi-voiced frames
    form a note; a new note starts when the frame pitch leaves the
    running note median by more than ``pitch_tol`` semitones, or (with
    ``split_on_onsets``) when a spectral-flux onset falls inside the
    run (re-articulated same-pitch notes).  Notes shorter than
    ``min_note_ms`` are dropped.

    Frames more than ``level_drop_db`` below the loudest frame (floor
    -70 dBFS) are forced unvoiced before segmentation: the YIN window
    (~frame_length/2 each side) keeps reporting periodicity well past
    a note's release, and without the energy gate that decay tail
    becomes a phantom low-velocity note split off by the release
    transient's onset.
    """
    from .sequence import yin_smoothed

    wav = np.asarray(wav, np.float32)
    if wav.ndim != 1:
        raise ValueError(f"wav must be 1-D, got {wav.shape}")
    if hop_length is None:
        hop_length = frame_length // 4
    if min_note_ms < 0:
        raise ValueError(f"min_note_ms must be >= 0, got {min_note_ms}")
    if pitch_tol <= 0:
        raise ValueError(f"pitch_tol must be > 0, got {pitch_tol}")
    f0, voiced = yin_smoothed(wav, sr, fmin=fmin, fmax=fmax,
                              frame_length=frame_length,
                              hop_length=hop_length, device=device)
    if level_drop_db <= 0:
        raise ValueError(
            f"level_drop_db must be > 0, got {level_drop_db}")
    f0 = np.asarray(f0, np.float64)
    voiced = np.asarray(voiced, bool)
    n = len(f0)
    hop_s = hop_length / sr
    all_centers = np.arange(n) * hop_length
    rms_db = _frame_rms_db(wav, all_centers, hop_length // 2)
    voiced &= rms_db > max(float(rms_db.max()) - level_drop_db, -70.0)
    midi = np.where(f0 > 0, 69.0 + 12.0 * np.log2(
        np.maximum(f0, 1e-6) / 440.0), 0.0)

    onsets = np.empty(0)
    if split_on_onsets and len(wav) >= sr // 10:
        from ..features import onset_detect

        try:
            onsets = np.asarray(onset_detect(wav, sr, device=device), float)
        except ValueError:
            onsets = np.empty(0)  # too short for the onset geometry

    # segment voiced runs into notes
    spans = []  # (i0, i1) frame index ranges, i1 exclusive
    i = 0
    while i < n:
        if not voiced[i]:
            i += 1
            continue
        j = i + 1
        med = midi[i]
        while j < n and voiced[j]:
            t_j = j * hop_s
            # an onset splits a run only past a refractory window: the
            # note's own attack is detected a frame or two into the
            # voiced run and must CONFIRM the start, not split it
            cut = abs(midi[j] - med) > pitch_tol or (
                onsets.size
                and ((onsets > t_j - hop_s / 2)
                     & (onsets <= t_j + hop_s / 2)).any()
                and (j - i) * hop_s > max(2 * hop_s, 0.1)
            )
            if cut:
                break
            med = np.median(midi[i:j + 1])
            j += 1
        spans.append((i, j))
        i = j

    # merge a release tail back into its note: a segment contiguous
    # with the previous one at the SAME pitch whose level is fading is
    # the decay the release transient's onset split off — a real
    # re-articulation keeps its level and sustain.  "Fading" = >= 8 dB
    # below the note body, or a short (< 150 ms) remnant that is both
    # quieter (>= 3 dB) and strictly decaying frame-over-frame.
    merged = []
    for i0, i1 in spans:
        if merged:
            p0, p1 = merged[-1]
            same = abs(np.median(midi[i0:i1]) - np.median(midi[p0:p1])
                       ) <= pitch_tol
            lvl = float(np.median(rms_db[i0:i1])
                        - np.median(rms_db[p0:p1]))
            decaying = bool(np.all(np.diff(rms_db[i0:i1]) < 0.0))
            tail = (lvl < -8.0
                    or ((i1 - i0) * hop_s < 0.15 and lvl < -3.0
                        and decaying))
            if p1 == i0 and same and tail:
                merged[-1] = (p0, i1)
                continue
        merged.append((i0, i1))
    spans = merged

    notes = []
    for i0, i1 in spans:
        dur = (i1 - i0) * hop_s
        if dur * 1000.0 < min_note_ms:
            continue
        hz = float(np.median(f0[i0:i1]))
        db = float(np.median(rms_db[i0:i1]))
        # -45 dBFS -> 1, 0 dBFS -> 127
        vel = int(np.clip(round((db + 45.0) / 45.0 * 126.0) + 1, 1, 127))
        notes.append({
            "start": round(i0 * hop_s, 6),
            "end": round(i1 * hop_s, 6),
            "midi": int(np.clip(round(69.0 + 12.0 * np.log2(hz / 440.0)),
                                0, 127)),
            "hz": round(hz, 3),
            "velocity": vel,
        })
    return notes


def _varlen(x: int) -> bytes:
    """SMF variable-length quantity (7 bits per byte, MSB-first)."""
    if x < 0:
        raise ValueError(f"negative delta: {x}")
    out = [x & 0x7F]
    x >>= 7
    while x:
        out.append(0x80 | (x & 0x7F))
        x >>= 7
    return bytes(reversed(out))


def write_midi(path: str, notes, *, tempo_bpm: float = 120.0,
               ppq: int = 480, program: int = 0):
    """Serialize ``transcribe_notes`` output as a format-0 SMF.

    One track: tempo meta, program change, then note-on/off pairs at
    PPQ resolution.  Overlapping notes are fine (events are merged and
    time-sorted).  From-scratch encoder; round-tripped structurally in
    tests/test_transcribe.py.
    """
    if not 1 <= ppq <= 32767:
        raise ValueError(f"ppq must be in [1, 32767], got {ppq}")
    if tempo_bpm <= 0:
        raise ValueError(f"tempo_bpm must be > 0, got {tempo_bpm}")
    if not 0 <= program <= 127:
        raise ValueError(f"program must be in [0, 127], got {program}")
    tick_per_s = ppq * tempo_bpm / 60.0
    evs = []  # (tick, order, status, d1, d2); offs sort before ons
    for nt in notes:
        t0 = int(round(nt["start"] * tick_per_s))
        t1 = max(t0 + 1, int(round(nt["end"] * tick_per_s)))
        m = int(nt["midi"])
        v = int(nt.get("velocity", 96))
        if not (0 <= m <= 127 and 1 <= v <= 127):
            raise ValueError(f"bad note: midi={m} velocity={v}")
        evs.append((t0, 1, 0x90, m, v))
        evs.append((t1, 0, 0x80, m, 0))
    evs.sort()

    tempo_us = int(round(60_000_000 / tempo_bpm))
    track = bytearray()
    track += _varlen(0) + bytes(
        [0xFF, 0x51, 0x03]) + tempo_us.to_bytes(3, "big")
    track += _varlen(0) + bytes([0xC0, program])
    last = 0
    for tick, _, st, d1, d2 in evs:
        track += _varlen(tick - last) + bytes([st, d1, d2])
        last = tick
    track += _varlen(0) + bytes([0xFF, 0x2F, 0x00])  # end of track

    with open(path, "wb") as fh:
        fh.write(b"MThd" + (6).to_bytes(4, "big")
                 + (0).to_bytes(2, "big") + (1).to_bytes(2, "big")
                 + int(ppq).to_bytes(2, "big"))
        fh.write(b"MTrk" + len(track).to_bytes(4, "big") + bytes(track))
