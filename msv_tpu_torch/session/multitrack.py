"""MultiTrack session on PyTorch, ported from ``msv_tpu/session/multitrack.py``
(reference: ``MultiTrack``, lib.rs:72-365; ``AudioTrack``, lib.rs:30-62).

Host Python owns file I/O and the global-dB state machine; the device owns
every per-sample computation.  On the mel scale every track's spectrogram
goes through the fused CUDA kernel of the session's precision mode
(``kernels/spectrogram_cuda.py``: the f32 kernel under "parity", the bf16
kernel under "fast"); on the linear scale through ``spec_pipeline_batched``
(torch ops, f32).  Tracks that share a bucket ``(sr, n_frames_pad, wire)``
go as one batched call, and a track over STREAMING_FRAME_THRESHOLD frames
goes alone through segmented streaming (``parallel/streaming.py``), whose
device wave the track keeps for its waveform images.  Renders are torch ops
over the cached device dB planes and device waves
(``render/envelope.py`` for the waveform).

Behavioural contracts kept from msv_tpu:
  * dB window: max_db = min(global_max, 0), min_db = max(global_min,
    max_db - db_range), 1e-3 change hysteresis (lib.rs:193-218).
  * Padded frames (rows >= n_frames) are left out of the per-track min/max.
  * up_ratio frequency alignment: mel(max_sr/2)/mel(sr/2), or max_sr/sr on
    the linear scale (lib.rs:231-248, f32).
  * channel sum (not mean) to mono (lib.rs:42); window = hann/n_fft.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item, or is absent): packed dB wires, adaptive renders and the
device-memory budget.
"""

import functools
import json
import os
import threading

import numpy as np
import torch

from ..config import (FreqScale, SpecSetting, derive_stft_params,
                      get_image_wire, get_precision_mode)
from ..kernels.pipeline import (render_grey_q, render_rgb,
                                spec_pipeline_batched)
from ..kernels.spectrogram_cuda import (mel_spectrogram_cuda, operands_bf16,
                                        operands_from_numpy)
from ..parallel.streaming import streaming_spec_db
from ..ops.dft import windowed_dft_matrices
from ..ops.framing import n_frames_for, reflect_pad_center
from ..ops.mel import calc_mel_fb_default, hz_to_mel, mel_to_hz
from ..ops.windows import default_stft_window
from ..render.colormap import paint_grey_wire
from ..render.envelope import EnvelopeState, wav_to_image
from ..render.grey import grey_height, spec_to_grey
from ..render.resize import (
    DENSE_LIMIT,
    resize_weights,
    resize_weights_dense,
    resize_weights_range,
)
from ..utils import round_up_to
from ..utils.errors import TrackNotFoundError
from ..utils.profiling import StageTimer, get_logger
from ..utils.rounding import trunc_int

FRAME_BUCKET = 256
# Tracks longer than this many frames go one at a time through segmented
# streaming (parallel/streaming.py), as in msv_tpu.
STREAMING_FRAME_THRESHOLD = 32768
# Render-size guards (docs/PARITY.md): bound the host-side weight arrays
# and the output image.
MAX_RENDER_COLS = 1 << 22
MAX_RENDER_ROWS = 1 << 16
MAX_RENDER_AREA = 1 << 28


def _frame_counts(track):
    """(n_frames, n_frames_pad): the track's centered-STFT frame count and
    the FRAME_BUCKET multiple its launch computes."""
    n_frames = n_frames_for(track.n_samples, track.win_length,
                            track.hop_length)
    return n_frames, round_up_to(max(n_frames, 1), FRAME_BUCKET)


def _crop_cols(track, px_per_sec: float, start_sec: float, end_sec: float):
    """Full logical width (the reference's `as u32` trunc, lib.rs:296) and
    the clamped [c0, c1) column window for [start_sec, end_sec), in f32 so
    a crop is pixel-aligned with slicing the full-width image."""
    f32 = np.float32
    full_w = trunc_int(f32(px_per_sec) * f32(track.n_samples) / f32(track.sr))
    c0 = max(0, trunc_int(f32(px_per_sec) * f32(start_sec)))
    c1 = min(full_w, trunc_int(f32(px_per_sec) * f32(end_sec)))
    return full_w, c0, c1


def _check_render_dims(ncols: int, nheight: int, what: str) -> None:
    if ncols > MAX_RENDER_COLS:
        raise ValueError(
            f"{what}: {ncols} output columns exceeds MAX_RENDER_COLS "
            f"({MAX_RENDER_COLS}); render a viewport via the *_crop APIs"
        )
    if nheight > MAX_RENDER_ROWS:
        raise ValueError(
            f"{what}: height {nheight} exceeds MAX_RENDER_ROWS "
            f"({MAX_RENDER_ROWS})"
        )
    if ncols * nheight > MAX_RENDER_AREA:
        raise ValueError(
            f"{what}: {ncols}x{nheight} = {ncols * nheight} output pixels "
            f"exceeds MAX_RENDER_AREA ({MAX_RENDER_AREA}, ~1 GiB RGBA); "
            f"render a viewport via the *_crop APIs or reduce px_per_sec"
        )


@functools.lru_cache(maxsize=128)
def _dev_vertical_weights(height: int, nheight: int, device: torch.device):
    return torch.from_numpy(resize_weights_dense(height, nheight)).to(device)


@functools.lru_cache(maxsize=128)
def _dev_horizontal_weights(w_valid: int, nwidth: int, w_total: int,
                            device: torch.device):
    """(banded?, weights) over a dB plane of w_total columns of which
    w_valid are frames: banded (left, w) for wide images, a dense
    (nwidth, w_total) matrix below DENSE_LIMIT."""
    if not (w_valid <= DENSE_LIMIT and nwidth <= DENSE_LIMIT):
        left, wb = resize_weights(w_valid, nwidth)
        return True, (torch.from_numpy(left).to(device),
                      torch.from_numpy(wb).to(device))
    wh = np.zeros((nwidth, w_total), dtype=np.float32)
    wh[:, :w_valid] = resize_weights_dense(w_valid, nwidth)
    return False, torch.from_numpy(wh).to(device)


@functools.lru_cache(maxsize=128)
def _dev_horizontal_weights_crop(w_valid: int, full_width: int, c0: int,
                                 c1: int, device: torch.device):
    """Banded weights for output columns [c0, c1) of the full-width resize,
    built O(viewport): a crop is pixel-identical to slicing the full
    image."""
    left, wb = resize_weights_range(w_valid, full_width, c0, c1)
    return (torch.from_numpy(left).to(device),
            torch.from_numpy(wb).to(device))


class AudioTrack:
    """Loaded track + derived STFT params (lib.rs:30-62).

    ``channel=None`` sums channels to mono (the reference's behavior,
    lib.rs:42); ``channel=k`` views channel k alone.
    """

    def __init__(self, path: str, setting: SpecSetting, channel=None):
        from ..io.audio import open_audio_mono_ex

        # For integer sources the f32 mono is lazy: the device path only
        # consumes the integer carrier.
        mono, sr, raw_int, shift, n_ch = open_audio_mono_ex(
            path, materialize=False, channel=channel
        )
        self.path = path
        self.channel = channel if channel is None else int(channel)
        self.n_channels = int(n_ch)
        self._mono_f32 = mono  # None when raw_int carries the samples
        # mono == raw_int * 2^-shift exactly; None for true-float sources
        self._wav_int = raw_int
        self._wav_shift = shift
        self.n_samples = len(raw_int) if raw_int is not None else len(mono)
        self.sr = int(sr)
        self._mono_lock = threading.Lock()
        p = derive_stft_params(sr, setting)
        self.win_length = p.win_length
        self.hop_length = p.hop_length
        self.n_fft = p.n_fft

    @property
    def scale(self) -> float:
        """Exact f32 value of one integer-carrier unit (2^-shift)."""
        return float(2.0 ** -self._wav_shift)

    @property
    def wav(self) -> np.ndarray:
        """f32 mono sum (materialized on first access for int sources)."""
        if self._mono_f32 is None:
            with self._mono_lock:
                if self._mono_f32 is None:
                    self._mono_f32 = self._wav_int.astype(
                        np.float32
                    ) * np.float32(self.scale)
        return self._mono_f32

    @property
    def sec(self) -> float:
        """Duration in f32 seconds (lib.rs:178: len as f32 / sr as f32)."""
        return float(np.float32(self.n_samples) / np.float32(self.sr))

    @property
    def wire(self) -> str:
        """The kernel's input type for this track: PCM16 carriers (shift
        15) go as int16 and are scaled by 2^-15 in the kernel; every other
        source is scaled to f32 on the host."""
        if (self._wav_int is not None and self._wav_int.dtype == np.int16
                and self._wav_shift == 15):
            return "i16"
        return "f32"


class _TrackState:
    """Device-side artifacts for one track."""

    __slots__ = ("spec_db", "n_frames", "n_frames_pad", "n_out", "smin", "smax")


class MultiTrack:
    """Multi-track spectrogram session (lib.rs:72-365) on ``device``.

    ``device`` defaults to "cuda" and is never replaced silently: without a
    card the constructor raises.  ``device="cpu"`` runs the kernels' plain
    PyTorch versions (tests).
    """

    def __init__(self, setting: SpecSetting | None = None, device="cuda"):
        self.setting = setting or SpecSetting()
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "MultiTrack(device='cuda'): no CUDA device is available; "
                    "pass device='cpu' for the plain PyTorch path"
                )
            # parity: the render GEMMs must run true f32, not TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device: {self.device}")
        self.tracks: dict[int, AudioTrack] = {}
        # sr -> {mode: (C, S, fb)} on device: f32 for parity, bf16 for fast;
        # fb is None on the linear scale
        self._operands: dict[int, dict[str, tuple]] = {}
        self._state: dict[int, _TrackState] = {}
        # id -> EnvelopeState: the device wave of get_wav_image, built at
        # the first waveform render, or adopted from streaming
        self._env_states: dict[int, EnvelopeState] = {}
        self._env_lock = threading.Lock()
        self.max_db = -np.inf
        self.min_db = np.inf
        self.max_sec = 0.0
        self.id_max_sec = 0
        self.max_sr = 0
        self.timer = StageTimer()
        self._log = get_logger()

    # ------------------------------------------------------------- caches

    @property
    def _use_mel(self) -> bool:
        return self.setting.freq_scale == FreqScale.MEL

    def _ensure_sr_operands(self, track: AudioTrack) -> None:
        if track.sr in self._operands:
            return
        self._log.debug("DFT/mel operand cache miss for sr=%d", track.sr)
        window = default_stft_window(track.win_length, track.n_fft)
        c, s = windowed_dft_matrices(window, track.n_fft)
        fb = calc_mel_fb_default(track.sr, track.n_fft)
        ops = operands_from_numpy(c, s, fb, self.device)
        self._operands[track.sr] = {
            "parity": ops if self._use_mel else (*ops[:2], None)}

    def _sr_operands(self, sr: int, mode: str) -> tuple:
        """The operands of rate ``sr`` in precision ``mode``; the bf16
        copies are made at the first fast-mode use and kept.  The linear
        scale has no filterbank and computes in f32 in every mode."""
        ops = self._operands[sr]
        if not self._use_mel:
            return ops["parity"]
        if mode not in ops:
            ops[mode] = operands_bf16(*ops["parity"])
        return ops[mode]

    # ------------------------------------------------------- spectrograms

    def _prep_padded(self, track):
        """(padded, n_frames, n_frames_pad): the reflect-padded wave in the
        track's kernel input type, zero-extended to n_frames_pad frames."""
        win, hop = track.win_length, track.hop_length
        n_frames, n_frames_pad = _frame_counts(track)
        src = (
            track._wav_int
            if track._wav_int is not None
            else track.wav.astype(np.float32)
        )
        padded = reflect_pad_center(src, win)
        need = (n_frames_pad - 1) * hop + win
        if len(padded) < need:
            padded = np.pad(padded, (0, need - len(padded)))
        padded = padded[:need]
        if track.wire == "f32" and padded.dtype != np.float32:
            # other integer carriers: exact power-of-two scale on the host
            padded = padded.astype(np.float32) * np.float32(track.scale)
        return padded, n_frames, n_frames_pad

    def _compute_specs(self, id_list) -> None:
        """One batched call per bucket (sr, n_frames_pad, wire): a kernel
        launch on the mel scale, ``spec_pipeline_batched`` on the linear
        one; a bucket of one track is a batch of one.  Tracks over
        STREAMING_FRAME_THRESHOLD frames stream, one at a time, and keep
        their streamed device wave for the waveform images."""
        groups: dict[tuple, list[int]] = {}
        streamed: list[int] = []
        for id in id_list:
            tr = self.tracks[id]
            n_frames, n_frames_pad = _frame_counts(tr)
            if n_frames > STREAMING_FRAME_THRESHOLD:
                streamed.append(id)
                continue
            groups.setdefault((tr.sr, n_frames_pad, tr.wire), []).append(id)
        for (sr, n_frames_pad, _wire), ids in groups.items():
            self._calc_spec_group(ids, sr, n_frames_pad)
        for id in streamed:
            with self.timer.stage("add_tracks.streaming"):
                self._state[id] = self._calc_spec_streaming(self.tracks[id],
                                                            id)

    def _calc_spec_streaming(self, track, id) -> _TrackState:
        """Long-track path: segmented streaming through the kernel of the
        session's precision mode (the torch-op route on the linear scale),
        with the track's carrier and scale.

        The streamed (reflect-padded) wave stays on the device and becomes
        the track's envelope buffer: a later get_wav_image costs no second
        whole-file transfer."""
        src = (track._wav_int if track._wav_int is not None
               else np.asarray(track.wav, np.float32))
        db, n_valid, smin, smax, wav_dev = streaming_spec_db(
            src, track.win_length, track.hop_length,
            *self._sr_operands(track.sr, get_precision_mode()),
            keep_wav=True, scale=track.scale,
        )
        self._env_states[id] = EnvelopeState.from_device(
            wav_dev, track.n_samples, offset=track.win_length // 2,
            src_int=track._wav_int,
            # true-float sources have no integer carrier; the deep-zoom
            # branch then reads the f32 mono
            src_f32=None if track._wav_int is not None else track.wav,
            scale=track.scale,
        )
        st = _TrackState()
        st.spec_db = db
        st.n_frames = n_valid
        st.n_frames_pad = int(db.shape[0])
        st.n_out = int(db.shape[1])
        st.smin = smin
        st.smax = smax
        return st

    def _calc_spec_group(self, ids, sr: int, n_frames_pad: int) -> None:
        """Same-bucket tracks stacked into one (B, L) kernel launch (or one
        ``spec_pipeline_batched`` call on the linear scale), with the
        per-track dB min/max over valid frames and one host sync."""
        tr0 = self.tracks[ids[0]]
        with self.timer.stage("add_tracks.host_prep"):
            preps = [self._prep_padded(self.tracks[i]) for i in ids]
            wave = torch.from_numpy(np.stack([p[0] for p in preps]))
        with self.timer.stage("add_tracks.h2d"):
            wave = wave.to(self.device)
        mode = get_precision_mode()
        n_valid = torch.tensor([p[1] for p in preps], device=self.device)
        kw = dict(win=tr0.win_length, hop=tr0.hop_length,
                  n_frames=n_frames_pad, mode=mode)
        if not self._use_mel:
            with self.timer.stage("add_tracks.linear_minmax"):
                # int16 carriers are PCM16 (2^-15); the rest arrive in f32
                db_b, smin, smax = spec_pipeline_batched(
                    wave, *self._sr_operands(sr, mode), n_valid,
                    use_mel=False, **kw)
                mm = torch.stack([smin, smax]).cpu().numpy()  # one sync
        else:
            with self.timer.stage("add_tracks.kernel_minmax"):
                db_b = mel_spectrogram_cuda(
                    wave, *self._sr_operands(sr, mode), **kw)
                frame = torch.arange(n_frames_pad, device=self.device)
                fmask = (frame[None, :] < n_valid[:, None])[:, :, None]
                smax = torch.where(fmask, db_b, -torch.inf).amax(dim=(1, 2))
                smin = torch.where(fmask, db_b, torch.inf).amin(dim=(1, 2))
                mm = torch.stack([smin, smax]).cpu().numpy()  # one sync
        for b, id in enumerate(ids):
            st = _TrackState()
            st.spec_db = db_b[b]
            st.n_frames = preps[b][1]
            st.n_frames_pad = n_frames_pad
            st.n_out = int(db_b.shape[2])
            st.smin = float(mm[0, b])
            st.smax = float(mm[1, b])
            self._state[id] = st

    # ------------------------------------------------------------ tracks

    def _track(self, id: int) -> AudioTrack:
        try:
            return self.tracks[id]
        except KeyError:
            raise TrackNotFoundError(id) from None

    def add_tracks(self, id_list, path_list, channels=None) -> bool:
        """Add tracks and recompute state (lib.rs:170-191).

        ``path_list`` may be a list of paths or one newline-joined string
        (lib.rs:171-173).  ``channels`` (optional per-track int | None)
        selects one source channel instead of the sum to mono.  Returns
        whether the global dB range / max_sr changed.
        """
        if isinstance(path_list, str):
            path_list = path_list.split("\n")
        if len(id_list) != len(path_list):
            raise ValueError(
                f"id_list has {len(id_list)} entries but path_list "
                f"{len(path_list)} — a zip would silently drop tracks"
            )
        if channels is None:
            channels = [None] * len(path_list)
        elif len(channels) != len(path_list):
            raise ValueError(
                f"channels has {len(channels)} entries but path_list "
                f"{len(path_list)} — a zip would silently drop tracks"
            )
        with self.timer.stage("add_tracks.decode"):
            new = [AudioTrack(p, self.setting, channel=ch)
                   for p, ch in zip(path_list, channels)]
        with self.timer.stage("add_tracks.operands"):
            for id, track in zip(id_list, new):
                self._ensure_sr_operands(track)
                # a re-added id is a new file: drop the old envelope buffer
                self._env_states.pop(id, None)
                self.tracks[id] = track
            # recompute (not just raise) max_sec: replacing the longest
            # track with a shorter file must lower it
            best_id, best_sec = 0, 0.0
            for tid, t in self.tracks.items():
                if t.sec > best_sec:
                    best_id, best_sec = tid, t.sec
            self.id_max_sec, self.max_sec = best_id, best_sec
        with self.timer.stage("add_tracks.spec"):
            self._compute_specs(list(id_list))
        return self._update_db_state()

    def remove_track(self, id: int) -> bool:
        """Remove a track (lib.rs:265-292)."""
        track = self._track(id)
        del self.tracks[id]
        self._state.pop(id, None)
        self._env_states.pop(id, None)
        if self.id_max_sec == id:
            best_id, best_sec = 0, 0.0
            for tid, t in self.tracks.items():
                if t.sec > best_sec:
                    best_id, best_sec = tid, t.sec
            self.id_max_sec, self.max_sec = best_id, best_sec
        if all(t.sr != track.sr for t in self.tracks.values()):
            self._operands.pop(track.sr, None)
        return self._update_db_state()

    # ----------------------------------------------------- global dB state

    def _update_db_state(self) -> bool:
        """Global dB window + max_sr bookkeeping (lib.rs:193-263)."""
        gmax, gmin = -np.inf, np.inf
        for st in self._state.values():
            gmax = max(gmax, st.smax)
            gmin = min(gmin, st.smin)
        gmax = min(gmax, 0.0)
        gmin = max(gmin, gmax - self.setting.db_range)
        changed = False
        if not abs(self.max_db - gmax) <= 1e-3:  # abs_diff_ne!, lib.rs:211
            self.max_db = gmax
            changed = True
        if not abs(self.min_db - gmin) <= 1e-3:
            self.min_db = gmin
            changed = True
        max_sr = max((t.sr for t in self.tracks.values()), default=0)
        if self.max_sr != max_sr:
            self.max_sr = max_sr
            changed = True
        return changed

    def _up_ratio(self, sr: int) -> float:
        """Cross-track frequency alignment ratio, f32 (lib.rs:231-248)."""
        f32 = np.float32
        if not self._use_mel:
            return float(f32(self.max_sr) / f32(sr))
        return float(
            hz_to_mel(f32(self.max_sr) / f32(2.0))
            / hz_to_mel(f32(sr) / f32(2.0))
        )

    # ------------------------------------------------------------ renders

    def get_spec_db(self, id: int, wire: str = "f32") -> np.ndarray:
        """The dB spectrogram -> float32 (n_frames, n_out), fetched exactly:
        n_out is n_mel on the mel scale, n_fft // 2 + 1 on the linear one.
        msv_tpu's packed wires ("q16"/"q12"/"q10"/"q8") are not
        ported."""
        if wire != "f32":
            raise NotImplementedError(
                f"dB wire {wire!r} is not ported yet (ROADMAP queue 1: "
                f"wire codec); use wire='f32'"
            )
        self._track(id)  # raises TrackNotFoundError for unknown ids
        st = self._state[id]
        return st.spec_db[: st.n_frames].cpu().numpy()

    def _run_render(self, st, wv, wh, *, height, banded, wire):
        """Device render + host finalize for the image getters.

        wire="rgb": colormap applied on device to the f32 grey, 3 bytes/px
        fetched.  "grey8"/"grey16": fetch the quantized grey and paint RGB
        on the host via the matching LUT.
        """
        max_db, min_db = self.max_db, self.min_db
        if wire == "rgb":
            with self.timer.stage("render.device_d2h"):
                img = render_rgb(st.spec_db, max_db, min_db, wv, wh,
                                 height=height, banded=banded).cpu().numpy()
            # device output is channel-planar (3, H, W); interleave on host
            with self.timer.stage("render.host"):
                return np.ascontiguousarray(img.transpose(1, 2, 0))
        if wire not in ("grey8", "grey16"):
            raise ValueError(f"unknown image wire format: {wire!r}")
        bits = {"grey8": 8, "grey16": 16}[wire]
        with self.timer.stage("render.device_d2h"):
            q = render_grey_q(st.spec_db, max_db, min_db, wv, wh,
                              height=height, banded=banded, bits=bits)
            q = q.cpu().numpy()
        with self.timer.stage("render.host"):
            return paint_grey_wire(q, bits)

    def get_spec_image(
        self, id: int, px_per_sec: float, nheight: int, wire: str | None = None
    ) -> np.ndarray:
        """Colormapped spectrogram image (lib.rs:294-298) -> (h, w, 3) u8.

        Width = trunc(px_per_sec * len / sr) like the reference's `as u32`
        (lib.rs:296).  ``wire`` overrides the session-wide image wire
        format (config.set_image_wire).
        """
        track = self._track(id)
        st = self._state[id]
        f32 = np.float32
        nwidth = trunc_int(f32(px_per_sec) * f32(track.n_samples) / f32(track.sr))
        if nwidth == 0 or nheight == 0:
            return np.zeros((nheight, nwidth, 3), dtype=np.uint8)
        _check_render_dims(nwidth, nheight, "get_spec_image")
        height = grey_height(st.n_out, self._up_ratio(track.sr))
        wv = _dev_vertical_weights(height, nheight, self.device)
        banded, wh = _dev_horizontal_weights(
            st.n_frames, nwidth, st.n_frames_pad, self.device
        )
        with self.timer.stage("get_spec_image.render"):
            return self._run_render(st, wv, wh, height=height, banded=banded,
                                    wire=wire or get_image_wire())

    def get_spec_image_crop(
        self,
        id: int,
        px_per_sec: float,
        nheight: int,
        start_sec: float,
        end_sec: float,
        wire: str | None = None,
    ) -> np.ndarray:
        """Viewport render: pixel-identical to
        ``get_spec_image(...)[:, c0:c1]`` where c0/c1 are the columns
        covering [start_sec, end_sec), without rendering the full width."""
        track = self._track(id)
        st = self._state[id]
        full_w, c0, c1 = _crop_cols(track, px_per_sec, start_sec, end_sec)
        if c1 <= c0 or nheight == 0:
            return np.zeros((nheight, 0, 3), dtype=np.uint8)
        _check_render_dims(c1 - c0, nheight, "get_spec_image_crop")
        height = grey_height(st.n_out, self._up_ratio(track.sr))
        wv = _dev_vertical_weights(height, nheight, self.device)
        wh = _dev_horizontal_weights_crop(st.n_frames, full_w, c0, c1,
                                          self.device)
        with self.timer.stage("get_spec_image.render"):
            return self._run_render(st, wv, wh, height=height, banded=True,
                                    wire=wire or get_image_wire())

    # ------------------------------------------------------- waveform images

    def _env_state_for(self, id: int, track) -> EnvelopeState:
        """The track's envelope state, its wave shipped to the device at the
        first waveform render (integer carriers as they are: no f32 copy on
        the host)."""
        st = self._env_states.get(id)
        if st is None:
            # double-checked: two concurrent renders of a fresh track must
            # not both ship the wave
            with self._env_lock:
                st = self._env_states.get(id)
                if st is None:
                    st = EnvelopeState(
                        None if track._wav_int is not None else track.wav,
                        track._wav_int, n=track.n_samples,
                        scale=track.scale, device=self.device)
                    self._env_states[id] = st
        return st

    def get_wav_image(self, id: int, px_per_sec: float, nheight: int,
                      amp_min: float, amp_max: float) -> np.ndarray:
        """Waveform envelope image (lib.rs:300-313) -> (h, w, 4) RGBA u8."""
        track = self._track(id)
        f32 = np.float32
        nwidth = trunc_int(f32(px_per_sec) * f32(track.n_samples)
                           / f32(track.sr))
        _check_render_dims(nwidth, nheight, "get_wav_image")
        st = self._env_state_for(id, track)
        with self.timer.stage("get_wav_image.render"):
            return wav_to_image(None, nwidth, nheight, (amp_min, amp_max),
                                state=st)

    def get_wav_image_crop(self, id: int, px_per_sec: float, nheight: int,
                           amp_min: float, amp_max: float, start_sec: float,
                           end_sec: float) -> np.ndarray:
        """Viewport waveform render — columns [c0, c1) of the full-width
        envelope image (pixel-identical to slicing it)."""
        track = self._track(id)
        f32 = np.float32
        nwidth = trunc_int(f32(px_per_sec) * f32(track.n_samples)
                           / f32(track.sr))
        c0 = trunc_int(f32(px_per_sec) * f32(start_sec))
        c1 = trunc_int(f32(px_per_sec) * f32(end_sec))
        _check_render_dims(max(min(c1, nwidth) - max(c0, 0), 0), nheight,
                           "get_wav_image_crop")
        st = self._env_state_for(id, track)
        with self.timer.stage("get_wav_image.render"):
            return wav_to_image(None, nwidth, nheight, (amp_min, amp_max),
                                state=st, col_range=(c0, c1))

    def get_grey(self, id: int) -> np.ndarray:
        """The normalized grey image (display.rs:44-54)."""
        track = self._track(id)
        st = self._state[id]
        height = grey_height(st.n_out, self._up_ratio(track.sr))
        g = spec_to_grey(st.spec_db, self.max_db, self.min_db, height=height)
        return g[:, : st.n_frames].cpu().numpy()

    # ------------------------------------------------------------ getters

    def get_frequency_hz(self, id: int, relative_freq: float) -> float:
        """Cursor frequency readout (lib.rs:315-322), f32 math."""
        f32 = np.float32
        half_sr = f32(self._track(id).sr) / f32(2.0)
        if not self._use_mel:
            return float(half_sr * f32(relative_freq))
        return float(mel_to_hz(hz_to_mel(half_sr) * f32(relative_freq)))

    def get_max_db(self) -> float:
        return float(self.max_db)

    def get_min_db(self) -> float:
        return float(self.min_db)

    def get_max_sec(self) -> float:
        return float(self.max_sec)

    def get_sec(self, id: int) -> float:
        return self._track(id).sec

    def get_sr(self, id: int) -> int:
        return self._track(id).sr

    def get_path(self, id: int) -> str:
        return self._track(id).path

    def get_filename(self, id: int) -> str:
        return os.path.basename(self._track(id).path)

    def get_n_channels(self, id: int) -> int:
        """Source channel count (the reference sums to mono, lib.rs:42)."""
        return self._track(id).n_channels

    def get_channel(self, id: int):
        """Selected channel (int) or None for the sum-to-mono default."""
        return self._track(id).channel

    # ------------------------------------------------------------ settings

    def set_setting(self, setting: SpecSetting) -> bool:
        """Change settings and reload every track (AudioTrack::reload,
        lib.rs:57-61 — declared but never wired in the reference; here it is
        the live settings path).  Every cache goes: dB planes, envelope
        states and operands.  Returns whether the dB range changed."""
        self.setting = setting
        ids = sorted(self.tracks)
        paths = [self.tracks[i].path for i in ids]
        chans = [self.tracks[i].channel for i in ids]
        self.tracks.clear()
        self._state.clear()
        self._env_states.clear()
        self._operands.clear()
        self.max_db, self.min_db = -np.inf, np.inf
        self.max_sec, self.id_max_sec, self.max_sr = 0.0, 0, 0
        if not ids:
            return self._update_db_state()
        return self.add_tracks(ids, paths, channels=chans)

    def save_session(self, path: str) -> None:
        """Serialize session state: track list + settings + dB stats, the
        v2 manifest of msv_tpu.  Spectrograms are recomputable, so a
        restart is re-add + renormalize from this manifest."""
        manifest = {
            # v2 adds per-track channel selection; v1 manifests (plain
            # path strings) still load
            "version": 2,
            "setting": {
                "win_ms": self.setting.win_ms,
                "t_overlap": self.setting.t_overlap,
                "f_overlap": self.setting.f_overlap,
                "freq_scale": self.setting.freq_scale.value,
                "db_range": self.setting.db_range,
            },
            "tracks": {
                str(i): {"path": t.path, "channel": t.channel}
                for i, t in self.tracks.items()
            },
            "max_db": self.max_db if np.isfinite(self.max_db) else None,
            "min_db": self.min_db if np.isfinite(self.min_db) else None,
        }
        with open(path, "w") as f:
            json.dump(manifest, f, indent=1)

    @classmethod
    def load_session(cls, path: str, device="cuda") -> "MultiTrack":
        """A session on ``device`` from a v1 or v2 manifest of
        :meth:`save_session` (or of msv_tpu's)."""
        with open(path) as f:
            m = json.load(f)
        s = m["setting"]
        setting = SpecSetting(
            win_ms=s["win_ms"],
            t_overlap=s["t_overlap"],
            f_overlap=s["f_overlap"],
            freq_scale=FreqScale(s["freq_scale"]),
            db_range=s["db_range"],
        )
        mt = cls(setting, device=device)
        ids = sorted(int(k) for k in m["tracks"])
        if ids:
            ent = [m["tracks"][str(i)] for i in ids]
            # v1: plain path strings; v2: {"path", "channel"} objects
            paths = [e if isinstance(e, str) else e["path"] for e in ent]
            chans = [None if isinstance(e, str) else e.get("channel")
                     for e in ent]
            mt.add_tracks(ids, paths, channels=chans)
        return mt
