"""MultiTrack session on PyTorch, ported from ``msv_tpu/session/multitrack.py``
(reference: ``MultiTrack``, lib.rs:72-365; ``AudioTrack``, lib.rs:30-62).

Host Python owns file I/O and the global-dB state machine; the device owns
every per-sample computation.  On the mel scale every track's spectrogram
goes through the rate's route in the session's precision mode
(``kernels/spectrogram_cuda.py::MelRoute``: the fused CUDA kernel, f32
under "parity" and bf16 under "fast", or its plain version on the same
device under ``config.set_engine("xla")``); on the linear scale through
the rate's ``LinearRoute`` (the FFT tier's linear form in parity where n_fft
has an FFT plan, else ``spec_pipeline_batched``'s dense GEMM pair, f32 in
parity and TF32 in fast).  Tracks that share a bucket
``(sr, n_frames_pad, wire)`` go as one batched call (each track then owns a
copy of its plane and of its row of the batch), and a track over
STREAMING_FRAME_THRESHOLD frames goes alone through segmented streaming
(``parallel/streaming.py``).  The track keeps its row, or the streamed
device wave, for its waveform images.  Renders are torch ops over
the cached device dB planes and device waves (``render/envelope.py`` for
the waveform), and adaptive multi-resolution crops over slice-local or
background-built planes (``ops/multires.py``).

Device memory: ``hbm_budget_bytes`` (or config.set_session_hbm_budget)
bounds the cached per-track device state.  Past it the least-recently-used
track's dB plane spills to a host f32 array (bit-exact; re-uploaded by its
next render) and its envelope and adaptive buffers drop (rebuilt lazily).
Residency changes take the track's lock, and a render works on its own
reference to the device plane, so a concurrent spill never pulls a plane
from under it.

Behavioural contracts kept from msv_tpu:
  * dB window: max_db = min(global_max, 0), min_db = max(global_min,
    max_db - db_range), 1e-3 change hysteresis (lib.rs:193-218).
  * Padded frames (rows >= n_frames) are left out of the per-track min/max.
  * up_ratio frequency alignment: mel(max_sr/2)/mel(sr/2), or max_sr/sr on
    the linear scale (lib.rs:231-248, f32).
  * channel sum (not mean) to mono (lib.rs:42); window = hann/n_fft.
"""

import functools
import json
import os
import threading

import numpy as np
import torch

from ..config import (FreqScale, SpecSetting, check_db_wire,
                      derive_stft_params, get_db_wire, get_image_wire,
                      get_precision_mode, get_session_hbm_budget)
from ..kernels.pipeline import (masked_minmax, render_grey_q, render_rgb,
                                spec_pipeline_batched)
from ..kernels.spectrogram_cuda import (LinearRoute, MelRoute,
                                        mel_spectrogram_cuda)
from ..parallel.streaming import streaming_spec_db
from ..parallel.wirepack import fetch_unpack_spec_stream, pack_spec
from ..ops.framing import n_frames_for
from ..ops.mel import calc_mel_fb_default, hz_to_mel, mel_to_hz
from ..ops.multires import (adaptive_auto_n_mel, adaptive_frame_count,
                            multires_mel_spec_db_range, range_sample_window)
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
from ..utils.errors import AdaptiveBuildPending, MsvError, TrackNotFoundError
from ..utils.profiling import StageTimer, get_logger, span
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


def _carrier(track):
    """(samples, scale): the track's decoded samples as they are, the
    integer carrier where one exists, else the f32 mono (scale 1)."""
    if track._wav_int is not None:
        return track._wav_int, track.scale
    return np.asarray(track.wav, np.float32), 1.0


def _adopt_envelope(track, wave: torch.Tensor, offset: int) -> EnvelopeState:
    """The track's envelope state over ``wave``, a device buffer already
    holding the track's samples from index ``offset`` on (its integer
    carrier as decoded, or their exact f32): its waveform images then cost
    no second whole-file transfer.  The host carrier feeds the deep-zoom
    branch."""
    return EnvelopeState.from_device(
        wave, track.n_samples, offset=offset, src_int=track._wav_int,
        # true-float sources have no integer carrier; the deep-zoom
        # branch then reads the f32 mono
        src_f32=None if track._wav_int is not None else track.wav,
        scale=track.scale)


def _carrier_name(a: np.ndarray) -> str:
    """"i16", "i32" or "f32": the dtype a carrier crosses to the device in."""
    return f"{a.dtype.kind}{8 * a.dtype.itemsize}"


def pad_group_on_device(carriers, win_length: int, need: int,
                        dtype: torch.dtype, device) -> torch.Tensor:
    """The (B, need) kernel input of a group: row b is ``carriers[b]``
    ((samples, scale) pairs) reflect-padded by win_length // 2 on both
    sides as ``reflect_pad_center`` pads it, zero-extended or cut to
    ``need`` (more than the two edges), in ``dtype``.

    Each carrier crosses to ``device`` once, as it is and no longer than
    its row holds; the edges are filled there from the row itself.  An
    integer carrier going into a float batch is cast and then multiplied
    by its scale in f32 on the device: both are exact (the scale is a power
    of two), so the row holds the bits of the host's
    ``astype(np.float32) * np.float32(scale)``.  Into a batch of the
    carrier's own dtype the samples go unscaled (int16 rows: the kernel
    applies 2^-15)."""
    half = win_length // 2
    out = torch.empty((len(carriers), need), dtype=dtype, device=device)
    for row, (src, scale) in zip(out, carriers):
        n = len(src)
        if n < half + 1:
            raise ValueError(
                f"signal too short for win_length={win_length}: "
                f"need at least {half + 1} samples, got {n}")
        host = torch.from_numpy(src[: need - half])
        body = row[half : half + len(host)]
        if host.dtype == dtype:
            body.copy_(host)
        else:
            # to the device first: a copy that also casts would cast on
            # the host
            torch.mul(host.to(device), scale, out=body)
        # left: row[p] = wav[half - p] = row[2 * half - p] for p < half
        row[:half] = row[half + 1 : 2 * half + 1].flip(0)
        # right: row[half + n + q] = wav[n - 2 - q], as far as the row goes
        r = max(0, min(half, need - half - n))
        if r:
            e = half + n
            row[e : e + r] = row[e - 1 - r : e - 1].flip(0)
        row[2 * half + n :].zero_()
    return out


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
                                 c1: int, device: torch.device,
                                 base: int = 0):
    """Banded weights for output columns [c0, c1) of the full-width resize,
    built O(viewport): a crop is pixel-identical to slicing the full
    image.  ``base`` shifts the indices for renders over an input slice
    starting at that frame (the adaptive slice-local path)."""
    left, wb = resize_weights_range(w_valid, full_width, c0, c1)
    return (torch.from_numpy(left - base).to(device),
            torch.from_numpy(wb).to(device))


class _AdaptiveBuild:
    """State of one track's background full-adaptive-dB build: segment
    results land in ``parts`` (``built`` = frames completed so far),
    ``full`` is the final device plane, ``cancel`` stops a build whose
    track/setting was invalidated mid-flight."""

    __slots__ = ("n_mel", "nf", "parts", "built", "full", "error",
                 "cancel", "done", "thread", "lock")

    def __init__(self, n_mel: int, nf: int):
        self.n_mel = n_mel
        self.nf = nf
        self.parts = []
        self.built = 0
        self.full = None
        self.error = None
        self.cancel = threading.Event()
        self.done = threading.Event()
        self.thread = None
        self.lock = threading.Lock()


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

    def wav_slice(self, s0: int, s1: int) -> np.ndarray:
        """f32 mono samples [s0, s1) — O(slice) even for integer carriers
        (never materializes the full lazy f32)."""
        if self._mono_f32 is not None:
            return self._mono_f32[s0:s1]
        return self._wav_int[s0:s1].astype(np.float32) * np.float32(
            self.scale
        )

    def wav_slice_raw(self, s0: int, s1: int):
        """(samples[s0:s1], unit scale) in the track's narrowest exact
        form: the integer carrier when one exists (half the host->device
        bytes; the conversion on the device is exact), else f32."""
        if self._wav_int is not None:
            return self._wav_int[s0:s1], self.scale
        return self._mono_f32[s0:s1], 1.0

    def reload(self, setting: SpecSetting) -> None:
        """Re-derive params after a setting change (lib.rs:57-61)."""
        self.__init__(self.path, setting, channel=self.channel)

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
    """Device-side artifacts for one track.  ``spec_db`` is a tensor on the
    session's device, or a host f32 array while spilled; ``lock`` guards
    every change of residency."""

    __slots__ = ("spec_db", "n_frames", "n_frames_pad", "n_out", "smin",
                 "smax", "lock")

    def __init__(self):
        self.lock = threading.Lock()


class MultiTrack:
    """Multi-track spectrogram session (lib.rs:72-365) on ``device``.

    ``device`` defaults to "cuda" and is never replaced silently: without a
    card the constructor raises.  ``device="cpu"`` runs the kernels' plain
    PyTorch versions (tests).  ``hbm_budget_bytes`` bounds the device bytes
    of the cached per-track state (module docstring); None (default, or
    config.set_session_hbm_budget) is unbounded.
    """

    # Slice-local adaptive renders compute their frame support at 3 window
    # scales per request; past this support the render reads the per-track
    # full adaptive plane, built once in the background.
    ADAPTIVE_MAX_FRAMES = 1 << 16
    # Frames per segment of that build: device memory of one segment's
    # frames at a time.
    ADAPTIVE_CHUNK = 8192

    def __init__(self, setting: SpecSetting | None = None, device="cuda",
                 hbm_budget_bytes: int | None = None):
        self.setting = setting or SpecSetting()
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "MultiTrack(device='cuda'): no CUDA device is available; "
                    "pass device='cpu' for the plain PyTorch path"
                )
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device: {self.device}")
        self.tracks: dict[int, AudioTrack] = {}
        # sr -> the rate's route and its operands: a MelRoute on the mel
        # scale, a LinearRoute on the linear scale
        self._operands: dict[int, MelRoute | LinearRoute] = {}
        self._state: dict[int, _TrackState] = {}
        # id -> EnvelopeState: the device wave of get_wav_image, adopted at
        # add time (the group's row or the streamed wave), else shipped at
        # the first waveform render
        self._env_states: dict[int, EnvelopeState] = {}
        self._env_lock = threading.Lock()
        self._adaptive_db: dict[int, _AdaptiveBuild] = {}
        self._adaptive_lock = threading.Lock()  # guards the dict
        self.hbm_budget_bytes = (hbm_budget_bytes if hbm_budget_bytes
                                 is not None else get_session_hbm_budget())
        self._lru: dict[int, int] = {}  # id -> last-use tick
        self._lru_clock = 0
        self._hbm_spills = 0
        self._hbm_reuploads = 0
        # guards the LRU and the counters, and serializes budget passes
        self._budget_lock = threading.Lock()
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
        """The rate's route at its first add: on the mel scale a
        ``MelRoute`` (the default window and filterbank, named by the rate's
        shape), on the linear scale a ``LinearRoute`` (the default window),
        with its f32 C and S (and fb) on the device where its calls in the
        session's mode read them (``prepare``: none at a rate whose calls
        take the FFT tier on a card)."""
        if track.sr in self._operands:
            return
        self._log.debug("DFT/mel operand cache miss for sr=%d", track.sr)
        window = default_stft_window(track.win_length, track.n_fft)
        kw = dict(win=track.win_length, hop=track.hop_length,
                  n_fft=track.n_fft, device=self.device)
        if self._use_mel:
            route = MelRoute(window, calc_mel_fb_default(track.sr,
                                                         track.n_fft),
                             key=("session", track.sr, track.win_length,
                                  track.n_fft), **kw)
        else:
            route = LinearRoute(window, **kw)
        # the upload falls in add_tracks.operands, not in the launch's stage
        route.prepare(get_precision_mode())
        self._operands[track.sr] = route

    # ------------------------------------------------------- spectrograms

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
        """Long-track path: segmented streaming through the rate's route
        in the session's precision mode, with the track's carrier and
        scale.

        The streamed (reflect-padded) wave stays on the device and becomes
        the track's envelope buffer: a later get_wav_image costs no second
        whole-file transfer."""
        src, _ = _carrier(track)
        db, n_valid, smin, smax, wav_dev = streaming_spec_db(
            src, track.win_length, track.hop_length,
            self._operands[track.sr], None, None,
            keep_wav=True, scale=track.scale, sr=track.sr,
        )
        self._env_states[id] = _adopt_envelope(track, wav_dev,
                                               track.win_length // 2)
        st = _TrackState()
        st.spec_db = db
        st.n_frames = n_valid
        st.n_frames_pad = int(db.shape[0])
        st.n_out = int(db.shape[1])
        st.smin = smin
        st.smax = smax
        return st

    def _calc_spec_group(self, ids, sr: int, n_frames_pad: int) -> None:
        """Same-bucket tracks in one (B, L) call of the rate's route (a
        kernel launch on the mel scale; on the linear scale a kernel launch
        or one ``spec_pipeline_batched`` call), with the per-track dB
        min/max over valid frames and one host sync.  The
        batch is assembled on the device from one upload of each track's
        carrier (``pad_group_on_device``): int16 for the "i16" wire, else
        f32; its rows then become the tracks' envelope buffers."""
        tr0 = self.tracks[ids[0]]
        win = tr0.win_length
        need = (n_frames_pad - 1) * tr0.hop_length + win
        with self.timer.stage("add_tracks.host_prep"):
            n_frames = [_frame_counts(self.tracks[i])[0] for i in ids]
            carriers = [_carrier(self.tracks[i]) for i in ids]
        with self.timer.stage("add_tracks.h2d"):
            sent = [a[: need - win // 2] for a, _ in carriers]
            with span("session.upload", route="device_pad", tracks=len(ids),
                      carrier="+".join(sorted({_carrier_name(a)
                                               for a in sent})),
                      bytes=sum(a.nbytes for a in sent)):
                wave = pad_group_on_device(
                    carriers, win, need,
                    torch.int16 if tr0.wire == "i16" else torch.float32,
                    self.device)
        n_valid = torch.tensor(n_frames, device=self.device)
        if not self._use_mel:
            with self.timer.stage("add_tracks.linear_minmax"):
                # int16 carriers are PCM16 (2^-15); the rest arrive in f32
                db_b, smin, smax = self._operands[sr](
                    wave, n_frames_pad, n_valid, mode=get_precision_mode(),
                    sr=sr, pipeline=spec_pipeline_batched)
                mm = torch.stack([smin, smax]).cpu().numpy()  # one sync
        else:
            with self.timer.stage("add_tracks.kernel_minmax"):
                db_b = self._operands[sr](
                    wave, n_frames_pad, mode=get_precision_mode(), sr=sr,
                    launch=mel_spectrogram_cuda)
                smin, smax = masked_minmax(db_b, n_valid)
                mm = torch.stack([smin, smax]).cpu().numpy()  # one sync
        for b, id in enumerate(ids):
            st = _TrackState()
            # a plane of its own: a view would keep the group's storage
            # alive through a spill of this track
            st.spec_db = db_b[b].clone() if len(ids) > 1 else db_b[b]
            st.n_frames = n_frames[b]
            st.n_frames_pad = n_frames_pad
            st.n_out = int(db_b.shape[2])
            st.smin = float(mm[0, b])
            st.smax = float(mm[1, b])
            self._state[id] = st
        self._adopt_group_rows(ids, wave, win // 2)

    def _adopt_group_rows(self, ids, wave, half: int) -> None:
        """Make each track's row of its group's batch ``wave`` (which the
        route only reads) the track's envelope buffer, where the row holds
        the whole track at ``[half : half + n]``: the first waveform crop
        then ships nothing.  A row cut short (a hop over win / 2) leaves
        the track to ``_env_state_for``'s upload."""
        whole = [b for b, id in enumerate(ids)
                 if wave.shape[1] - half >= self.tracks[id].n_samples]
        if not whole:
            return
        with span("session.envelope", origin="adopted",
                  tracks=len(whole)) as sp:
            nbytes = 0
            for b in whole:
                # a row of its own, as for the plane: a view would keep
                # the group's storage alive through a spill of this track
                row = wave[b].clone() if len(ids) > 1 else wave[b]
                self._env_states[ids[b]] = _adopt_envelope(
                    self.tracks[ids[b]], row, half)
                nbytes += row.untyped_storage().nbytes()
            sp.set(bytes=nbytes)

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
        with self.timer.stage("add_tracks"):
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
                new = []
                for p, ch in zip(path_list, channels):
                    with span("decode.file", path=os.path.basename(p)):
                        new.append(AudioTrack(p, self.setting, channel=ch))
            with self.timer.stage("add_tracks.operands"):
                for id, track in zip(id_list, new):
                    self._ensure_sr_operands(track)
                    # a re-added id is a new file: drop the old envelope buffer
                    # and adaptive plane
                    self._env_states.pop(id, None)
                    self._drop_adaptive(id)
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
            for id in id_list:
                self._touch(id)  # newest tracks evict last
            with self.timer.stage("add_tracks.budget"):
                self._enforce_hbm_budget()
            with self.timer.stage("add_tracks.db_state"):
                return self._update_db_state()

    def remove_track(self, id: int) -> bool:
        """Remove a track (lib.rs:265-292)."""
        track = self._track(id)
        del self.tracks[id]
        self._state.pop(id, None)
        self._env_states.pop(id, None)
        self._drop_adaptive(id)
        with self._budget_lock:
            self._lru.pop(id, None)
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

    # ------------------------------------------ device-memory budget / LRU

    def _touch(self, id: int) -> None:
        with self._budget_lock:
            self._lru_clock += 1
            self._lru[id] = self._lru_clock

    def _track_device_bytes(self, id: int) -> int:
        """Device bytes held for one track, by storage: its dB plane, its
        envelope state and its adaptive plane."""
        total = 0
        st = self._state.get(id)
        if st is not None and isinstance(st.spec_db, torch.Tensor):
            total += st.spec_db.untyped_storage().nbytes()
        env = self._env_states.get(id)
        if env is not None:
            total += env.device_nbytes()
        with self._adaptive_lock:
            b = self._adaptive_db.get(id)
        if b is not None:
            with b.lock:
                if b.full is not None:
                    total += b.full.untyped_storage().nbytes()
        return total

    def hbm_stats(self) -> dict:
        """Device-memory accounting: the budget, the bytes held in all and
        per track, and the spill and re-upload counts."""
        per = {tid: self._track_device_bytes(tid) for tid in list(self.tracks)}
        with self._budget_lock:
            spills, reuploads = self._hbm_spills, self._hbm_reuploads
        return {
            "budget_bytes": self.hbm_budget_bytes,
            "resident_bytes": sum(per.values()),
            "per_track_bytes": per,
            "spills": spills,
            "reuploads": reuploads,
        }

    def _spill_track(self, id: int) -> None:
        """Move one track's dB plane to the host (bit-exact f32) and drop
        its rebuildable device buffers.  The next render re-uploads the
        same plane; the envelope and adaptive state rebuild lazily.  Runs
        under the budget lock."""
        st = self._state.get(id)
        if st is not None:
            with st.lock, self.timer.stage("residency.spill"):
                if isinstance(st.spec_db, torch.Tensor):
                    st.spec_db = st.spec_db.cpu().numpy()
        with self._env_lock:
            self._env_states.pop(id, None)
        self._drop_adaptive(id)
        self._hbm_spills += 1
        self._log.debug("device-memory budget: spilled track %d", id)

    def _enforce_hbm_budget(self, exclude=()) -> None:
        """Spill least-recently-used tracks until the device total fits the
        budget.  A render holding its own reference to a plane keeps it
        alive: a spill drops only the session's reference."""
        budget = self.hbm_budget_bytes
        if budget is None:
            return
        with self._budget_lock:
            per = {tid: self._track_device_bytes(tid)
                   for tid in list(self.tracks)}
            total = sum(per.values())
            if total <= budget:
                return
            order = sorted((tid for tid in per if tid not in exclude),
                           key=lambda t: self._lru.get(t, 0))
            for tid in order:
                if total <= budget:
                    break
                if per[tid] <= 0:
                    continue
                self._spill_track(tid)
                total -= per[tid]

    def _ensure_resident(self, id: int):
        """(state, plane): the track's state and its dB plane on the
        device, re-uploading a spilled plane (and making room by LRU).
        Renders use the returned plane, never ``state.spec_db``, which a
        concurrent spill may swap for a host array."""
        st = self._state[id]
        self._touch(id)
        with st.lock:
            plane = st.spec_db
            uploaded = not isinstance(plane, torch.Tensor)
            if uploaded:
                with self.timer.stage("residency.reupload"):
                    plane = torch.from_numpy(plane).to(self.device)
                st.spec_db = plane
        if uploaded:
            with self._budget_lock:
                self._hbm_reuploads += 1
            self._enforce_hbm_budget(exclude=(id,))
        return st, plane

    # ------------------------------------------------------------ renders

    def get_spec_db(self, id: int, wire: str | None = None) -> np.ndarray:
        """The dB spectrogram -> float32 (n_frames, n_out): n_out is n_mel
        on the mel scale, n_fft // 2 + 1 on the linear one.

        ``wire`` (default config.get_db_wire(), itself "f32" by default):
        "f32" fetches the plane exactly, and a spilled plane is served from
        the host without a re-upload.  "q16"/"q12"/"q10"/"q8" pack it on
        the device (``parallel/wirepack.py``: a b-bit grid on the track's
        [smin, smax], deltas along frames, a per-block bitpack), fetch the
        used words and decode them on the host, within
        0.5 * (smax - smin) / (2^b - 1) of the f32 plane; a spilled plane
        is made resident first (a counted re-upload, under the budget).
        """
        wire = wire or get_db_wire()
        check_db_wire(wire)
        self._track(id)  # raises TrackNotFoundError for unknown ids
        if wire == "f32":
            st = self._state[id]
            self._touch(id)
            with st.lock:
                plane = st.spec_db
            if isinstance(plane, torch.Tensor):  # a copy on the CPU as well
                return plane[: st.n_frames].to("cpu", copy=True).numpy()
            return plane[: st.n_frames].copy()
        st, plane = self._ensure_resident(id)
        bits = int(wire[1:])
        lo, hi = float(st.smin), float(st.smax)
        with self.timer.stage("get_spec_db.pack"):
            words, widths, nused = pack_spec(plane, lo, hi, bits=bits)
        with self.timer.stage("get_spec_db.fetch_unpack"):
            # chunked copies overlap the C block decode
            return fetch_unpack_spec_stream(
                words, widths, nused, st.n_frames, st.n_out,
                st.n_frames_pad, lo, hi, bits)

    def _run_render(self, plane, wv, wh, *, height, banded, wire):
        """Device render of a dB plane + host finalize for the image
        getters.

        wire="rgb": colormap applied on device to the f32 grey, 3 bytes/px
        fetched.  "grey8"/"grey16": fetch the quantized grey and paint RGB
        on the host via the matching LUT.
        """
        max_db, min_db = self.max_db, self.min_db
        if wire == "rgb":
            with self.timer.stage("render.device_d2h"):
                img = render_rgb(plane, max_db, min_db, wv, wh,
                                 height=height, banded=banded).cpu().numpy()
            # device output is channel-planar (3, H, W); interleave on host
            with self.timer.stage("render.host"):
                return np.ascontiguousarray(img.transpose(1, 2, 0))
        if wire not in ("grey8", "grey16"):
            raise ValueError(f"unknown image wire format: {wire!r}")
        bits = {"grey8": 8, "grey16": 16}[wire]
        with self.timer.stage("render.device_d2h"):
            q = render_grey_q(plane, max_db, min_db, wv, wh,
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
        st, plane = self._ensure_resident(id)
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
            out = self._run_render(plane, wv, wh, height=height,
                                   banded=banded,
                                   wire=wire or get_image_wire())
        self._enforce_hbm_budget(exclude=(id,))
        return out

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
        st, plane = self._ensure_resident(id)
        full_w, c0, c1 = _crop_cols(track, px_per_sec, start_sec, end_sec)
        if c1 <= c0 or nheight == 0:
            return np.zeros((nheight, 0, 3), dtype=np.uint8)
        _check_render_dims(c1 - c0, nheight, "get_spec_image_crop")
        height = grey_height(st.n_out, self._up_ratio(track.sr))
        wv = _dev_vertical_weights(height, nheight, self.device)
        wh = _dev_horizontal_weights_crop(st.n_frames, full_w, c0, c1,
                                          self.device)
        with self.timer.stage("get_spec_image.render"):
            out = self._run_render(plane, wv, wh, height=height, banded=True,
                                   wire=wire or get_image_wire())
        self._enforce_hbm_budget(exclude=(id,))
        return out

    # ------------------------------------------------------- adaptive renders

    def _drop_adaptive(self, id: int) -> None:
        """Invalidate a track's cached or in-flight adaptive plane: a build
        running when its track is replaced, removed or spilled, or the
        setting changes, stops at its next segment and never publishes."""
        with self._adaptive_lock:
            build = self._adaptive_db.pop(id, None)
        if build is not None:
            build.cancel.set()

    def _adaptive_full_db(self, id: int, track, n_mel: int, nf: int,
                          need_hi: int | None = None, block: bool = True):
        """The track's full adaptive plane (nf, n_mel) on the device, built
        in ADAPTIVE_CHUNK-frame segments of the slice-local form (each
        bit-equal to that slice of a whole-track computation, so cached
        renders stitch with slice-local ones) by a background thread.

        ``block=True`` waits for the build.  ``block=False`` returns at
        once: the built prefix when it covers ``need_hi`` frames (the
        render reads no frame past it), else raises
        :class:`AdaptiveBuildPending` with (built, total) progress.  A
        build's error is raised to the next caller, and the build dropped
        so that a later call retries.
        """
        with self._adaptive_lock:
            build = self._adaptive_db.get(id)
            if build is not None and build.n_mel != n_mel:
                build.cancel.set()  # basis changed: rebuild
                build = None
            if build is None:
                build = _AdaptiveBuild(n_mel, nf)
                self._adaptive_db[id] = build
                build.thread = threading.Thread(
                    target=self._adaptive_builder, name=f"adaptive-{id}",
                    args=(build, track, n_mel, nf), daemon=True,
                )
                build.thread.start()
        if block:
            build.done.wait()
        if build.error is not None:
            with self._adaptive_lock:
                if self._adaptive_db.get(id) is build:
                    del self._adaptive_db[id]
            raise build.error
        if build.full is not None:
            return build.full
        if block:
            # done, no error, no plane: a concurrent replace, remove, spill
            # or set_setting cancelled the build, and the caller's track or
            # setting is stale; nothing is pending
            raise MsvError(
                "adaptive full-dB build was invalidated by a concurrent "
                "session mutation; re-issue the render"
            )
        with build.lock:
            if build.full is not None:  # published since the check above
                return build.full
            built = build.built
            parts = list(build.parts)
        if need_hi is not None and built >= need_hi and parts:
            return parts[0] if len(parts) == 1 else torch.cat(parts, 0)
        raise AdaptiveBuildPending(built, nf)

    def adaptive_build_progress(self) -> dict:
        """Per-track progress of in-flight background adaptive builds:
        {id: {"built": frames, "total": frames}}; finished and absent
        tracks are left out."""
        out = {}
        with self._adaptive_lock:
            items = list(self._adaptive_db.items())
        for tid, b in items:
            if not b.done.is_set():
                out[tid] = {"built": b.built, "total": b.nf}
        return out

    def _adaptive_builder(self, build, track, n_mel, nf):
        """Background segment loop of one track's full adaptive plane.  On
        a card each segment is finished before it is published, so a
        prefix render on any stream reads finished rows."""
        on_card = self.device.type == "cuda"
        try:
            with self.timer.stage("adaptive.full_build"):
                for g0 in range(0, nf, self.ADAPTIVE_CHUNK):
                    if build.cancel.is_set():
                        return  # invalidated mid-build: no stale publish
                    g1 = min(nf, g0 + self.ADAPTIVE_CHUNK)
                    s0, s1 = range_sample_window(
                        track.n_samples, track.sr, self.setting, g0, g1
                    )
                    seg, scale = track.wav_slice_raw(s0, s1)
                    db, _ = multires_mel_spec_db_range(
                        seg, track.sr, g0, g1, setting=self.setting,
                        slice_start=s0, n_samples=track.n_samples,
                        n_mel=n_mel, scale=scale, device=self.device,
                    )
                    if on_card:
                        torch.cuda.current_stream(self.device).synchronize()
                    with build.lock:
                        build.parts.append(db)
                        build.built = g1
                full = (build.parts[0] if len(build.parts) == 1
                        else torch.cat(build.parts, 0))
                if on_card:
                    torch.cuda.current_stream(self.device).synchronize()
            with build.lock:
                if not build.cancel.is_set():
                    build.full = full
                # the segments are a second copy of the plane once `full`
                # exists: publish and clear at once, so a prefix reader
                # sees one or the other
                build.parts.clear()
        except Exception as e:  # raised to the next caller
            build.error = e
        finally:
            build.done.set()

    def get_adaptive_spec_image_crop(
        self,
        id: int,
        px_per_sec: float,
        nheight: int,
        start_sec: float,
        end_sec: float,
        n_mel: int | None = None,
        wire: str | None = None,
        block: bool = True,
    ) -> np.ndarray:
        """Adaptive multi-resolution viewport render (ops/multires.py):
        transients take their detail from short analysis windows,
        stationary harmonics from long ones.

        Column math mirrors :meth:`get_spec_image_crop`, so adjacent crops
        stitch pixel-exactly; frames are computed slice-locally
        (O(viewport), bit-equal to slicing a whole-track computation) and
        normalized with the session-global dB range.

        Zoomed out past ADAPTIVE_MAX_FRAMES of support, the render reads
        the per-track full plane built in the background: ``block=True``
        waits for the build; ``block=False`` serves from the built prefix
        when it covers this viewport, else raises
        :class:`AdaptiveBuildPending` with (built, total) progress.
        """
        track = self._track(id)
        self._touch(id)
        if n_mel is None:
            # shared-basis auto band count (empty low-frequency mel rows
            # at the smallest scale render as black banding otherwise)
            n_mel = adaptive_auto_n_mel(track.sr, self.setting)
        full_w, c0, c1 = _crop_cols(track, px_per_sec, start_sec, end_sec)
        if c1 <= c0 or nheight == 0:
            return np.zeros((nheight, 0, 3), dtype=np.uint8)
        _check_render_dims(c1 - c0, nheight, "get_adaptive_spec_image_crop")

        nf = adaptive_frame_count(track.n_samples, track.sr, self.setting)
        left, wb = resize_weights_range(nf, full_w, c0, c1)
        band = wb.shape[1]
        f_lo = int(left.min())
        # banded-apply width: every (left + band) read stays in-bounds
        f_need = int(left.max()) - f_lo + band
        if f_need > self.ADAPTIVE_MAX_FRAMES:
            # zoomed out past the slice-local budget: the full plane, read
            # at absolute frame indices; reads past its end clamp under
            # zero weights
            base = 0
            need_hi = min(nf, int(left.max()) + band)
            plane = self._adaptive_full_db(id, track, n_mel, nf,
                                           need_hi=need_hi, block=block)
        else:
            base = f_lo
            f_hi = min(nf, f_lo + f_need)
            s0, s1 = range_sample_window(
                track.n_samples, track.sr, self.setting, f_lo, f_hi
            )
            seg, scale = track.wav_slice_raw(s0, s1)
            with self.timer.stage("adaptive.spec"):
                plane, _ = multires_mel_spec_db_range(
                    seg, track.sr, f_lo, f_hi, setting=self.setting,
                    slice_start=s0, n_samples=track.n_samples, n_mel=n_mel,
                    scale=scale, device=self.device,
                )

        # the adaptive view is mel-scaled by construction, so cross-track
        # alignment uses the MEL ratio even in a linear-scale session
        f32 = np.float32
        up = float(
            hz_to_mel(f32(self.max_sr) / f32(2.0))
            / hz_to_mel(f32(track.sr) / f32(2.0))
        )
        height = grey_height(n_mel, up)
        wv = _dev_vertical_weights(height, nheight, self.device)
        wh = _dev_horizontal_weights_crop(nf, full_w, c0, c1, self.device,
                                          base=base)
        with self.timer.stage("adaptive.render"):
            out = self._run_render(plane, wv, wh, height=height, banded=True,
                                   wire=wire or get_image_wire())
        self._enforce_hbm_budget(exclude=(id,))
        return out

    # ------------------------------------------------------- waveform images

    def _env_state_for(self, id: int, track) -> EnvelopeState:
        """The track's envelope state: the device wave adopted at add time
        (a group's row or the streamed wave), else its wave shipped to the
        device now (integer carriers as they are: no f32 copy on the host),
        as after a spill or for a row cut short of the track."""
        self._touch(id)
        st = self._env_states.get(id)
        if st is None:
            # double-checked: two concurrent renders of a fresh track must
            # not both ship the wave
            with self._env_lock:
                st = self._env_states.get(id)
                if st is None:
                    with span("session.envelope", origin="upload",
                              tracks=1) as sp:
                        st = EnvelopeState(
                            None if track._wav_int is not None else track.wav,
                            track._wav_int, n=track.n_samples,
                            scale=track.scale, device=self.device)
                        sp.set(bytes=st.dev.untyped_storage().nbytes())
                    self._env_states[id] = st
            self._enforce_hbm_budget(exclude=(id,))
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
            out = wav_to_image(None, nwidth, nheight, (amp_min, amp_max),
                               state=st)
        self._enforce_hbm_budget(exclude=(id,))
        return out

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
            out = wav_to_image(None, nwidth, nheight, (amp_min, amp_max),
                               state=st, col_range=(c0, c1))
        self._enforce_hbm_budget(exclude=(id,))
        return out

    def get_grey(self, id: int) -> np.ndarray:
        """The normalized grey image (display.rs:44-54)."""
        track = self._track(id)
        st, plane = self._ensure_resident(id)
        height = grey_height(st.n_out, self._up_ratio(track.sr))
        g = spec_to_grey(plane, self.max_db, self.min_db, height=height)
        out = g[:, : st.n_frames].cpu().numpy()
        self._enforce_hbm_budget(exclude=(id,))
        return out

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
        states, adaptive planes (in-flight builds are cancelled) and
        operands.  Returns whether the dB range changed."""
        self.setting = setting
        ids = sorted(self.tracks)
        paths = [self.tracks[i].path for i in ids]
        chans = [self.tracks[i].channel for i in ids]
        self.tracks.clear()
        self._state.clear()
        self._env_states.clear()
        for tid in list(self._adaptive_db):
            self._drop_adaptive(tid)
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
    def load_session(cls, path: str, device="cuda",
                     hbm_budget_bytes: int | None = None) -> "MultiTrack":
        """A session on ``device`` (with ``hbm_budget_bytes``) from a v1 or
        v2 manifest of :meth:`save_session` (or of msv_tpu's)."""
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
        mt = cls(setting, device=device, hbm_budget_bytes=hbm_budget_bytes)
        ids = sorted(int(k) for k in m["tracks"])
        if ids:
            ent = [m["tracks"][str(i)] for i in ids]
            # v1: plain path strings; v2: {"path", "channel"} objects
            paths = [e if isinstance(e, str) else e["path"] for e in ent]
            chans = [None if isinstance(e, str) else e.get("channel")
                     for e in ent]
            mt.add_tracks(ids, paths, channels=chans)
        return mt
