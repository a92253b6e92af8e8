"""Min/max-envelope waveform renderer, ported from
``msv_tpu/render/envelope.py`` (reference: wav_to_image, display.rs:63-115).

Per output column i the reference takes min/max over samples in
[rust_round((i-1.5)*spp), rust_round((i+1.5)*spp)) where spp = len/nwidth,
paints a >= 3 px thick column of WAVECOLOR, and, when zoomed past
1 sample/px (spp < 1), first linearly upsamples by ceil(1/spp)
(display.rs:76-91 — including its quirk of indexing the upsampled buffer
with ORIGINAL-scale sample offsets; replicated bit-for-bit below).

The column windows are host-computed (start, end) int arrays (the numpy
helpers are verbatim copies of msv_tpu's); the device reduces min/max with
torch ops and returns each column's (top, bottom) rows, and the host paints
them.  Three exact reductions, as in msv_tpu:

  * direct: gather each column's window, _CHUNK columns at a time;
  * pooled: block min/max (block _BLOCK, cached per track), then each column
    combines its fully-covered blocks with two raw edge windows;
  * sparse table: two power-of-two levels built by doubling passes (cached
    per track), then two gathers per statistic and column.

Pixel rows are integers, so the port equals msv_tpu exactly.  Documented
deviations from the reference (robustness fixes, kept from msv_tpu):
  * empty windows (very deep zoom) would panic in Rust via
    ``wav_slice.max().unwrap()``; we clamp end >= start+1.
  * a sample equal to amp_min maps to row nheight and Rust's
    ``slice_mut(s![top..bottom+1])`` would panic; we clamp bottom to
    nheight-1.
"""

import collections
import threading

import numpy as np
import torch

from ..utils import next_pow2, round_up_to
from ..utils.rounding import rust_round_np
from .colormap import WAVECOLOR

_COL_BUCKET = 512
_CHUNK = 512
_BLOCK = 1024  # pooled-reduction block size
_DIRECT_LIMIT = 4096  # use direct gather when max window <= this
_WAV_BUCKET = 1 << 16
# Full-width column-window arrays are cached up to this many columns; any
# wider render computes its viewport's windows directly in O(viewport).
_COLW_FULL_LIMIT = 1 << 20
_FORCE_MODE = None  # test hook: "sparse" / "direct" pins the minmax path


def column_windows(i_px: np.ndarray, nwidth: int, n: int, buf_len: int):
    """±1.5·spp column windows (display.rs:92-97 semantics): window i
    spans [round((i-1.5)·spp), round((i+1.5)·spp)) clamped to
    [0, buf_len), rust round-half-away on f32 products.

    THE single source of the window math — EnvelopeState (full-width and
    viewport builds) and the sequence-sharded reducer
    (parallel/sharded.py::sharded_envelope_minmax) both call it, so
    their bit-for-bit parity cannot silently drift (review finding)."""
    f32 = np.float32
    samples_per_px = f32(n) / f32(nwidth)
    starts = rust_round_np((i_px - f32(1.5)) * samples_per_px)
    starts = np.maximum(starts, 0.0).astype(np.int64)
    ends = rust_round_np((i_px + f32(1.5)) * samples_per_px).astype(np.int64)
    ends = np.minimum(ends, buf_len)
    ends = np.maximum(ends, starts + 1)  # deviation: no empty-window panic
    return starts, ends


def _upsample_reference_quirk(wav: np.ndarray, factor: int) -> np.ndarray:
    """Linear upsample exactly like display.rs:76-91 (f32):
    out[i] = b * (i%f)/f + wav[i//f] * (1 - (i%f)/f),
    b = wav[i//f + 1] if in range else 0."""
    f32 = np.float32
    n = len(wav)
    i = np.arange(n * factor)
    j = i // factor
    r = (i % factor).astype(np.float32) / f32(factor)
    b = np.where(j + 1 < n, wav[np.minimum(j + 1, n - 1)], f32(0.0))
    return (b * r + wav[j] * (f32(1.0) - r)).astype(np.float32)


def _upsample_quirk_range(state, factor: int, s0: int, e1: int) -> np.ndarray:
    """Viewport-local form of :func:`_upsample_reference_quirk`: the
    upsampled-buffer values for indices [s0, e1) only, reading just the
    source samples those indices touch.  Elementwise-identical to slicing
    the full upsampled buffer (same f32 ops on the same values)."""
    f32 = np.float32
    n = state.n
    j0 = s0 // factor
    j1 = (e1 - 1) // factor
    wav = state.host_f32_range(j0, min(j1 + 2, n))
    i = np.arange(s0, e1)
    j = i // factor
    r = (i % factor).astype(np.float32) / f32(factor)
    jj = j - j0
    b = np.where(j + 1 < n, wav[np.minimum(jj + 1, len(wav) - 1)], f32(0.0))
    return (b * r + wav[jj] * (f32(1.0) - r)).astype(np.float32)


def _as_f32(wav, scale):
    """The device buffer as f32 samples: integer carriers times their
    exact power-of-two unit ``scale``."""
    if wav.dtype in (torch.int16, torch.int32):
        return wav.to(torch.float32) * scale
    return wav


def _sparse_query(lvl_max, lvl_min, pmx, pmn, starts, ends, k):
    """The 8-gather sparse-table lookup over prebuilt levels (level k in
    lvl_*, level k-1 in pm*)."""
    nbuf = pmx.shape[0]
    lens = ends - starts
    sel = (lens < (1 << k)) & (k > 0)  # use level k-1
    w = torch.where(sel, (1 << k) >> 1, 1 << k)
    lo = torch.clamp(starts, 0, nbuf - 1)
    hi = torch.clamp(ends - w, 0, nbuf - 1)
    a_max = torch.where(sel, pmx[lo], lvl_max[lo])
    b_max = torch.where(sel, pmx[hi], lvl_max[hi])
    a_min = torch.where(sel, pmn[lo], lvl_min[lo])
    b_min = torch.where(sel, pmn[hi], lvl_min[hi])
    return torch.maximum(a_max, b_max), torch.minimum(a_min, b_min)


def _build_sparse_levels(wav, scale, k, pad):
    """The two sparse-table levels (k and k-1) of ``wav``: level j holds the
    max / min of ``wav[i : i + 2^j]``, built by j doubling passes of
    pairwise max / min over a tail of ``pad`` (>= 2^(k-1)) -inf / +inf.
    Returns (level-k max, level-k min, level-(k-1) max, level-(k-1) min)."""
    wav = _as_f32(wav, scale)
    nbuf = wav.shape[0]
    mx = torch.cat([wav, wav.new_full((pad,), -float("inf"))])
    mn = torch.cat([wav, wav.new_full((pad,), float("inf"))])
    pmx = pmn = wav
    for j in range(k):
        if j == k - 1:  # snapshot level k-1 for the short columns
            pmx, pmn = mx[:nbuf].clone(), mn[:nbuf].clone()
        sh = 1 << j
        mx[:nbuf] = torch.maximum(mx[:nbuf], mx[sh : sh + nbuf])
        mn[:nbuf] = torch.minimum(mn[:nbuf], mn[sh : sh + nbuf])
    return mx[:nbuf], mn[:nbuf], pmx, pmn


def _chunked_window_minmax(wav, starts, ends, m):
    """Direct path: per-column (max, min) over [starts, ends), windows <=
    m, gathered _CHUNK columns at a time."""
    offs = torch.arange(m, device=wav.device)[None, :]
    mxs, mns = [], []
    for a in range(0, starts.shape[0], _CHUNK):
        s, e = starts[a : a + _CHUNK], ends[a : a + _CHUNK]
        idx = s[:, None] + offs
        valid = idx < e[:, None]
        g = wav[torch.clamp(idx, 0, wav.shape[0] - 1)]
        mxs.append(torch.where(valid, g, -float("inf")).amax(dim=1))
        mns.append(torch.where(valid, g, float("inf")).amin(dim=1))
    return torch.cat(mxs), torch.cat(mns)


def _block_minmax(wav, scale=2.0**-15):
    """Per-block min/max pyramid level (zoom-invariant; cached per track).

    ``scale`` is the integer-carrier unit for int16/int32 input (see
    io/audio.py open_audio_mono_ex); ignored for f32.
    """
    wav = _as_f32(wav, scale)
    nb = wav.shape[0] // _BLOCK
    blocks = wav[: nb * _BLOCK].reshape(nb, _BLOCK)
    return blocks.amax(dim=1), blocks.amin(dim=1)


def _pooled_window_minmax(wav, bmax, bmin, starts, ends, mp):
    """Pooled path: block min/max + raw edges.  Exact for any window size."""
    nb = bmax.shape[0]
    dev = wav.device
    offs = torch.arange(mp, device=dev)[None, :]
    eoffs = torch.arange(_BLOCK, device=dev)[None, :]
    last = wav.shape[0] - 1
    ninf, pinf = -float("inf"), float("inf")
    mxs, mns = [], []
    for a in range(0, starts.shape[0], _CHUNK):
        s, e = starts[a : a + _CHUNK], ends[a : a + _CHUNK]
        s_blk = -(-s // _BLOCK)  # ceil
        e_blk = e // _BLOCK  # floor
        bidx = s_blk[:, None] + offs
        bvalid = bidx < e_blk[:, None]
        bidx = torch.clamp(bidx, 0, nb - 1)
        # left edge: [start, min(s_blk*B, end)); right: [max(e_blk*B, start), end)
        lidx = s[:, None] + eoffs
        lvalid = lidx < torch.minimum(s_blk * _BLOCK, e)[:, None]
        ridx = torch.maximum(e_blk * _BLOCK, s)[:, None] + eoffs
        rvalid = ridx < e[:, None]
        gl = wav[torch.clamp(lidx, 0, last)]
        gr = wav[torch.clamp(ridx, 0, last)]
        mxs.append(torch.maximum(
            torch.where(bvalid, bmax[bidx], ninf).amax(dim=1),
            torch.maximum(torch.where(lvalid, gl, ninf).amax(dim=1),
                          torch.where(rvalid, gr, ninf).amax(dim=1))))
        mns.append(torch.minimum(
            torch.where(bvalid, bmin[bidx], pinf).amin(dim=1),
            torch.minimum(torch.where(lvalid, gl, pinf).amin(dim=1),
                          torch.where(rvalid, gr, pinf).amin(dim=1))))
    return torch.cat(mxs), torch.cat(mns)


class EnvelopeState:
    """Device-resident waveform + min/max pyramid for repeated envelope
    renders of one track (zoom / amp changes re-ship only index arrays,
    not the waveform).

    ``wav_f32``: host f32 signal (kept for the deep-zoom upsample branch);
    ``transfer_i16``: optional integer-carrier form (int16/int32) used as
    the narrow device transfer format; ``scale`` is its unit (values are
    identical after the exact on-device power-of-two scale).  ``device``
    defaults to the card.
    """

    def __init__(self, wav_f32, transfer_i16=None, n: int | None = None,
                 scale: float = 2.0**-15, device="cuda"):
        # ``wav_f32`` may be None for integer sources: the host f32 copy is
        # only needed by the rare deep-zoom upsample branch, and at hour
        # scale it is ~700 MB — materialize lazily via the property.
        self._wav_np = (
            np.ascontiguousarray(wav_f32, dtype=np.float32)
            if wav_f32 is not None
            else None
        )
        self._src_int = transfer_i16
        self.scale = float(scale)
        if self._wav_np is None and transfer_i16 is None:
            raise ValueError("EnvelopeState needs wav_f32 or transfer_i16")
        self.n = n if n is not None else len(
            transfer_i16 if transfer_i16 is not None else self._wav_np
        )
        src = transfer_i16 if transfer_i16 is not None else self._wav_np
        pad = round_up_to(max(self.n, _WAV_BUCKET), _WAV_BUCKET) - self.n
        self.dev = torch.from_numpy(
            np.pad(np.ascontiguousarray(src), (0, pad))).to(device)
        self.offset = 0  # device-buffer index of the file's sample 0
        # "upload": the wave was shipped here; "adopted": from_device
        self.origin = "upload"
        self._init_caches()

    def _init_caches(self):
        self._pooled = None
        self._col_cache = collections.OrderedDict()
        self._sparse_cache = collections.OrderedDict()  # (k, pad) -> levels
        self._dev_col_cache = collections.OrderedDict()  # key -> dev arrays
        # guards the LRUs + lazy pyramid + lazy host f32 under concurrent
        # viewer renders
        self._cache_lock = threading.Lock()

    @property
    def wav_np(self) -> np.ndarray:
        if self._wav_np is None:
            with self._cache_lock:
                if self._wav_np is None:
                    self._wav_np = self._src_int.astype(
                        np.float32
                    ) * np.float32(self.scale)
        return self._wav_np

    @classmethod
    def from_device(cls, dev, n: int, offset: int, src_int=None,
                    src_f32=None, scale: float = 2.0**-15):
        """Adopt an already-device-resident buffer (e.g. the streamed,
        reflect-padded waveform from streaming_spec_db(keep_wav=True),
        whose sample 0 sits at ``offset``) — the envelope then costs no
        second whole-file transfer.  ``src_int`` (integer carriers) or
        ``src_f32`` (true-float sources) feeds the host-f32 view for the
        deep-zoom upsample branch."""
        if src_int is None and src_f32 is None:
            raise ValueError("from_device needs src_int or src_f32")
        self = cls.__new__(cls)
        self._wav_np = (
            np.ascontiguousarray(src_f32, dtype=np.float32)
            if src_f32 is not None
            else None
        )
        self._src_int = src_int
        self.scale = float(scale)
        self.n = n
        self.dev = dev
        self.offset = int(offset)
        self.origin = "adopted"
        self._init_caches()
        return self

    def pooled(self):
        with self._cache_lock:
            if self._pooled is None:
                self._pooled = _block_minmax(self.dev, self.scale)
            return self._pooled

    def sparse_levels(self, k: int, pad: int):
        """Device-cached sparse-table levels for this track's buffer:
        re-renders pay only the 8 gathers per column.  Returns (bmax (2,
        nbuf), bmin (2, nbuf)) stacks of (level-k, level-(k-1)) max/min
        tables.  LRU of 2: a user bounces between a couple of zoom levels,
        and each level set costs 16 bytes/sample."""
        key = (int(k), int(pad))
        with self._cache_lock:
            hit = self._sparse_cache.get(key)
            if hit is not None:
                self._sparse_cache.move_to_end(key)
                return hit
        lmax, lmin, pmx, pmn = _build_sparse_levels(
            self.dev, self.scale, int(k), int(pad))
        packed = (torch.stack([lmax, pmx]), torch.stack([lmin, pmn]))
        with self._cache_lock:
            self._sparse_cache[key] = packed
            while len(self._sparse_cache) > 2:
                self._sparse_cache.popitem(last=False)
        return packed

    def dev_cols(self, key, starts_p, ends_p):
        """Device-resident column-window arrays, cached per render
        geometry: a same-zoom re-render (e.g. an amp change) then uploads
        only scalars instead of the per-column index arrays."""
        with self._cache_lock:
            hit = self._dev_col_cache.get(key)
            if hit is not None:
                self._dev_col_cache.move_to_end(key)
                return hit
        dev_pair = _dev_index(starts_p, self.dev.device), _dev_index(
            ends_p, self.dev.device)
        with self._cache_lock:
            self._dev_col_cache[key] = dev_pair
            while len(self._dev_col_cache) > 8:
                self._dev_col_cache.popitem(last=False)
        return dev_pair

    def col_windows(self, nwidth: int, buf_len: int):
        """Full-width per-column sample windows for one zoom level,
        cached.  Any viewport crop is a cheap slice of the full-width
        arrays.  Small LRU: a user bounces between a handful of zoom
        levels."""
        key = (nwidth, buf_len)
        with self._cache_lock:
            hit = self._col_cache.get(key)
            if hit is not None:
                self._col_cache.move_to_end(key)
                return hit
        starts, ends = column_windows(
            np.arange(nwidth, dtype=np.float32), nwidth, self.n, buf_len
        )
        with self._cache_lock:
            self._col_cache[key] = (starts, ends)
            while len(self._col_cache) > 6:
                self._col_cache.popitem(last=False)
        return starts, ends

    def col_windows_range(self, nwidth: int, buf_len: int, c0: int, c1: int):
        """Windows for columns [c0, c1) only.  Uses the cached full-width
        arrays for moderate widths (pan reuse); above _COLW_FULL_LIMIT it
        computes the range directly so a viewport render of an extreme
        zoom level allocates O(viewport), never O(full width)."""
        if nwidth <= _COLW_FULL_LIMIT:
            starts, ends = self.col_windows(nwidth, buf_len)
            return starts[c0:c1], ends[c0:c1]
        # same value stream as arange(nwidth, f32)[c0:c1]: exact f32 ints
        # below 2^24, identically rounded above
        i_px = np.arange(c0, c1, dtype=np.int64).astype(np.float32)
        return column_windows(i_px, nwidth, self.n, buf_len)

    def host_f32_range(self, a: int, b: int) -> np.ndarray:
        """Host f32 mono samples [a, b) WITHOUT materializing the full
        track (the deep-zoom branch at hour scale would otherwise convert
        ~700 MB for a 1200-px viewport)."""
        if self._wav_np is not None:
            return self._wav_np[a:b]
        return self._src_int[a:b].astype(np.float32) * np.float32(self.scale)


def _dev_index(a: np.ndarray, device):
    return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)


def _envelope_rows(mx, mn, amp_min, amp_max, nheight: int):
    """Per-column (top, bottom) int32 rows of the >= 3 px envelope band
    from the window (max, min).

    amp -> row: rust_round((amp_max - x) * nheight / range) as isize.  The
    f32 association must be ((amp_max - x) * nheight) / range exactly as
    display.rs:71-72 writes it — a precomputed nheight/range scale can land
    on the other side of a .5 rounding tie and shift a column 1 px."""
    f32 = dict(dtype=torch.float32, device=mx.device)
    a_max = torch.tensor(float(amp_max), **f32)
    a_min = torch.tensor(float(amp_min), **f32)
    rng = a_max - a_min
    nh = torch.tensor(float(nheight), **f32)

    def to_px(x):
        v = (a_max - x) * nh / rng
        r = torch.where(v >= 0, torch.floor(v + 0.5), torch.ceil(v - 0.5))
        # a saturating f32 -> int32 cast, then int32 arithmetic that wraps,
        # as msv_tpu's: extreme amp zooms land on the same rows
        return torch.clamp(r.double(), -2.0**31, 2.0**31 - 1).to(
            torch.int64).to(torch.int32)

    top = to_px(mx)
    bottom = to_px(mn)
    d = 3 - (bottom - top)
    pad_top = torch.where(d > 0, d // 2, 0)  # floor(d/2)  (display.rs:102)
    pad_bottom = torch.where(d > 0, (d + 1) // 2, 0)  # ceil(d/2)  (:101)
    top = torch.clamp(top - pad_top, min=0)
    bottom = torch.clamp(bottom + pad_bottom, max=nheight - 1)
    # the image IS (top, bottom): each column is a solid WAVECOLOR band
    # (display.rs:98-110), so only 8 bytes/column cross to the host and
    # the paint runs there.  The extra clamps cannot change the painted
    # mask but bound the off-screen values of extreme amp zooms.
    return torch.clamp(top, -1, nheight), torch.clamp(bottom, -1, nheight)


def wav_to_image(
    wav,
    nwidth: int,
    nheight: int,
    amp_range,
    state: EnvelopeState | None = None,
    col_range: tuple | None = None,
    device="cuda",
) -> np.ndarray:
    """Render the waveform envelope -> (nheight, nwidth, 4) RGBA u8.

    Pass a cached :class:`EnvelopeState` (the session keeps one per track)
    to avoid re-shipping the waveform on every zoom/amp change; without
    one, ``wav`` is shipped to ``device``.  ``col_range=(c0, c1)`` renders
    only those output columns of the full-width image (viewport crop;
    pixel-identical to slicing).
    """
    f32 = np.float32
    amp_min, amp_max = f32(amp_range[0]), f32(amp_range[1])
    if state is None:
        state = EnvelopeState(np.ascontiguousarray(wav, dtype=np.float32),
                              device=device)
    n = state.n
    if nwidth <= 0 or nheight <= 0:
        return np.zeros((max(nheight, 0), max(nwidth, 0), 4), dtype=np.uint8)

    samples_per_px = f32(n) / f32(nwidth)
    offset = state.offset

    c0, c1 = (0, nwidth) if col_range is None else col_range
    c0, c1 = max(0, int(c0)), min(nwidth, int(c1))
    out_cols = max(c1 - c0, 0)
    if out_cols == 0:
        return np.zeros((nheight, 0, 4), dtype=np.uint8)

    if samples_per_px < 1.0:
        # deep zoom: render from the quirky upsampled buffer
        factor = int(np.ceil(f32(1.0) / samples_per_px))
        buf_len = n * factor  # logical upsampled length (windows clip here)
        starts, ends = state.col_windows_range(nwidth, buf_len, c0, c1)
        if col_range is None:
            # full-width deep zoom of a short track: small ephemeral buffer
            buf_np = _upsample_reference_quirk(state.wav_np, factor)
            offset = 0
        else:
            # viewport-local: upsample ONLY the sample range the windows
            # [s0, e1) read — O(viewport) work and allocation even for
            # hour-scale tracks, and no full-track f32 materialization
            # for integer carriers
            s0, e1 = int(starts[0]), int(ends[-1])
            buf_np = _upsample_quirk_range(state, factor, s0, e1)
            offset = -s0
        blen = len(buf_np)
        pad_len = round_up_to(max(blen, _WAV_BUCKET), _WAV_BUCKET) - blen
        dev = torch.from_numpy(np.pad(buf_np, (0, pad_len))).to(
            state.dev.device)
    else:
        buf_len = n
        dev = state.dev
        starts, ends = state.col_windows_range(nwidth, buf_len, c0, c1)

    n_cols = round_up_to(out_cols, _COL_BUCKET)
    starts_p = np.zeros(n_cols, dtype=np.int32)
    ends_p = np.zeros(n_cols, dtype=np.int32)
    # `offset` shifts file-coordinate windows into device-buffer
    # coordinates (nonzero when the buffer is the reflect-padded waveform
    # adopted from the streaming pipeline)
    starts_p[:out_cols] = starts + offset
    ends_p[:out_cols] = ends + offset
    ends_p[out_cols:] = 1  # dummy non-empty windows for the padded tail

    lens = ends - starts
    max_win = int(lens.max())
    min_win = int(lens.min())
    # sparse-table eligibility: smallest k with 2^(k+1) >= max_win; the
    # two kept levels then cover lengths in [2^(k-1), 2^(k+1)] — true for
    # any single render (interior ~3*spp, clipped edges >= ~1.5*spp)
    k_sparse = max((max_win - 1).bit_length() - 1, 0)
    sparse_ok = min_win >= (1 << k_sparse) // 2 and min_win >= 1
    # cost: direct gathers n_cols*m elements; the sparse build streams
    # ~4k passes over the buffer and then gathers 8 per column
    m_direct = int(round_up_to(max(max_win, 1), 128))
    # sparse only in the small-window / many-column regime: its build
    # streams the WHOLE buffer, so for max_win > _DIRECT_LIMIT the pooled
    # path's per-track CACHED pyramid stays the cheaper engine
    use_sparse = (
        sparse_ok
        and max_win <= _DIRECT_LIMIT
        and n_cols * m_direct > dev.shape[0]
    )
    if _FORCE_MODE is not None:  # test hook: pin one path for A/B parity
        use_sparse = (_FORCE_MODE == "sparse" and sparse_ok
                      and max_win <= _DIRECT_LIMIT)

    if dev is state.dev:
        # device col-window cache: an amp-only re-render uploads scalars,
        # not the per-column index arrays
        col_key = (nwidth, buf_len, c0, c1, offset, n_cols)
        starts_d, ends_d = state.dev_cols(col_key, starts_p, ends_p)
    else:
        starts_d = _dev_index(starts_p, dev.device)
        ends_d = _dev_index(ends_p, dev.device)
    if use_sparse:
        # build pad >= max window, power-of-two bucketed
        m = int(next_pow2(max(max_win, 128)))
        if dev is state.dev:
            # per-track device-cached levels: re-renders skip the build
            bmax, bmin = state.sparse_levels(k_sparse, m)
            mx, mn = _sparse_query(bmax[0], bmin[0], bmax[1], bmin[1],
                                   starts_d, ends_d, k_sparse)
        else:
            mx, mn = _sparse_query(*_build_sparse_levels(
                dev, state.scale, k_sparse, m), starts_d, ends_d, k_sparse)
    elif max_win <= _DIRECT_LIMIT:
        mx, mn = _chunked_window_minmax(_as_f32(dev, state.scale), starts_d,
                                        ends_d, m_direct)
    else:
        m = int(round_up_to(max_win // _BLOCK + 2, 8))
        bmax, bmin = (_block_minmax(dev) if samples_per_px < 1.0
                      else state.pooled())
        mx, mn = _pooled_window_minmax(_as_f32(dev, state.scale), bmax, bmin,
                                       starts_d, ends_d, m)

    top, bottom = _envelope_rows(mx, mn, amp_min, amp_max, int(nheight))
    tb = torch.stack([top, bottom]).cpu().numpy()  # one fetch round trip
    return _paint_envelope(tb[0, :out_cols], tb[1, :out_cols], int(nheight))


# Paint chunk: <= 2M px per mask (~2 MB bool + ~8 MB RGBA intermediate),
# so a wide render's transient allocation beyond the output array itself
# is bounded regardless of width.
_PAINT_CHUNK_PX = 1 << 21


def _paint_envelope(top: np.ndarray, bottom: np.ndarray,
                    nheight: int) -> np.ndarray:
    """Host RGBA paint of per-column (top, bottom) rows, in bounded
    column chunks.  Pixel-identical to the one-shot
    ``np.where((rows >= top) & (rows <= bottom), WAVECOLOR, 0)``."""
    out_cols = top.shape[0]
    out = np.zeros((nheight, out_cols, 4), dtype=np.uint8)
    rows = np.arange(nheight, dtype=np.int32)[:, None]  # (H, 1)
    step = max(1, _PAINT_CHUNK_PX // max(nheight, 1))
    for a in range(0, out_cols, step):
        b = min(out_cols, a + step)
        mask = (rows >= top[None, a:b]) & (rows <= bottom[None, a:b])
        out[:, a:b][mask] = WAVECOLOR
    return out
