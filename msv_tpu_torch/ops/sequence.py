"""Sequence decoding, ported from ``msv_tpu/ops/sequence.py``: Viterbi and
DTW on the device, backtraces on the host.

* **Viterbi** is a loop over time whose step is a max-plus "matvec",
  ``delta'[j] = max_i(delta[i] + logA[i, j]) + logB_t[j]``: one (S, S)
  broadcast add, ``argmax`` and ``amax`` over the source axis, one add.
  Ties go to the lowest source index (``torch.argmax`` returns the first
  maximum; ``torch.max(dim=)`` does not promise which).  The (T-1, S)
  back-pointer table stays on the device and crosses once for the O(T)
  host backtrace.  On the card the loop is launch-bound (four launches a
  step), so a block of ``GRAPH_BLOCK`` steps is captured into a CUDA graph
  once per (device, states, block) and replayed; the CPU runs the plain
  loop.  Both run the same kernels on the same operands, so they give the
  same path.  The viewer decodes from many request threads while others
  render: capture uses CUDA's thread-local mode (the other threads'
  allocations and copies stay legal while it is open) on a side stream,
  without ``torch.cuda.graph``'s device sync and cache flush, and one lock
  serialises every use of a graph's static buffers.  While a capture is
  open, PyTorch holds the card's default random generator for it, so no
  other thread may draw random numbers on the card then; the port draws
  none.

* **DTW** runs the textbook recurrence ``D[i,j] = C[i,j] + min(D[i-1,j],
  D[i,j-1], D[i-1,j-1])`` as an anti-diagonal wavefront: the cost is
  stored skewed, row k of ``E`` holding the cells i + j = k by row i, so
  each of the N + M - 1 diagonals is one contiguous row computed from the
  two before it in four elementwise launches.  msv_tpu scanned rows with a
  (min, +) associative scan inside each row; a row form here would take
  about three launches per doubling step, ``3 N log2 M`` in all, against
  the wavefront's ``4 (N + M - 1)`` (for 3 000 x 3 000 frames, 108 000
  against 24 000).  Each cell is one f32 add of one minimum, as in the
  numpy oracle; msv_tpu's tree sums along a row differ from it by f32
  rounding.  The backtrace walks the (N, M) matrix on the host.

msv_tpu padded states and both DTW axes to 128 (its compile cache); the
port runs the true sizes.  ``viterbi``, ``_pairwise_cost`` and
``smooth_f0_viterbi`` are copies of msv_tpu's host code (the last with a
``device``), pinned by tests/test_torch_host.py.
"""

import threading
from collections import OrderedDict

import numpy as np
import torch

from ..utils.device import as_f32, target_device

_NEG = -1e30  # "minus infinity" that stays finite under f32 adds
_BIG = 1e30
GRAPH_BLOCK = 256  # Viterbi steps per captured CUDA graph
GRAPH_CACHE = 8  # captured graphs kept, least recently used evicted
_GRAPHS = OrderedDict()  # (device, S, block) -> _GraphedBlock
_GRAPH_LOCK = threading.Lock()  # guards _GRAPHS and the static buffers


def _viterbi_step(delta, log_trans, obs_t, back_t, out):
    m = delta[:, None] + log_trans           # (S, S): i -> j
    torch.argmax(m, dim=0, out=back_t)
    torch.add(torch.amax(m, dim=0), obs_t, out=out)


def _viterbi_loop(delta, log_trans, log_obs, back, t0, t1):
    """Steps ``t0..t1-1`` (frames ``t0+1..t1``), ``delta`` in place."""
    for i in range(t0, t1):
        _viterbi_step(delta, log_trans, log_obs[i + 1], back[i], delta)


class _GraphedBlock:
    """``block`` Viterbi steps over S states, captured once: the graph
    reads ``trans`` and ``obs`` and steps ``delta`` in place, writing the
    block's back-pointers to ``back``."""

    def __init__(self, dev, s, block):
        self.delta = torch.zeros(s, device=dev)
        self.trans = torch.zeros((s, s), device=dev)
        self.obs = torch.zeros((block, s), device=dev)
        self.back = torch.zeros((block, s), dtype=torch.int64, device=dev)
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            # warm-up: the kernels load before capture
            _viterbi_step(self.delta, self.trans, self.obs[0], self.back[0],
                          self.delta)
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                for j in range(block):
                    _viterbi_step(self.delta, self.trans, self.obs[j],
                                  self.back[j], self.delta)
            finally:
                self.graph.capture_end()
        cur.wait_stream(side)


def _viterbi_graphed(delta, log_trans, log_obs, back):
    """The loop as replays of the cached GRAPH_BLOCK-step graph, the tail
    eagerly, all on the graph's static buffers under ``_GRAPH_LOCK``; the
    stream is drained before the lock is let go, so the next caller's
    copies into the buffers cannot overtake this call's reads."""
    steps, s = back.shape
    blk = GRAPH_BLOCK
    key = (delta.device, s, blk)
    with _GRAPH_LOCK:
        g = _GRAPHS.pop(key, None) or _GraphedBlock(delta.device, s, blk)
        _GRAPHS[key] = g
        while len(_GRAPHS) > GRAPH_CACHE:
            _GRAPHS.popitem(last=False)
        g.delta.copy_(delta)
        g.trans.copy_(log_trans)
        done = 0
        while steps - done >= blk:
            g.obs.copy_(log_obs[done + 1: done + 1 + blk])
            g.graph.replay()
            back[done: done + blk].copy_(g.back)
            done += blk
        _viterbi_loop(g.delta, g.trans, log_obs, back, done, steps)
        delta.copy_(g.delta)
        torch.cuda.current_stream(delta.device).synchronize()


def viterbi_log(log_obs, log_trans, log_init=None, *, device=None):
    """Most-likely state path: (T, S) frame log-likelihoods, (S, S)
    log-transitions (row = from), optional (S,) log-initial (uniform when
    None).  Returns ``(path (T,) int64 numpy, logp float)``.  ``log_obs``:
    numpy (to the card unless ``device`` says otherwise) or a tensor (on its
    own device).
    """
    dev = target_device(log_obs, device)
    t, s = tuple(np.shape(log_obs)) if np.ndim(log_obs) == 2 else (0, 0)
    if t < 1 or s < 2:
        raise ValueError(f"need (T >= 1, S >= 2) observations, got "
                         f"{tuple(np.shape(log_obs))}")
    log_trans = np.asarray(log_trans, np.float32)
    if log_trans.shape != (s, s):
        raise ValueError(
            f"log_trans must be ({s}, {s}), got {log_trans.shape}")
    if log_init is None:
        log_init = np.full(s, -np.log(s), np.float32)
    log_init = np.asarray(log_init, np.float32)
    if log_init.shape != (s,):
        raise ValueError(f"log_init must be ({s},), got {log_init.shape}")

    lo = as_f32(log_obs, dev)
    la = as_f32(np.maximum(log_trans, _NEG), dev)
    delta = as_f32(np.maximum(log_init, _NEG), dev) + lo[0]
    back = torch.empty((t - 1, s), dtype=torch.int64, device=dev)
    if dev.type == "cuda" and t - 1 >= GRAPH_BLOCK:
        _viterbi_graphed(delta, la, lo, back)
    else:
        _viterbi_loop(delta, la, lo, back, 0, t - 1)
    back = back.cpu().numpy()
    last = delta.cpu().numpy()
    path = np.empty(t, np.int64)
    path[-1] = int(np.argmax(last))
    for i in range(t - 2, -1, -1):  # host backtrace: O(T), sequential
        path[i] = back[i, path[i + 1]]
    return path, float(last[path[-1]])


def viterbi(prob, transition, p_init=None, *, device=None):
    """Probability-domain wrapper (librosa.sequence.viterbi-style):
    ``prob`` (T, S) observation likelihoods in [0, 1], ``transition``
    (S, S) row-stochastic.  Returns ``(path, logp)``."""
    prob = np.asarray(prob, np.float64)
    transition = np.asarray(transition, np.float64)
    if np.any(prob < 0) or np.any(prob > 1):
        raise ValueError("prob must be in [0, 1]")
    if np.any(transition < 0) or not np.allclose(
            transition.sum(axis=1), 1.0, atol=1e-6):
        raise ValueError("transition rows must be nonneg and sum to 1")
    with np.errstate(divide="ignore"):
        lo = np.log(prob)
        la = np.log(transition)
        li = None if p_init is None else np.log(
            np.asarray(p_init, np.float64))
    return viterbi_log(lo, la, li, device=device)


def _dtw_core(cost, *, subsequence):
    """(N, M) accumulated cost of the (N, M) ``cost`` tensor, by the
    anti-diagonal wavefront over the skewed ``E[k, i] = D[i, k - i]``."""
    n, m = cost.shape
    k_all = n + m - 1
    inf = float("inf")
    # the skewed cost: cs[k, i] = C[i, k - i], +inf off the grid
    rows = torch.arange(n, device=cost.device)
    ks = torch.arange(k_all, device=cost.device)[:, None]
    j = ks - rows[None, :]
    ok = (j >= 0) & (j < m)
    cs = torch.where(ok, cost[rows[None, :].expand_as(j),
                              j.clamp(0, m - 1)], inf)
    e = torch.full((k_all, n), inf, dtype=torch.float32, device=cost.device)
    e[0, 0] = cost[0, 0]
    tmp = torch.empty(max(n - 1, 0), dtype=torch.float32, device=cost.device)
    for k in range(1, k_all):
        # row 0: only the left move (free start along y: none)
        if subsequence:
            e[k, :1].copy_(cs[k, :1])
        else:
            torch.add(cs[k, :1], e[k - 1, :1], out=e[k, :1])
        if n > 1:
            # up D[i-1, j] = E[k-1, i-1]; left D[i, j-1] = E[k-1, i];
            # diagonal D[i-1, j-1] = E[k-2, i-1]
            torch.minimum(e[k - 1, :-1], e[k - 1, 1:], out=tmp)
            if k >= 2:
                torch.minimum(tmp, e[k - 2, :-1], out=tmp)
            torch.add(cs[k, 1:], tmp, out=e[k, 1:])
    # unskew: D[i, j] = E[i + j, i]
    jj = torch.arange(m, device=cost.device)
    return e[rows[:, None] + jj[None, :], rows[:, None]]


def dtw(x=None, y=None, *, cost=None, metric: str = "euclidean",
        subsequence: bool = False, device=None):
    """Dynamic time warping.

    Either ``x`` (N, D) and ``y`` (M, D) feature sequences (pairwise
    ``metric``: 'euclidean' or 'cosine' distance, in f64 on the host) or an
    explicit ``cost`` (N, M) matrix (numpy, to the card unless ``device``
    says otherwise, or a tensor on its own device).  Steps (1,1), (1,0),
    (0,1) with unit weights.  Returns ``(acc (N, M) numpy accumulated cost,
    path (L, 2) int64 row/col pairs, total float)``.

    ``subsequence=True`` lets the alignment start and end anywhere along
    ``y`` (free bottom row): ``total`` is then the minimum of the last row
    and the path starts at the matched offset.
    """
    if cost is None:
        if x is None or y is None:
            raise ValueError("need x and y, or cost=")
        if isinstance(x, torch.Tensor):
            device = device or x.device
            x = x.cpu().numpy()
        if isinstance(y, torch.Tensor):
            y = y.cpu().numpy()
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.float32)
        if x.ndim == 1:
            x = x[:, None]
        if y.ndim == 1:
            y = y[:, None]
        if x.ndim != 2 or y.ndim != 2 or x.shape[1] != y.shape[1]:
            raise ValueError(
                f"x, y must be (N, D), (M, D): got {x.shape}, {y.shape}")
        cost = _pairwise_cost(x, y, metric)
    else:
        if x is not None or y is not None:
            raise ValueError("pass x/y or cost=, not both")
        if np.ndim(cost) != 2:
            raise ValueError(f"cost must be 2-D, got {np.shape(cost)}")
    n, m = np.shape(cost)
    if n < 1 or m < 1:
        raise ValueError("empty sequences")
    acc = _dtw_core(as_f32(cost, target_device(cost, device)),
                    subsequence=bool(subsequence)).cpu().numpy()

    j_end = int(np.argmin(acc[-1])) if subsequence else m - 1
    path = [(n - 1, j_end)]
    i, j = n - 1, j_end
    while i > 0 or (j > 0 and not subsequence):  # host backtrace
        if i == 0:
            j -= 1
        elif j == 0:
            i -= 1
        else:
            moves = ((i - 1, j - 1), (i - 1, j), (i, j - 1))
            i, j = min(moves, key=lambda ij: acc[ij])
            path.append((i, j))
            continue
        path.append((i, j))
    path = np.asarray(path[::-1], np.int64)
    return acc, path, float(acc[n - 1, j_end])


def _pairwise_cost(x: np.ndarray, y: np.ndarray, metric: str):
    """(N, D) x (M, D) -> (N, M) distance, GEMM-shaped.

    f64 accumulation on host: identical rows must cost ~0 exactly so
    tie-breaks (identity alignments, embedded-copy subsequences) stay
    on the true path — f32 roundoff here would randomize them.
    """
    x = x.astype(np.float64)
    y = y.astype(np.float64)
    if metric == "euclidean":
        xx = (x * x).sum(axis=1)[:, None]
        yy = (y * y).sum(axis=1)[None, :]
        d2 = np.maximum(xx + yy - 2.0 * (x @ y.T), 0.0)
        return np.sqrt(d2).astype(np.float32)
    if metric == "cosine":
        xn = x / np.maximum(
            np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
        yn = y / np.maximum(
            np.linalg.norm(y, axis=1, keepdims=True), 1e-12)
        return (1.0 - xn @ yn.T).astype(np.float32)
    raise ValueError(f"unknown metric: {metric!r}")


# ---------------------------------------------------------------- pitch

def smooth_f0_viterbi(f0, aperiodicity, *, fmin: float = 65.0,
                      fmax: float = 2093.0, bins_per_semitone: int = 4,
                      obs_sigma_cents: float = 50.0,
                      trans_sigma_cents: float = 70.0,
                      switch_prob: float = 0.01,
                      voicing_slope: float = 2.0, device=None):
    """Viterbi-smoothed pitch contour (pYIN-style decoding over YIN).

    ``f0``/``aperiodicity``: per-frame outputs of
    :func:`msv_tpu.ops.pitch.yin` (``with_aperiodicity=True``).  Two
    decoupled Viterbi decodes (both max-plus device scans):

    * **voicing** — a sticky 2-state HMM on the per-frame voiced
      likelihood ``v_t = clip(1 - voicing_slope * ap_t)`` with
      ``switch_prob`` of toggling (hysteresis: isolated aperiodicity
      blips don't flip the mask);
    * **pitch** — states are a log-spaced grid (``bins_per_semitone``
      over [fmin, fmax]); observations are a Gaussian (width
      ``obs_sigma_cents``) around the YIN candidate mixed with a 5%
      uniform outlier floor, TEMPERED by ``v_t`` so unvoiced frames
      contribute ~nothing and the contour holds its last pitch through
      noise; transitions are Gaussian in cents (width
      ``trans_sigma_cents``).

    Decoupling matters: a joint model with ONE unvoiced state pays the
    pitch-transition spreading entropy (~2 nats/frame on a 25-cent
    grid) only on voiced self-loops, which silently biases every frame
    toward unvoiced (measured: a clean 220 Hz tone decoded fully
    unvoiced).  Returns ``(f0_smooth, voiced)`` — f0 snapped to the
    decoded grid (0 where unvoiced), bool voicing mask.  Octave
    glitches heal because a 12-semitone jump costs
    ``(1200 / trans_sigma_cents)^2 / 2`` nats while contradicting an
    isolated outlier frame costs only ~``log(n_bins / 0.05)``.
    """
    f0 = np.asarray(f0, np.float64).ravel()
    ap = np.asarray(aperiodicity, np.float64).ravel()
    if f0.shape != ap.shape:
        raise ValueError(f"f0/aperiodicity mismatch: {f0.shape} vs "
                         f"{ap.shape}")
    if not (0.0 < fmin < fmax):
        raise ValueError(f"need 0 < fmin < fmax, got {fmin}, {fmax}")
    if bins_per_semitone < 1:
        raise ValueError(
            f"bins_per_semitone must be >= 1, got {bins_per_semitone}")
    t = len(f0)
    if t == 0:
        return np.zeros(0, np.float32), np.zeros(0, bool)

    n_bins = int(np.ceil(12.0 * bins_per_semitone
                         * np.log2(fmax / fmin))) + 1
    cents = np.arange(n_bins) * (100.0 / bins_per_semitone)
    grid = fmin * 2.0 ** (cents / 1200.0)

    v = np.clip(1.0 - voicing_slope * ap, 1e-6, 1.0 - 1e-6)

    # voicing: sticky 2-state decode (state 1 = voiced)
    sp = float(np.clip(switch_prob, 1e-9, 0.5))
    v_obs = np.stack([np.log1p(-v), np.log(v)], axis=1)
    v_trans = np.log(np.array([[1.0 - sp, sp], [sp, 1.0 - sp]]))
    v_path, _ = viterbi_log(v_obs, v_trans, device=device)
    voiced = v_path > 0

    # pitch: Gaussian-plus-outlier observation, tempered by voicing
    # confidence.  Without the 5% floor a 2-frame octave error costs
    # (1200/obs_sigma)^2 nats per frame to override — more than the
    # jump itself — and glitches would never heal.
    obs_cents = 1200.0 * np.log2(np.maximum(f0, 1e-6) / fmin)
    z = (cents[None, :] - obs_cents[:, None]) / obs_sigma_cents
    p_outlier = 0.05
    log_obs = v[:, None] * np.log(
        (1.0 - p_outlier) * np.exp(-0.5 * z * z) + p_outlier / n_bins)

    dz = (cents[None, :] - cents[:, None]) / trans_sigma_cents
    tv = np.exp(-0.5 * dz * dz)
    tv /= tv.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore"):  # far tails: log(0), clamped
        log_tv = np.log(tv)
    path, _ = viterbi_log(log_obs, log_tv, device=device)
    out = np.where(voiced, grid[path], 0.0)
    return out.astype(np.float32), voiced


def yin_smoothed(wav, sr: int, *, fmin: float = 65.0,
                 fmax: float = 2093.0, device=None, **kw):
    """YIN + Viterbi decoding straight from audio: (T,) -> (f0, voiced)
    host arrays.

    Device GEMMs produce the per-frame YIN candidates
    (:func:`msv_tpu_torch.ops.pitch.yin`); the max-plus Viterbi loop
    decodes the contour.  Extra keywords split between the two stages
    (:func:`yin`: frame_length/win_length/hop_length/trough_threshold; the
    rest go to :func:`smooth_f0_viterbi`)."""
    from .pitch import yin

    yin_keys = ("frame_length", "win_length", "hop_length",
                "trough_threshold")
    yin_kw = {k: kw.pop(k) for k in list(kw) if k in yin_keys}
    f0, ap = yin(wav, sr, fmin=fmin, fmax=fmax, with_aperiodicity=True,
                 device=device, **yin_kw)
    return smooth_f0_viterbi(f0.cpu().numpy(), ap.cpu().numpy(),
                             fmin=fmin, fmax=fmax, device=f0.device, **kw)
