"""The port's Viterbi and DTW (``msv_tpu_torch/ops/sequence.py``, on the
CPU) against ``msv_tpu/ops/sequence.py`` and tests/test_sequence.py's DP
oracles.

Tolerances are tests/test_sequence.py's: Viterbi paths equal and logp
within rtol 1e-4, atol 1e-3 (:63); DTW accumulated cost within rtol 1e-5,
atol 1e-5 (:113) and rtol 1e-4, atol 1e-4 in the subsequence mode (:155),
paths equal.  ``smooth_f0_viterbi`` and ``yin_smoothed`` give msv_tpu's f0
and voicing exactly on the tone and glitch fixtures.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from msv_tpu_torch.ops import sequence as T  # noqa: E402

try:
    from msv_tpu.ops import sequence as J
    from test_sequence import _oracle_dtw, _oracle_viterbi
except ImportError:  # no jax
    J = None

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _reference(request):
    """The JAX reference is absent where the card-only tests run."""
    if J is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference (msv_tpu) is not installed")


def _hmm(rng, t, s):
    log_obs = rng.standard_normal((t, s)).astype(np.float32) * 2.0
    a = rng.random((s, s)) + 0.05
    a /= a.sum(axis=1, keepdims=True)
    return log_obs, np.log(a).astype(np.float32)


@pytest.mark.parametrize("t,s", [(1, 3), (7, 2), (40, 5), (300, 131)])
def test_viterbi_matches_jax_and_the_oracle(rng, t, s):
    log_obs, log_trans = _hmm(rng, t, s)
    log_init = np.log(np.full(s, 1.0 / s, np.float32))
    path, logp = T.viterbi_log(log_obs, log_trans, log_init, **CPU)
    jpath, jlogp = J.viterbi_log(log_obs, log_trans, log_init)
    assert path.dtype == np.int64
    np.testing.assert_array_equal(path, jpath)
    np.testing.assert_allclose(logp, jlogp, rtol=1e-4, atol=1e-3)
    want_path, want_logp = _oracle_viterbi(
        log_obs.astype(np.float64), log_trans.astype(np.float64),
        log_init.astype(np.float64))
    np.testing.assert_array_equal(path, want_path)
    np.testing.assert_allclose(logp, want_logp, rtol=1e-4, atol=1e-3)


def test_viterbi_ties_go_to_the_first_state(rng):
    """Equal rows, a log(0) clamped to -1e30 and duplicated observation
    columns: every step has ties, which msv_tpu's argmax breaks to the
    lowest index."""
    s = 7
    a = np.full((s, s), 1.0 / s)
    a[:, 3] = 0.0
    a /= a.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore"):
        log_trans = np.log(a)
    log_obs = np.repeat(rng.standard_normal((60, 1)), s, axis=1)
    log_obs[::5, 4:] += 1.0
    log_obs = log_obs.astype(np.float32)
    path, logp = T.viterbi_log(log_obs, log_trans, **CPU)
    jpath, jlogp = J.viterbi_log(log_obs, log_trans)
    np.testing.assert_array_equal(path, jpath)
    assert logp == pytest.approx(jlogp, rel=1e-4, abs=1e-3)
    assert 3 not in path and path[1] == 0


def test_viterbi_probability_domain_and_validation():
    true = np.repeat([0, 1, 0], [30, 40, 30])
    p = np.where(np.arange(100) % 17 == 5, 0.2, 0.9)
    prob = np.stack([np.where(true == 0, p, 1 - p),
                     np.where(true == 1, p, 1 - p)], axis=1)
    trans = np.array([[0.99, 0.01], [0.01, 0.99]])
    path, logp = T.viterbi(prob, trans, **CPU)
    np.testing.assert_array_equal(path, J.viterbi(prob, trans)[0])
    np.testing.assert_array_equal(path, true)
    for args in ((np.zeros((0, 3), np.float32), np.zeros((3, 3))),
                 (np.zeros((5, 3), np.float32), np.zeros((2, 2))),
                 (np.zeros((5, 3), np.float32), np.zeros((3, 3)),
                  np.zeros(2))):
        with pytest.raises(ValueError):
            T.viterbi_log(*args, **CPU)
    with pytest.raises(ValueError, match="prob"):
        T.viterbi(np.full((4, 2), 1.5), np.eye(2), **CPU)
    with pytest.raises(ValueError, match="transition"):
        T.viterbi(np.full((4, 2), 0.5), np.full((2, 2), 0.9), **CPU)


@pytest.mark.parametrize("n,m", [(1, 1), (5, 9), (64, 40), (130, 260)])
@pytest.mark.parametrize("subsequence", [False, True])
def test_dtw_matches_jax_and_the_oracle(rng, n, m, subsequence):
    cost = rng.random((n, m)).astype(np.float32)
    acc, path, total = T.dtw(cost=cost, subsequence=subsequence, **CPU)
    jacc, jpath, jtotal = J.dtw(cost=cost, subsequence=subsequence)
    tol = 1e-4 if subsequence else 1e-5
    want = _oracle_dtw(cost.astype(np.float64), subsequence=subsequence)
    assert acc.dtype == np.float32 and acc.shape == (n, m)
    np.testing.assert_allclose(acc, want, rtol=tol, atol=tol)
    np.testing.assert_allclose(acc, jacc, rtol=tol, atol=tol)
    np.testing.assert_array_equal(path, jpath)
    assert total == pytest.approx(jtotal, rel=tol, abs=tol)


def test_dtw_features_metrics_and_subsequence(rng):
    x = rng.standard_normal((50, 4)).astype(np.float32)
    _, path, total = T.dtw(x, x, **CPU)
    assert total == pytest.approx(0.0, abs=1e-4)
    np.testing.assert_array_equal(path[:, 0], path[:, 1])
    a = np.linspace(0, 1, 40, dtype=np.float32)
    b = np.linspace(0, 1, 80, dtype=np.float32)
    _, path, _ = T.dtw(a, b, **CPU)
    np.testing.assert_array_equal(path, J.dtw(a, b)[1])
    xs = rng.standard_normal((30, 3)).astype(np.float32)
    pad = rng.standard_normal((25, 3)).astype(np.float32) + 5.0
    y = np.concatenate([pad, xs, pad + 2.0])
    acc, path, total = T.dtw(torch.from_numpy(xs), y, subsequence=True)
    jacc, jpath, _ = J.dtw(xs, y, subsequence=True)
    np.testing.assert_allclose(acc, jacc, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(path, jpath)
    assert total < 1e-3 and tuple(path[0]) == (0, 25)
    c = rng.standard_normal((10, 8)).astype(np.float32)
    assert T.dtw(c, c, metric="cosine", **CPU)[2] == pytest.approx(
        0.0, abs=1e-5)


def test_dtw_validation():
    with pytest.raises(ValueError):
        T.dtw(**CPU)
    with pytest.raises(ValueError):
        T.dtw(np.ones((3, 2)), np.ones((3, 3)), **CPU)
    with pytest.raises(ValueError):
        T.dtw(np.ones((3, 2)), np.ones((3, 2)), cost=np.ones((3, 3)), **CPU)
    with pytest.raises(ValueError, match="metric"):
        T.dtw(np.ones((3, 2)), np.ones((3, 2)), metric="manhattan", **CPU)
    with pytest.raises(ValueError):
        T.dtw(cost=np.ones((0, 4)), **CPU)


def _glitch():
    f0 = np.full(80, 220.0, np.float32)
    f0[[10, 11, 37]] = 440.0  # octave errors
    f0[45] = 110.0
    ap = np.full(80, 0.05, np.float32)
    ap[55:70] = 0.9  # an aperiodic stretch
    return f0, ap


def test_smooth_f0_equals_jax():
    f0, ap = _glitch()
    out, voiced = T.smooth_f0_viterbi(f0, ap, **CPU)
    jout, jvoiced = J.smooth_f0_viterbi(f0, ap)
    np.testing.assert_array_equal(out, jout)
    np.testing.assert_array_equal(voiced, jvoiced)
    assert out.dtype == np.float32 and voiced.dtype == bool
    assert not voiced[55:70].any() and voiced[:55].all()
    t = np.arange(200)
    vib = (220.0 * 2.0 ** (0.5 * np.sin(2 * np.pi * t / 50.0) / 12.0)
           ).astype(np.float32)
    ap = np.full(200, 0.05, np.float32)
    for got, want in zip(T.smooth_f0_viterbi(vib, ap, **CPU),
                         J.smooth_f0_viterbi(vib, ap)):
        np.testing.assert_array_equal(got, want)
    out, voiced = T.smooth_f0_viterbi(np.zeros(0), np.zeros(0), **CPU)
    assert out.shape == voiced.shape == (0,)
    with pytest.raises(ValueError):
        T.smooth_f0_viterbi(np.ones(5), np.ones(4), **CPU)


def test_yin_smoothed_equals_jax():
    sr = 16000
    tt = np.arange(sr) / sr
    wav = (0.5 * np.sin(2 * np.pi * 220.0 * tt)).astype(np.float32)
    wav[: sr // 8] = 0.0  # leading silence
    f0, voiced = T.yin_smoothed(wav, sr, fmin=80.0, fmax=1000.0, **CPU)
    jf0, jvoiced = J.yin_smoothed(wav, sr, fmin=80.0, fmax=1000.0)
    np.testing.assert_array_equal(f0, jf0)
    np.testing.assert_array_equal(voiced, jvoiced)
    mid = voiced & (np.arange(len(f0)) > len(f0) // 4)
    np.testing.assert_allclose(f0[mid], 220.0, rtol=0.02)


def _graphed_against_plain(log_obs, log_trans):
    path, logp = T.viterbi_log(log_obs, log_trans)  # the card: graphed
    want, wlogp = T.viterbi_log(log_obs, log_trans, **CPU)
    np.testing.assert_array_equal(path, want)
    assert logp == pytest.approx(wlogp, rel=1e-5, abs=1e-3)


@pytest.mark.gpu
def test_viterbi_and_dtw_on_the_card_match_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(4)
    # 3 captured blocks and an eager tail, with ties (a clamped log(0))
    log_obs, log_trans = _hmm(rng, 3 * T.GRAPH_BLOCK + 37, 242)
    log_trans[:, 5] = -np.inf
    _graphed_against_plain(log_obs, log_trans)
    cost = rng.random((300, 170)).astype(np.float32)
    for sub in (False, True):
        acc, path, _ = T.dtw(cost=cost, subsequence=sub)
        cacc, cpath, _ = T.dtw(cost=cost, subsequence=sub, **CPU)
        np.testing.assert_allclose(acc, cacc, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(path, cpath)


@pytest.mark.gpu
def test_graphed_viterbi_from_many_threads_equals_one_at_a_time():
    """Decodes of three state counts from six threads while two more
    allocate, compute and copy to the host on the card, as the viewer's
    renders do (drawing no random numbers: a capture holds the card's
    default generator), with the graph cache emptied first so that the
    captures happen among them: every path and logp equals the
    one-at-a-time decode's."""
    import concurrent.futures
    import threading

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(8)
    cases = [_hmm(rng, 2 * T.GRAPH_BLOCK + 11, s) for s in (242, 2, 57)]
    want = [T.viterbi_log(o, a) for o, a in cases]
    T._GRAPHS.clear()
    stop = threading.Event()

    def churn():
        n = 0
        while not stop.is_set():
            x = torch.arange(1 << 20, dtype=torch.float32, device="cuda")
            n += int(x.sin().argmax().cpu())
            torch.cuda.current_stream().synchronize()
        return n

    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        churners = [ex.submit(churn) for _ in range(2)]
        got = [ex.submit(T.viterbi_log, o, a) for o, a in cases * 4]
        results = [f.result(timeout=300) for f in got]
        stop.set()
        for f in churners:
            f.result(timeout=60)
    for (path, logp), (wpath, wlogp) in zip(results, want * 4):
        np.testing.assert_array_equal(path, wpath)
        assert logp == wlogp
    assert len(T._GRAPHS) == 3
