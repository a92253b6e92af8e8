"""The port's viewer under concurrent requests: the pitch (``smooth=1``)
and notes routes, whose Viterbi decodes replay CUDA graphs on the card,
answer from many threads while image crops render, and every answer
equals the one-at-a-time answer.  On the card the graph cache is emptied
first, so the captures happen among the renders.  No JAX here, so the
card case runs where the card is:
``python -m pytest --noconftest -m gpu tests/test_torch_*.py``."""

import concurrent.futures
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import msv_tpu_torch  # noqa: E402
import msv_tpu_torch.viewer as V  # noqa: E402
from msv_tpu_torch.io.audio import write_wav  # noqa: E402
from msv_tpu_torch.ops import sequence  # noqa: E402

SR = 16000


def _melody(path, seconds=20.0, seed=23):
    """Notes of a seeded random melody over a quiet noise floor: 625
    pitch frames, so each decode replays two graphed blocks and a tail."""
    rng = np.random.default_rng(seed)
    n = int(0.5 * SR)
    env = np.minimum(1.0, np.minimum(np.arange(n), np.arange(n)[::-1])
                     / (0.01 * SR))
    t = np.arange(n) / SR
    notes = [0.4 * env * np.sin(2 * np.pi * 440.0 * 2 ** ((m - 69) / 12) * t)
             for m in rng.integers(55, 80, int(seconds / 0.5))]
    x = np.concatenate(notes) + 0.002 * rng.standard_normal(len(notes) * n)
    write_wav(path, x.astype(np.float32)[None], SR)
    return path


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def served(request, tmp_path):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mt = msv_tpu_torch.MultiTrack(device=request.param)
    mt.add_tracks([0], [_melody(str(tmp_path / "m.wav"))])
    handler = type("H", (V._Handler,), {"session": mt, "lock": V._RWLock()})
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, kwargs={"poll_interval": 0.02},
                     daemon=True).start()
    yield request.param, f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        assert r.status == 200, url
        return r.read()


ANALYSIS = ["/api/pitch/0?start=0&end=20&smooth=1",
            "/api/pitch/0?start=1.5&end=19&smooth=1",
            "/api/notes/0?start=0&end=20",
            "/api/notes/0?start=2&end=18"]
IMAGES = [f"/api/{kind}/0?px_per_sec=60&height=80&start={a}&end={a + 4}"
          + ("&amp_min=-0.5&amp_max=0.5" if kind == "wav_crop" else "")
          for a in (0, 5, 11, 15)
          for kind in ("spec_crop", "wav_crop", "adaptive_crop")]


def test_pitch_and_notes_under_concurrent_renders_equal_one_at_a_time(
        served):
    dev, url = served
    # "&pass=" keeps each request's answer out of the other passes' cache
    want = {p: _get(url + p + "&pass=0") for p in ANALYSIS + IMAGES}
    if dev == "cuda":
        sequence._GRAPHS.clear()
    jobs = [(p, i) for i in (1, 2) for p in IMAGES + ANALYSIS]
    jobs = jobs[::2] + jobs[1::2]  # analysis among the renders
    with concurrent.futures.ThreadPoolExecutor(8) as ex:
        got = [(p, ex.submit(_get, f"{url}{p}&pass={i}")) for p, i in jobs]
        for p, f in got:
            assert f.result(timeout=300) == want[p], p
    if dev == "cuda":
        assert sequence._GRAPHS, "the decodes replayed no graph"
