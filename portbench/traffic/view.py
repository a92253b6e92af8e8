"""Browsing an open session in the viewer: one page as a client in a
process of its own, a closed loop over at most ``connections`` connections
to the viewer's HTTP server (``msv_tpu_torch.viewer``'s handler on a
loopback port, in the run's process).

A gesture moves the view (a scroll, a zoom about the view's centre, or a
jump); then for every track the page does what its ``fetchView`` does.  A
scroll or a jump whose visible columns lie inside the columns the track's
images already cover sends nothing; otherwise, and always after a zoom,
the page sends the visible spectrogram and waveform crops, each followed,
once it has landed, by the crop widened by one viewport on each side.  A
track's images cover the widened columns once both wide crops have
landed, and nothing after a failed request.  A client LRU of
``client_lru`` URLs (the page's ``IMG_CACHE_MAX``) drops exact repeats.
The next gesture starts when every image of the last one has landed.

Gestures come in blocks with a fixed make-up (``block``): every seed gets
the same counts of scrolls, zooms and jumps, the same scroll sizes and
every zoom level once a block, in its own order and at its own
positions."""

import gc
import http.client
import queue
import threading
import time
from collections import OrderedDict

import numpy as np


def js_num(x) -> str:
    """A number as JavaScript prints it in a template string."""
    x = float(x)
    return str(int(x)) if x == int(x) else repr(x)


def total_px(pps, sec) -> int:
    return int(pps * sec)


def gestures(seed: int, p: dict, max_sec: float):
    """Endless (kind, pps, scroll_px) stream, deterministic by seed."""
    rng = np.random.default_rng([int(seed), 1])
    view = p["view_px"]
    pps, scroll = p["start_pps"], 0
    while True:
        kinds = [k for k, n in p["block"].items() for _ in range(n)]
        rng.shuffle(kinds)
        sizes = list(p["scroll_viewports"]) * -(-kinds.count("scroll")
                                               // len(p["scroll_viewports"]))
        rng.shuffle(sizes)
        zooms = list(rng.permutation(p["zooms"]))
        for k in kinds:
            top = max(total_px(pps, max_sec) - view, 0)
            if k == "scroll":
                step = int(sizes.pop() * view)
                sign = 1 if rng.random() < 0.5 else -1
                if scroll + sign * step > top or scroll + sign * step < 0:
                    sign = -sign
                scroll = min(max(scroll + sign * step, 0), top)
            elif k == "zoom":
                new = next((z for z in zooms if z != pps), zooms[0])
                zooms.remove(new)
                centre = (scroll + view / 2) / pps
                pps = int(new)
                top = max(total_px(pps, max_sec) - view, 0)
                scroll = min(max(int(centre * pps - view / 2), 0), top)
            else:
                scroll = int(rng.integers(0, top + 1))
            yield k, pps, scroll


def columns(p: dict, sec: float, pps: int, scroll: int):
    """(vis0, vis1, c0, c1): the visible columns and those widened by one
    viewport on each side, as the page's ``fetchView`` computes them."""
    tot = total_px(pps, sec)
    view = p["view_px"]
    vis0 = max(0, int(scroll))
    vis1 = min(tot, int(scroll + view))
    return vis0, vis1, max(0, vis0 - view), min(tot, vis1 + view)


def stage_urls(p: dict, tid: int, sec: float, pps: int, scroll: int):
    """[(spec visible, spec wide), (wav visible, wav wide)] of one track,
    as the page's ``fetchView`` builds them; [] where the track has no
    column in view."""
    vis0, vis1, c0, c1 = columns(p, sec, pps, scroll)
    if vis1 <= vis0:
        return []

    def spec(a, b):
        return (f"/api/spec_crop/{tid}?px_per_sec={js_num(pps)}"
                f"&height={p['spec_height']}&start={js_num(a / pps)}"
                f"&end={js_num(b / pps)}")

    def wav(a, b):
        amp = p["amp"]
        return (f"/api/wav_crop/{tid}?px_per_sec={js_num(pps)}"
                f"&height={p['wav_height']}&amp_min={js_num(-amp)}"
                f"&amp_max={js_num(amp)}&start={js_num(a / pps)}"
                f"&end={js_num(b / pps)}")

    return [(spec(vis0, vis1), spec(c0, c1)), (wav(vis0, vis1), wav(c0, c1))]


def parse(url: str) -> dict:
    from urllib.parse import parse_qs, urlparse

    u = urlparse(url)
    q = {k: float(v[0]) for k, v in parse_qs(u.query).items()}
    kind = "spec" if "/spec_crop/" in u.path else "wav"
    return {"kind": kind, "id": int(u.path.rsplit("/", 1)[1]),
            "pps": q["px_per_sec"], "height": int(q["height"]),
            "start": q["start"], "end": q["end"],
            "amp": q.get("amp_max", 1.0)}


class LRU:
    """The page's image cache: URLs, least recently used first out."""

    def __init__(self, size: int):
        self.size, self.d = size, OrderedDict()
        self.lock = threading.Lock()

    def hit(self, url: str) -> bool:
        with self.lock:
            if url in self.d:
                self.d.move_to_end(url)
                return True
            return False

    def put(self, url: str) -> None:
        with self.lock:
            self.d[url] = True
            if len(self.d) > self.size:
                self.d.popitem(last=False)


class Client:
    """``connections`` workers sending GETs from one FIFO queue; a request
    is timed from its send to the last byte of its answer."""

    def __init__(self, seed: int, port: int, connections: int, keep: int):
        self.port = port
        self.q = queue.Queue()
        self.lock = threading.Lock()
        self.records = []  # (seconds, ok)
        self.kept, self.n_ok = [], 0
        self.keep = keep
        self.rng = np.random.default_rng([seed, 2])
        self.recording = False
        self.threads = [threading.Thread(target=self._work, daemon=True)
                        for _ in range(connections)]
        for t in self.threads:
            t.start()

    def _get(self, url):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=120)
        try:
            t0 = time.perf_counter()
            conn.request("GET", url)
            r = conn.getresponse()
            body = r.read()
            dt = time.perf_counter() - t0
        finally:
            conn.close()
        ok = (r.status == 200 and r.getheader("Content-Type") == "image/png"
              and body[:8] == b"\x89PNG\r\n\x1a\n")
        return dt, ok, body

    def _work(self):
        while True:
            job = self.q.get()
            if job is None:
                return
            url, done = job
            try:
                dt, ok, body = self._get(url)
            except Exception:  # refused, cut, malformed: it never landed
                dt, ok, body = float("inf"), False, b""
            if self.recording:
                self._record(url, dt, ok, body)
            done(ok)

    def _record(self, url, dt, ok, body):
        """Latency of every request; a seeded reservoir of the answers."""
        with self.lock:
            self.records.append((dt, ok))
            if not ok:
                return
            self.n_ok += 1
            if len(self.kept) < self.keep:
                self.kept.append((url, body))
            else:
                j = int(self.rng.integers(0, self.n_ok))
                if j < self.keep:
                    self.kept[j] = (url, body)

    def send(self, url, done):
        self.q.put((url, done))

    def close(self):
        for _ in self.threads:
            self.q.put(None)
        for t in self.threads:
            t.join(timeout=130)


def run_gesture(client: Client, lru: LRU, chains) -> list:
    """Send each chain's visible crop, then its wide crop once the first
    has landed; return, when all have ended, whether each chain landed
    whole."""
    left = [len(chains)]
    whole = [False] * len(chains)
    cv = threading.Condition()

    def finish(k, ok):
        with cv:
            whole[k] = ok
            left[0] -= 1
            cv.notify_all()

    def step(k, i):
        chain = chains[k]
        while i < len(chain) and lru.hit(chain[i]):
            i += 1
        if i == len(chain):
            finish(k, True)
            return
        url = chain[i]

        def landed(ok):
            if ok:
                lru.put(url)
                step(k, i + 1)
            else:
                finish(k, False)  # the page stops the chain at a failed stage

        client.send(url, landed)

    for k in range(len(chains)):
        step(k, 0)
    with cv:
        while left[0]:
            cv.wait()
    return whole


def fetch_view(client: Client, lru: LRU, p: dict, secs: list, pps: int,
               scroll: int, cover: dict, force: bool) -> int:
    """The page's ``fetchView`` on every track; ``cover`` maps a track to
    the columns its images cover.  Returns the chains sent."""
    plan = []
    for tid, sec in enumerate(secs):
        vis0, vis1, c0, c1 = columns(p, sec, pps, scroll)
        have = cover.get(tid)
        if not force and have and have[0] <= vis0 and vis1 <= have[1]:
            continue
        cover.pop(tid, None)
        plan.append((tid, [list(c) for c in
                           stage_urls(p, tid, sec, pps, scroll)], (c0, c1)))
    whole = run_gesture(client, lru, [c for _, cs, _ in plan for c in cs])
    k = 0
    for tid, chains, span in plan:
        if chains and all(whole[k:k + len(chains)]):
            cover[tid] = span
        k += len(chains)
    return k


def page(conn, port: int, p: dict, seed: int, secs: list) -> None:
    """The page, in a process of its own as a browser is: it warms every
    zoom level when asked, then browses for a window and sends back every
    request's (seconds, ok), the judged answers, the gestures it made and
    the seconds of each gesture that sent a request."""
    client = Client(seed, port, p["connections"], p["judged_images"])
    try:
        while True:
            msg = conn.recv()
            if msg[0] == "warm":
                # two gestures at every zoom level: render weights,
                # envelope levels, every crop shape of the window
                lru = LRU(p["client_lru"])
                for z in p["zooms"]:
                    top = max(total_px(z, max(secs)) - p["view_px"], 0)
                    for scroll in (0, top // 2):
                        fetch_view(client, lru, p, secs, z, scroll, {}, True)
                conn.send(("ready",))
            elif msg[0] == "window":
                # a fresh page: nothing cached, nothing covered
                lru, cover = LRU(p["client_lru"]), {}
                stream = gestures(seed, p, max(secs))
                client.recording = True
                took, n = [], 0
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < msg[1]:
                    kind, pps, scroll = next(stream)
                    g0 = time.perf_counter()
                    if fetch_view(client, lru, p, secs, pps, scroll, cover,
                                  force=kind == "zoom"):
                        took.append(time.perf_counter() - g0)
                    n += 1
                client.recording = False
                conn.send(("done", client.records, client.kept, took, n))
            else:
                return
    finally:
        client.close()
        conn.close()


def setup(run):
    import multiprocessing
    from http.server import ThreadingHTTPServer

    from msv_tpu_torch.session import MultiTrack
    from msv_tpu_torch.viewer import _Handler, _RWLock

    p = run.traffic
    mt = MultiTrack(run.setting(), device=run.device)
    mt.add_tracks(list(range(len(run.tracks))),
                  [t["path"] for t in run.tracks])

    class Handler(_Handler):
        """The viewer's handler, with the harness's spans around a
        request's handling and its PNG encode."""

        session = mt
        lock = _RWLock()
        add_root = None

        def do_GET(self):
            with run.span("serve"):
                super().do_GET()

        def _png(self, arr):
            with run.span("encode_png"):
                return super()._png(arr)

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    secs = [mt.get_sec(i) for i in range(len(run.tracks))]
    ctx = multiprocessing.get_context("spawn")
    conn, child = ctx.Pipe()
    proc = ctx.Process(target=page, args=(child, srv.server_address[1], p,
                                          run.seed, secs), daemon=True)
    proc.start()
    child.close()
    state = {"mt": mt, "srv": srv, "thread": thread, "proc": proc,
             "conn": conn}
    conn.send(("warm",))
    if conn.recv()[0] != "ready":
        raise RuntimeError("the page process did not warm up")
    Handler.cache = None  # the window starts with an empty render cache
    run.spans.clear()
    run.host_spans.clear()
    return state


def window(run, state, seconds):
    mt, conn = state["mt"], state["conn"]
    mt.timer.reset()
    conn.send(("window", seconds))
    _, records, kept, took, n = conn.recv()
    run.add_stages(mt.timer.summary())
    state["kept"] = kept
    # a failed request never landed: infinitely late
    lat = sorted(dt if ok else float("inf") for dt, ok in records)
    failed = sum(1 for _, ok in records if not ok)
    run.counts.update(attempted=len(lat), failed=failed, requests=len(lat),
                      gestures=n, gestures_sent=len(took))
    run.samples = took
    return {"view_p50_ms": 1e3 * percentile(lat, 0.50),
            "view_p95_ms": 1e3 * percentile(lat, 0.95)}


def percentile(values, q: float) -> float:
    """Nearest-rank q-quantile of all values (a failed request counts as
    infinitely late)."""
    v = sorted(values)
    if not v:
        return float("inf")
    return v[max(0, int(np.ceil(q * len(v))) - 1)]


def outputs(run, state):
    mt = state["mt"]
    conn, proc = state.pop("conn"), state.pop("proc")
    conn.send(("stop",))
    proc.join(timeout=150)
    if proc.is_alive():
        proc.terminate()
        proc.join(timeout=30)
    conn.close()
    srv = state.pop("srv")
    srv.shutdown()
    srv.server_close()
    state.pop("thread").join(timeout=60)
    images = [dict(parse(url), png=body) for url, body in state.pop("kept")]
    out = {"planes": {tid: mt.get_spec_db(tid) for tid in mt.tracks},
           "range": (mt.get_max_db(), mt.get_min_db()),
           "images": images, "failed": run.counts["failed"]}
    state.clear()
    del mt
    gc.collect()
    return out
