"""The view traffic's gesture stream, the client LRU, the page's URLs and
the percentile arithmetic."""

import itertools
import math

import pytest

from portbench import registry
from portbench.traffic import view

P = registry.traffic("view")


def take(seed, n, sec=240.0):
    return list(itertools.islice(view.gestures(seed, P, sec), n))


def test_gestures_are_deterministic_by_seed():
    assert take(2**31 + 7, 90) == take(2**31 + 7, 90)
    assert take(2**31 + 7, 90) != take(2**31 + 8, 90)


@pytest.mark.parametrize("seed", [1, 2**31 + 99])
def test_every_block_has_the_same_make_up(seed):
    block = sum(P["block"].values())
    g = take(seed, 3 * block)
    for b in range(3):
        kinds = [k for k, _, _ in g[b * block:(b + 1) * block]]
        assert {k: kinds.count(k) for k in P["block"]} == P["block"]
    # every zoom level once a block
    zooms = [pps for k, pps, _ in g[:block] if k == "zoom"]
    assert sorted(zooms) == sorted(P["zooms"])


def test_the_view_stays_on_the_track():
    for _, pps, scroll in take(5, 300, sec=3600.0):
        assert 0 <= scroll <= max(view.total_px(pps, 3600.0)
                                  - P["view_px"], 0)


def test_client_lru_drops_repeats_and_forgets_the_oldest():
    lru = view.LRU(3)
    for u in "abc":
        assert not lru.hit(u)
        lru.put(u)
    assert lru.hit("a")  # a is now the newest
    lru.put("d")  # evicts b
    assert not lru.hit("b") and lru.hit("c") and lru.hit("d")


def test_stage_urls_are_the_pages():
    (sv, sw), (wv, ww) = view.stage_urls(P, 3, 240.0, 100, 1200)
    assert sv == "/api/spec_crop/3?px_per_sec=100&height=300&start=12&end=24"
    assert sw == "/api/spec_crop/3?px_per_sec=100&height=300&start=0&end=36"
    assert wv == ("/api/wav_crop/3?px_per_sec=100&height=80&amp_min=-1"
                  "&amp_max=1&start=12&end=24")
    assert view.parse(ww)["end"] == 36.0
    # the last viewport's wide crop stops at the track's end
    (_, sw), _ = view.stage_urls(P, 0, 240.0, 25, 4800)
    assert sw.endswith("start=144&end=240")
    assert view.stage_urls(P, 0, 10.0, 100, 5000) == []
    assert view.js_num(37 / 25) == "1.48"


def test_percentiles_over_all_requests():
    lat = [float(i) for i in range(1, 101)]  # 1..100
    assert view.percentile(lat, 0.5) == 50.0
    assert view.percentile(lat, 0.95) == 95.0
    # a failed request is infinitely late and enters both
    assert view.percentile(lat[:94] + [math.inf] * 6, 0.95) == math.inf
    assert view.percentile([3.0], 0.95) == 3.0
    assert view.percentile([], 0.5) == math.inf


class FakeClient:
    """Answers every request at once; ``fail`` names URLs that fail."""

    def __init__(self, fail=()):
        self.sent, self.fail = [], set(fail)

    def send(self, url, done):
        self.sent.append(url)
        done(url not in self.fail)


SECS = [240.0, 240.0]


def test_a_scroll_inside_the_covered_columns_sends_nothing():
    c, cover = FakeClient(), {}
    lru = view.LRU(P["client_lru"])
    assert view.fetch_view(c, lru, P, SECS, 100, 6000, cover, True) == 4
    assert len(c.sent) == 8  # two stages of spec and wav, two tracks
    assert cover == {0: (4800, 8400), 1: (4800, 8400)}
    # half a viewport and a whole one stay inside the margin
    for scroll in (6600, 7200, 4800):
        assert view.fetch_view(c, lru, P, SECS, 100, scroll, cover,
                               False) == 0
    assert len(c.sent) == 8
    # past the margin: the page fetches and covers the new columns
    assert view.fetch_view(c, lru, P, SECS, 100, 7300, cover, False) == 4
    assert cover[0] == (6100, 9700) and len(c.sent) == 16


def test_a_zoom_always_sends_and_a_failed_stage_drops_the_cover():
    c, cover = FakeClient(), {}
    lru = view.LRU(P["client_lru"])
    view.fetch_view(c, lru, P, SECS, 100, 6000, cover, True)
    # forced (a zoom): sent again, every image answered by the LRU
    assert view.fetch_view(c, lru, P, SECS, 100, 6000, cover, True) == 4
    assert len(c.sent) == 8
    (_, wide), _ = view.stage_urls(P, 1, 240.0, 100, 9000)
    bad = FakeClient(fail={wide})
    view.fetch_view(bad, lru, P, SECS, 100, 9000, cover, False)
    assert 1 not in cover and cover[0] == (7800, 11400)
    # the uncovered track retries on the next scroll; the other does not
    view.fetch_view(bad, lru, P, SECS, 100, 9300, cover, False)
    assert sorted({view.parse(u)["id"] for u in bad.sent[-3:]}) == [1]


def test_a_truncated_answer_fails_and_does_not_hang():
    import http.server
    import threading

    class Cut(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", "1000")
            self.end_headers()
            self.wfile.write(b"\x89PNG\r\n\x1a\n")  # then the line closes

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Cut)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    client = view.Client(3, srv.server_address[1], 2, 4)
    client.recording = True
    got = []
    t = threading.Thread(target=lambda: got.append(view.run_gesture(
        client, view.LRU(8), [["/a", "/b"], ["/c"]])), daemon=True)
    t.start()
    t.join(timeout=60)
    client.close()
    srv.shutdown()
    srv.server_close()
    assert got == [[False, False]]
    assert client.records == [(math.inf, False)] * 2
