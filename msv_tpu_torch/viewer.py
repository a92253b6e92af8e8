"""Web viewer of the PyTorch/CUDA port, ported from ``msv_tpu/viewer.py``:
a stdlib HTTP server exposing a ``MultiTrack`` session on one card as a
JSON+PNG API, plus the same single-page client, which renders N tracks on
a shared time axis with zoom; each zoom step is a render of the cached dB
planes on the device.

    python -m msv_tpu_torch view a.wav b.wav --port 8080

Every route of msv_tpu's viewer is ported, each computing on the
session's device: the image routes, the audio route, settings, track
management, the stats route, the analysis routes (pitch, formants,
onsets, beats, segments, notes, key, align, loudness), the background
``/api/analyze`` report and ``POST /api/process``, which adds a processed
track (denoise, declick, harmonic, percussive, separate, specedit).  The
analysis routes and the last two answer 400 to a bad parameter and 404 to
an unknown track, where msv_tpu answers 500.
"""

import io
import json
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>msv_tpu viewer</title>
<style>
 body { background:#111; color:#ddd; font-family:sans-serif; margin:0; }
 #bar { padding:8px 12px; background:#1b1b1b; position:sticky; top:0; }
 .track { margin:10px 12px; }
 .track .name { font-size:12px; color:#9a9; margin-bottom:2px; }
 .imgs { overflow-x:auto; white-space:nowrap; background:#000; }
 .imgs img { display:block; image-rendering:pixelated; }
 input[type=range] { width:240px; vertical-align:middle; }
 #readout { margin-left:16px; color:#aac; font-size:13px; }
</style></head><body>
<div id="bar">
 zoom <input id="zoom" type="range" min="10" max="400" value="100">
 <span id="zv">100</span> px/s
 <span id="readout"></span>
 <img id="cbar" src="/api/colorbar?width=16&height=24" style="vertical-align:middle;margin-left:14px" title="dB colorbar">
 <span id="dbrange" style="color:#888;font-size:12px"></span>
 <label style="margin-left:14px"><input id="showwav" type="checkbox" checked> waveform</label>
 <label style="margin-left:14px" title="adaptive multi-resolution STFT (transients from short windows, harmonics from long ones)"><input id="adaptive" type="checkbox"> adaptive</label>
 <label style="margin-left:14px" title="YIN f0 contour drawn on the spectrogram (cyan; gaps where the frame is unvoiced)"><input id="pitch" type="checkbox"> pitch</label>
 <label title="Viterbi-decode the f0 contour (ops/sequence.py): heals octave glitches, hysteresis on voicing"><input id="psmooth" type="checkbox" checked> smooth</label>
 <label style="margin-left:14px" title="LPC formant tracks F1-F4 (ops/lpc.py, Praat-style; white dotted contours)"><input id="formants" type="checkbox"> formants</label>
 <label style="margin-left:14px" title="spectral-flux onset markers (orange ticks)"><input id="onsets" type="checkbox"> onsets</label>
 <label style="margin-left:14px" title="tracked beat grid (green lines) + tempo readout"><input id="beats" type="checkbox"> beats</label>
 <label style="margin-left:14px" title="structure boundaries from self-similarity novelty (magenta lines)"><input id="segs" type="checkbox"> sections</label>
 <label style="margin-left:14px" title="transcribed note events (yellow piano-roll bars at the note's pitch)"><input id="notes" type="checkbox"> notes</label>
 <select id="editmode" title="spectral editing: pick a mode, then drag a box on a spectrogram — the edited audio is added as a new track" style="margin-left:14px"><option value="">edit&#8230;</option><option value="erase">erase box</option><option value="duck">duck -18 dB</option><option value="patch">patch (repair)</option></select>
 amp&plusmn;<input id="amp" type="number" value="1.0" min="0.05" max="4" step="0.05" style="width:56px">
 <input id="addpath" placeholder="/path/to/file.wav" style="margin-left:14px;width:220px">
 <button id="addbtn">add</button>
 <span style="margin-left:14px;color:#888;font-size:12px">
  win <input id="win_ms" type="number" value="40" min="5" max="500" step="5" style="width:48px"> ms
  &times;<input id="t_overlap" type="number" value="4" min="1" max="16" style="width:36px">
  <select id="freq_scale"><option value="mel">mel</option><option value="linear">linear</option></select>
  range <input id="db_range" type="number" value="120" min="20" max="200" step="10" style="width:52px"> dB
  <button id="applyset">apply</button>
 </span>
</div>
<div id="tracks"></div>
<script>
// Viewport-based rendering: each track fetches only the visible time range
// (plus one screen of margin) via /api/spec_crop + /api/wav_crop, so
// hour-long tracks are browsable — every scroll/zoom is a device kernel
// relaunch over the cached spectrogram, never a recompute.
const H = 300, WH = 80;
let pps = 100, tracks = [];
const state = {};  // id -> {c0, c1} currently displayed columns

// Client-side crop LRU: pan-back over a window the browser just showed
// must not re-pay the wire (the server additionally caches encoded PNGs
// behind this, but a remote browser still saves the HTTP round trip).
// Keyed by full request URL (track, endpoint, zoom, viewport, amp are
// all in it); cleared on any session mutation from this client.
const imgCache = new Map();  // url -> blob object-URL, insertion = LRU
const IMG_CACHE_MAX = 96;
function clearImgCache() {
  for (const v of imgCache.values()) URL.revokeObjectURL(v);
  imgCache.clear();
}
async function fetchImg(url) {
  if (imgCache.has(url)) {
    const v = imgCache.get(url);
    imgCache.delete(url); imgCache.set(url, v);  // refresh LRU position
    return v;
  }
  const r = await fetch(url);
  if (r.status === 202) throw {pending: await r.json()};
  if (!r.ok) throw new Error(await r.text());
  const o = URL.createObjectURL(await r.blob());
  imgCache.set(url, o);
  if (imgCache.size > IMG_CACHE_MAX) {
    const k = imgCache.keys().next().value;
    URL.revokeObjectURL(imgCache.get(k)); imgCache.delete(k);
  }
  return o;
}

function viewParams() {
  return {
    amp: +document.getElementById('amp').value || 1.0,
    showWav: document.getElementById('showwav').checked,
    adaptive: document.getElementById('adaptive').checked,
  };
}

// Two-stage fetch: the VISIBLE region renders first (small image, fastest
// possible perceived latency on a slow link), then one screen of margin on
// each side is prefetched and swapped in for smooth panning.  Each stage
// loads via a detached Image and swaps in only if this call is still the
// latest for the track (gen guard) — stale loads from superseded calls
// cannot clobber a fresh render.  Margin coverage is recorded only when
// every wide image has actually landed, so a failed stage-2 request
// leaves the window marked uncovered and the next scroll retries instead
// of panning over blank margin forever.
function fetchView(t, force) {
  const box = document.getElementById('box' + t.id);
  const totalPx = Math.trunc(pps * t.sec);
  const viewPx = box.clientWidth || 1200;
  const vis0 = Math.max(0, Math.trunc(box.scrollLeft));
  const vis1 = Math.min(totalPx, Math.trunc(box.scrollLeft + viewPx));
  const c0 = Math.max(0, vis0 - viewPx);
  const c1 = Math.min(totalPx, vis1 + viewPx);
  const st = state[t.id] || {};
  if (!force && st.c0 !== undefined && vis0 >= st.c0 && vis1 <= st.c1) return;
  const gen = (st.gen || 0) + 1;
  state[t.id] = {c0: vis0, c1: vis1, gen};  // visible-only until wides land
  const {amp, showWav, adaptive} = viewParams();
  const specEp = adaptive ? 'adaptive_crop' : 'spec_crop';
  const specUrl = (a, b) =>
    `/api/${specEp}/${t.id}?px_per_sec=${pps}&height=${H}&start=${a / pps}&end=${b / pps}`;
  const wavUrl = (a, b) =>
    `/api/wav_crop/${t.id}?px_per_sec=${pps}&height=${WH}&amp_min=${-amp}&amp_max=${amp}&start=${a / pps}&end=${b / pps}`;
  let pendingWide = showWav ? 2 : 1;
  const wideLanded = () => {
    if (--pendingWide === 0) state[t.id] = {c0, c1, gen};
  };
  const stage = (img, urlVis, urlWide) => {
    fetchImg(urlVis).then(src => {
      if ((state[t.id] || {}).gen !== gen) return;  // superseded
      const dbr = document.getElementById('dbrange');
      if (dbr.textContent.startsWith('adaptive build') && window._dbText)
        dbr.textContent = window._dbText;
      img.src = src; img.style.left = vis0 + 'px';
      return fetchImg(urlWide).then(srcW => {  // stage 2: widen to margin
        if ((state[t.id] || {}).gen !== gen) return;
        img.src = srcW; img.style.left = c0 + 'px';
        wideLanded();
      });
    }).catch(err => {
      if ((state[t.id] || {}).gen !== gen) return;
      state[t.id] = {gen};  // drop coverage: the next scroll retries
      if (err && err.pending && viewParams().adaptive) {
        // zoomed-out adaptive view, background full-dB build running:
        // the 202 body carries progress; poll until it lands
        const p = err.pending;
        document.getElementById('dbrange').textContent =
          `adaptive build ${(100 * p.built / Math.max(p.total, 1)).toFixed(0)}%…`;
        setTimeout(() => fetchView(t, true), 1500);
      }
    });
  };
  const spec = document.getElementById('spec' + t.id);
  stage(spec, specUrl(vis0, vis1), specUrl(c0, c1));
  const wimg = document.getElementById('wav' + t.id);
  wimg.style.display = showWav ? 'block' : 'none';
  if (showWav) stage(wimg, wavUrl(vis0, vis1), wavUrl(c0, c1));
  document.getElementById('spacer' + t.id).style.width = totalPx + 'px';
  // f0 overlay (ops/pitch.py YIN via /api/pitch): drawn for the visible
  // window only; "rel" mirrors the cursor readout's mapping so the
  // contour lands exactly where /api/freq would report that Hz
  const pcv = document.getElementById('pitch' + t.id);
  if (document.getElementById('pitch').checked) {
    const melq = (adaptive ? '&mel=1' : '') +
      (document.getElementById('psmooth').checked ? '&smooth=1' : '');
    fetch(`/api/pitch/${t.id}?start=${vis0 / pps}&end=${vis1 / pps}` + melq)
      .then(r => r.ok ? r.json() : null).then(d => {
        if (!d || (state[t.id] || {}).gen !== gen) return;
        pcv.width = Math.max(vis1 - vis0, 1); pcv.height = H;
        pcv.style.left = vis0 + 'px';
        const ctx = pcv.getContext('2d');
        ctx.clearRect(0, 0, pcv.width, H);
        ctx.strokeStyle = 'rgba(80,230,255,0.9)'; ctx.lineWidth = 1.5;
        ctx.beginPath();
        let pen = false;   // lift the pen over unvoiced / out-of-band
        for (let i = 0; i < d.f0.length; i++) {
          if (d.ap[i] > 0.25 || d.rel[i] <= 0 || d.rel[i] >= 1) { pen = false; continue; }
          const x = (d.t0 + i * d.hop_s) * pps - vis0;
          const y = (1 - d.rel[i]) * H;
          if (pen) ctx.lineTo(x, y); else { ctx.moveTo(x, y); pen = true; }
        }
        ctx.stroke();
      }).catch(() => {});
  } else if (pcv.width) {
    pcv.getContext('2d').clearRect(0, 0, pcv.width, pcv.height);
  }
  // formant overlay (ops/lpc.py via /api/formants): K dotted contours,
  // same rel mapping as the pitch overlay
  const fcv = document.getElementById('fmt' + t.id);
  if (document.getElementById('formants').checked) {
    const melq = adaptive ? '&mel=1' : '';
    fetch(`/api/formants/${t.id}?start=${vis0 / pps}&end=${vis1 / pps}` + melq)
      .then(r => r.ok ? r.json() : null).then(d => {
        if (!d || (state[t.id] || {}).gen !== gen) return;
        fcv.width = Math.max(vis1 - vis0, 1); fcv.height = H;
        fcv.style.left = vis0 + 'px';
        const ctx = fcv.getContext('2d');
        ctx.clearRect(0, 0, fcv.width, H);
        ctx.strokeStyle = 'rgba(245,245,245,0.85)'; ctx.lineWidth = 1.2;
        ctx.setLineDash([3, 3]);
        const K = d.rel.length ? d.rel[0].length : 0;
        for (let k = 0; k < K; k++) {
          ctx.beginPath();
          let pen = false;
          for (let i = 0; i < d.rel.length; i++) {
            const v = d.rel[i][k];
            if (v == null || v <= 0 || v >= 1) { pen = false; continue; }
            const x = (d.t0 + i * d.hop_s) * pps - vis0;
            const y = (1 - v) * H;
            if (pen) ctx.lineTo(x, y); else { ctx.moveTo(x, y); pen = true; }
          }
          ctx.stroke();
        }
        ctx.setLineDash([]);
      }).catch(() => {});
  } else if (fcv.width) {
    fcv.getContext('2d').clearRect(0, 0, fcv.width, fcv.height);
  }
  // onset ticks (features.py spectral flux via /api/onsets)
  const ocv = document.getElementById('ons' + t.id);
  if (document.getElementById('onsets').checked) {
    fetch(`/api/onsets/${t.id}?start=${vis0 / pps}&end=${vis1 / pps}`)
      .then(r => r.ok ? r.json() : null).then(d => {
        if (!d || (state[t.id] || {}).gen !== gen) return;
        ocv.width = Math.max(vis1 - vis0, 1); ocv.height = H;
        ocv.style.left = vis0 + 'px';
        const ctx = ocv.getContext('2d');
        ctx.clearRect(0, 0, ocv.width, H);
        ctx.strokeStyle = 'rgba(255,170,60,0.8)'; ctx.lineWidth = 1;
        for (const tt of d.t) {
          const x = tt * pps - vis0;
          ctx.beginPath(); ctx.moveTo(x, 0); ctx.lineTo(x, H); ctx.stroke();
        }
      }).catch(() => {});
  } else if (ocv.width) {
    ocv.getContext('2d').clearRect(0, 0, ocv.width, ocv.height);
  }
  // beat grid (ops/rhythm.py tempogram + Ellis DP via /api/beats)
  const bcv = document.getElementById('bts' + t.id);
  if (document.getElementById('beats').checked) {
    fetch(`/api/beats/${t.id}?start=${vis0 / pps}&end=${vis1 / pps}`)
      .then(r => r.ok ? r.json() : null).then(d => {
        if (!d || (state[t.id] || {}).gen !== gen) return;
        bcv.width = Math.max(vis1 - vis0, 1); bcv.height = H;
        bcv.style.left = vis0 + 'px';
        const ctx = bcv.getContext('2d');
        ctx.clearRect(0, 0, bcv.width, H);
        ctx.strokeStyle = 'rgba(110,250,130,0.75)'; ctx.lineWidth = 1.5;
        for (const tt of d.t) {
          const x = tt * pps - vis0;
          ctx.beginPath(); ctx.moveTo(x, 0); ctx.lineTo(x, H); ctx.stroke();
        }
        if (d.bpm > 0) {
          ctx.fillStyle = 'rgba(110,250,130,0.9)';
          ctx.font = '12px sans-serif';
          ctx.fillText(d.bpm.toFixed(1) + ' BPM', 6, 14);
        }
      }).catch(() => {});
  } else if (bcv.width) {
    bcv.getContext('2d').clearRect(0, 0, bcv.width, bcv.height);
  }
  // section boundaries (ops/segment.py SSM novelty via /api/segments)
  const scv = document.getElementById('seg' + t.id);
  if (document.getElementById('segs').checked) {
    fetch(`/api/segments/${t.id}?start=${vis0 / pps}&end=${vis1 / pps}`)
      .then(r => r.ok ? r.json() : null).then(d => {
        if (!d || (state[t.id] || {}).gen !== gen) return;
        scv.width = Math.max(vis1 - vis0, 1); scv.height = H;
        scv.style.left = vis0 + 'px';
        const ctx = scv.getContext('2d');
        ctx.clearRect(0, 0, scv.width, H);
        ctx.strokeStyle = 'rgba(255,80,230,0.85)'; ctx.lineWidth = 2;
        for (const tt of d.t) {
          const x = tt * pps - vis0;
          ctx.beginPath(); ctx.moveTo(x, 0); ctx.lineTo(x, H); ctx.stroke();
        }
      }).catch(() => {});
  } else if (scv.width) {
    scv.getContext('2d').clearRect(0, 0, scv.width, scv.height);
  }
  // note events (ops/transcribe.py via /api/notes): piano-roll bars at
  // the note's pitch position; opacity tracks velocity
  const ncv = document.getElementById('nts' + t.id);
  if (document.getElementById('notes').checked) {
    const melq = adaptive ? '&mel=1' : '';
    fetch(`/api/notes/${t.id}?start=${vis0 / pps}&end=${vis1 / pps}` + melq)
      .then(r => r.ok ? r.json() : null).then(d => {
        if (!d || (state[t.id] || {}).gen !== gen) return;
        ncv.width = Math.max(vis1 - vis0, 1); ncv.height = H;
        ncv.style.left = vis0 + 'px';
        const ctx = ncv.getContext('2d');
        ctx.clearRect(0, 0, ncv.width, H);
        for (const nt of d.notes) {
          if (nt.rel <= 0 || nt.rel >= 1) continue;
          const x0 = nt.start * pps - vis0, x1 = nt.end * pps - vis0;
          const y = (1 - nt.rel) * H;
          ctx.fillStyle = `rgba(255,235,80,${0.35 + 0.55 * nt.velocity / 127})`;
          ctx.fillRect(x0, y - 2, Math.max(x1 - x0, 2), 5);
        }
      }).catch(() => {});
  } else if (ncv.width) {
    ncv.getContext('2d').clearRect(0, 0, ncv.width, ncv.height);
  }
}

function refresh() {
  for (const t of tracks) fetchView(t, true);
}

async function load() {
  const r = await fetch('/api/tracks'); const d = await r.json();
  if (d.error) {
    document.getElementById('dbrange').textContent = 'load failed: ' + d.error;
    return;
  }
  if (d.loading) {  // startup loader still holds the session: poll
    document.getElementById('dbrange').textContent = 'loading tracks…';
    setTimeout(load, 1500);
    return;
  }
  tracks = d.tracks;
  if (window._gen !== undefined && d.gen !== window._gen) {
    clearImgCache();  // another client mutated the session: pixels stale
  }
  window._gen = d.gen;
  window._dbText = `${d.min_db.toFixed(1)} … ${d.max_db.toFixed(1)} dB`;
  document.getElementById('dbrange').textContent = window._dbText;
  // per-load window listeners die with the load that made them (the
  // track nodes are GC'd with innerHTML, but window listeners are not)
  if (window._selAbort) window._selAbort.abort();
  window._selAbort = new AbortController();
  const el = document.getElementById('tracks'); el.innerHTML = '';
  for (const t of tracks) {
    const div = document.createElement('div'); div.className = 'track';
    // channel selector (stereo support — the reference sums to mono,
    // lib.rs:42 TODO): "mix" = channel sum, else one source channel
    const chSel = t.n_channels > 1
      ? `<select data-chsel="${t.id}" style="vertical-align:middle">
           <option value=""${t.channel === null ? ' selected' : ''}>mix</option>
           ${Array.from({length: t.n_channels}, (_, c) =>
             `<option value="${c}"${t.channel === c ? ' selected' : ''}>ch ${c}</option>`).join('')}
         </select>` : '';
    div.innerHTML = `<div class="name">#${t.id} ${t.filename} — ${t.sr} Hz, ${t.sec.toFixed(2)} s
        ${chSel}
        <audio controls preload="none" src="/api/audio/${t.id}" style="height:20px;vertical-align:middle"></audio>
        <button data-lufs="${t.id}" title="BS.1770 integrated loudness of this track's mix">LUFS</button>
        <button data-key="${t.id}" title="Krumhansl-Schmuckler key estimate of this track's mix">key</button>
        <button data-an="${t.id}" title="full analysis report (loudness, tempo, key, structure, onsets, pitch) — computed in the background">analyze</button>
        ${t.id !== tracks[0].id ? `<button data-align="${t.id}" title="time offset of this track's content vs track #${tracks[0].id} (envelope NCC + GCC-PHAT)">align</button>` : ''}
        <select data-fx="${t.id}" title="process this track and add the result as a new track"><option value="">fx&#8230;</option><option value="denoise">denoise</option><option value="declick">declick</option><option value="harmonic">harmonic</option><option value="percussive">percussive</option><option value="separate">separate (NMF x2)</option></select>
        <button data-rm="${t.id}">&#10005;</button></div>
      <div class="imgs" id="box${t.id}" style="position:relative;height:${H + WH}px">
        <div id="spacer${t.id}" style="height:1px"></div>
        <img id="spec${t.id}" style="position:absolute;top:0;left:0">
        <canvas id="pitch${t.id}" style="position:absolute;top:0;left:0;pointer-events:none"></canvas>
        <canvas id="fmt${t.id}" style="position:absolute;top:0;left:0;pointer-events:none"></canvas>
        <canvas id="ons${t.id}" style="position:absolute;top:0;left:0;pointer-events:none"></canvas>
        <canvas id="bts${t.id}" style="position:absolute;top:0;left:0;pointer-events:none"></canvas>
        <canvas id="seg${t.id}" style="position:absolute;top:0;left:0;pointer-events:none"></canvas>
        <canvas id="nts${t.id}" style="position:absolute;top:0;left:0;pointer-events:none"></canvas>
        <canvas id="sel${t.id}" style="position:absolute;top:0;left:0;pointer-events:none"></canvas>
        <img id="wav${t.id}" style="position:absolute;top:${H}px;left:0">
      </div>`;
    el.appendChild(div);
    const box = div.querySelector(`#box${t.id}`);
    let tmo = null;
    box.addEventListener('scroll', () => {
      clearTimeout(tmo); tmo = setTimeout(() => fetchView(t, false), 150);
    });
    const img = div.querySelector(`#spec${t.id}`);
    img.addEventListener('mousemove', ev => {
      const rect = img.getBoundingClientRect();
      const relY = 1 - (ev.clientY - rect.top) / rect.height;
      const c0 = state[t.id] ? state[t.id].c0 : 0;
      const sec = (c0 + ev.clientX - rect.left) / pps;
      const melq = viewParams().adaptive ? '&mel=1' : '';
      fetch(`/api/freq/${t.id}?rel=${relY.toFixed(4)}` + melq).then(r=>r.json()).then(f=>{
        document.getElementById('readout').textContent =
          `t=${sec.toFixed(2)} s, f=${f.hz.toFixed(0)} Hz`;
      });
    });
    // spectral editing: with an edit mode armed, drag a box on the
    // spectrogram; on release the box (seconds x Hz, Hz via /api/freq
    // so mel sessions map correctly) POSTs to /api/process specedit
    // and the edited audio joins the session as a new track
    const selcv = div.querySelector(`#sel${t.id}`);
    let selA = null;
    img.addEventListener('mousedown', ev => {
      if (!document.getElementById('editmode').value) return;
      ev.preventDefault();
      const rect = img.getBoundingClientRect();
      selA = [ev.clientX - rect.left, ev.clientY - rect.top];
      selcv.width = rect.width; selcv.height = rect.height;
      selcv.style.left = img.style.left || '0px';
    });
    img.addEventListener('mousemove', ev => {
      if (!selA) return;
      const rect = img.getBoundingClientRect();
      const x = ev.clientX - rect.left, y = ev.clientY - rect.top;
      const ctx = selcv.getContext('2d');
      ctx.clearRect(0, 0, selcv.width, selcv.height);
      ctx.strokeStyle = 'rgba(255,255,255,0.9)'; ctx.lineWidth = 1;
      ctx.setLineDash([4, 3]);
      ctx.strokeRect(Math.min(selA[0], x), Math.min(selA[1], y),
                     Math.abs(x - selA[0]), Math.abs(y - selA[1]));
      ctx.setLineDash([]);
    });
    window.addEventListener('mouseup', async ev => {
      if (!selA) return;
      const a = selA; selA = null;
      selcv.getContext('2d').clearRect(0, 0, selcv.width, selcv.height);
      const mode = document.getElementById('editmode').value;
      if (!mode) return;
      const rect = img.getBoundingClientRect();
      const x = Math.min(Math.max(ev.clientX - rect.left, 0), rect.width);
      const y = Math.min(Math.max(ev.clientY - rect.top, 0), rect.height);
      if (Math.abs(x - a[0]) < 3 || Math.abs(y - a[1]) < 3) return;
      const c0 = state[t.id] ? state[t.id].c0 : 0;
      const t0 = (c0 + Math.min(a[0], x)) / pps;
      const t1 = (c0 + Math.max(a[0], x)) / pps;
      const melq = viewParams().adaptive ? '&mel=1' : '';
      const rel0 = 1 - Math.max(a[1], y) / rect.height;
      const rel1 = 1 - Math.min(a[1], y) / rect.height;
      try {
        const f0 = (await (await fetch(`/api/freq/${t.id}?rel=${rel0.toFixed(4)}` + melq)).json()).hz;
        const f1 = (await (await fetch(`/api/freq/${t.id}?rel=${rel1.toFixed(4)}` + melq)).json()).hz;
        const box = {t0, t1, f0: Math.max(f0, 0), f1: Math.max(f1, 1)};
        if (mode === 'patch') box.mode = 'patch';
        else box.gain_db = mode === 'duck' ? -18 : -80;
        const r = await fetch('/api/process', {method: 'POST',
          body: JSON.stringify({id: t.id, op: 'specedit', boxes: [box]})});
        if (!r.ok) { alert(await r.text()); return; }
        clearImgCache();  // new track shifts the shared dB window
        load();
      } catch (e) {}
    }, {signal: window._selAbort.signal});
  }
  refresh();
}
document.getElementById('zoom').addEventListener('change', e => {
  pps = +e.target.value; document.getElementById('zv').textContent = pps; refresh();
});
document.getElementById('showwav').addEventListener('change', refresh);
document.getElementById('adaptive').addEventListener('change', refresh);
document.getElementById('pitch').addEventListener('change', refresh);
document.getElementById('psmooth').addEventListener('change', refresh);
document.getElementById('formants').addEventListener('change', refresh);
document.getElementById('onsets').addEventListener('change', refresh);
document.getElementById('beats').addEventListener('change', refresh);
document.getElementById('segs').addEventListener('change', refresh);
document.getElementById('notes').addEventListener('change', refresh);
document.getElementById('amp').addEventListener('change', refresh);
document.getElementById('addbtn').addEventListener('click', async () => {
  const path = document.getElementById('addpath').value.trim();
  if (!path) return;
  const id = tracks.length ? Math.max(...tracks.map(t=>t.id)) + 1 : 0;
  const r = await fetch('/api/add', {method:'POST', body: JSON.stringify({id, path})});
  if (!r.ok) { alert(await r.text()); return; }
  clearImgCache();  // global dB window may have moved: all pixels stale
  load();
});
document.getElementById('applyset').addEventListener('click', async () => {
  // live SpecSetting round-trip (lib.rs:64-70 surface; the reference has
  // no setter wired yet — ours re-derives all tracks server-side)
  const body = {
    win_ms: +document.getElementById('win_ms').value,
    t_overlap: +document.getElementById('t_overlap').value,
    freq_scale: document.getElementById('freq_scale').value,
    db_range: +document.getElementById('db_range').value,
  };
  const r = await fetch('/api/setting', {method:'POST', body: JSON.stringify(body)});
  if (!r.ok) { alert(await r.text()); return; }
  clearImgCache();
  load();
});
async function loadSetting() {
  const s = await (await fetch('/api/setting')).json();
  document.getElementById('win_ms').value = s.win_ms;
  document.getElementById('t_overlap').value = s.t_overlap;
  document.getElementById('freq_scale').value = s.freq_scale;
  document.getElementById('db_range').value = s.db_range;
}
loadSetting();
document.getElementById('tracks').addEventListener('click', async ev => {
  const lu = ev.target.getAttribute && ev.target.getAttribute('data-lufs');
  if (lu !== null && lu !== undefined) {
    ev.target.textContent = '…';
    try {
      const d = await (await fetch(`/api/loudness/${lu}`)).json();
      const txt = d.lufs === null ? 'silence' : `${d.lufs} LUFS` +
        (d.lra === null ? '' : ` / ${d.lra} LU`) +
        (d.dbtp === null ? '' : ` / ${d.dbtp} dBTP`);
      ev.target.replaceWith(Object.assign(document.createElement('span'),
        {textContent: txt,
         title: 'EBU R128: integrated loudness / loudness range / true peak',
         style: 'color:#aac;font-size:12px;margin:0 4px'}));
    } catch (e) { ev.target.textContent = 'LUFS?'; }
    return;
  }
  const alid = ev.target.getAttribute && ev.target.getAttribute('data-align');
  if (alid !== null && alid !== undefined) {
    ev.target.textContent = '\u2026';
    try {
      const ref = tracks[0].id;
      const d = await (await fetch(`/api/align/${alid}?ref=${ref}`)).json();
      const sgn = d.offset_s >= 0 ? '+' : '';
      ev.target.replaceWith(Object.assign(document.createElement('span'),
        {textContent: `${sgn}${d.offset_s.toFixed(4)}s vs #${ref}` +
           (d.confidence < 0.3 ? ' (low conf)' : ''),
         title: `confidence ${d.confidence}`,
         style: 'color:#aac;font-size:12px;margin:0 4px'}));
    } catch (e) { ev.target.textContent = 'align?'; }
    return;
  }
  const ky = ev.target.getAttribute && ev.target.getAttribute('data-key');
  if (ky !== null && ky !== undefined) {
    ev.target.textContent = '…';
    try {
      const d = await (await fetch(`/api/key/${ky}`)).json();
      ev.target.replaceWith(Object.assign(document.createElement('span'),
        {textContent: d.tonic === null ? 'atonal'
           : `${d.tonic} ${d.mode} (r=${d.r})`,
         style: 'color:#aac;font-size:12px;margin:0 4px'}));
    } catch (e) { ev.target.textContent = 'key?'; }
    return;
  }
  const an = ev.target.getAttribute && ev.target.getAttribute('data-an');
  if (an !== null && an !== undefined) {
    const btn = ev.target;
    btn.disabled = true; btn.textContent = '…';
    const poll = async () => {
      try {
        const r = await fetch(`/api/analyze/${an}`);
        if (r.status === 202) { setTimeout(poll, 1500); return; }
        if (!r.ok) throw new Error(await r.text());
        const d = await r.json();
        const parts = [];
        if (d.loudness_lufs !== null) parts.push(`${d.loudness_lufs} LUFS`);
        if (d.tempo_bpm) parts.push(`${d.tempo_bpm} BPM (${d.n_beats} beats)`);
        if (d.key) parts.push(`${d.key.tonic} ${d.key.mode}`);
        parts.push(`${d.n_onsets} onsets`);
        if (d.f0_median_hz !== null)
          parts.push(`f0 ${d.f0_median_hz} Hz (${Math.round(d.voiced_fraction * 100)}% voiced)`);
        if (d.segments_s.length) parts.push(`${d.segments_s.length + 1} sections`);
        parts.push(`active ${d.active_s[0]}–${d.active_s[1]} s`);
        const span = document.createElement('span');
        span.textContent = parts.join(' · ');
        span.title = JSON.stringify(d, null, 1);  // full report on hover
        span.style = 'color:#aac;font-size:12px;margin:0 4px';
        btn.replaceWith(span);
      } catch (e) { btn.textContent = 'analyze?'; btn.disabled = false; }
    };
    poll();
    return;
  }
  const rm = ev.target.getAttribute && ev.target.getAttribute('data-rm');
  if (rm === null || rm === undefined) return;
  await fetch('/api/remove', {method:'POST', body: JSON.stringify({id: +rm})});
  clearImgCache();
  load();
});
document.getElementById('tracks').addEventListener('change', async ev => {
  const cs = ev.target.getAttribute && ev.target.getAttribute('data-chsel');
  if (cs === null || cs === undefined) return;
  const v = ev.target.value;
  const channel = v === '' ? null : +v;
  const r = await fetch('/api/channel',
    {method:'POST', body: JSON.stringify({id: +cs, channel})});
  if (!r.ok) { alert(await r.text()); return; }
  clearImgCache();  // the track's pixels (and maybe the dB window) changed
  load();
});
document.getElementById('tracks').addEventListener('change', async ev => {
  const fx = ev.target.getAttribute && ev.target.getAttribute('data-fx');
  if (fx === null || fx === undefined) return;
  const op = ev.target.value;
  ev.target.value = '';
  if (!op) return;
  ev.target.disabled = true;
  try {
    const r = await fetch('/api/process',
      {method:'POST', body: JSON.stringify({id: +fx, op})});
    if (!r.ok) { alert(await r.text()); return; }
    const res = await r.json();
    if (res.detail) {  // e.g. declick: {repaired: N, skipped: M}
      const d = res.detail;
      document.getElementById('readout').textContent =
        `${op}: ${d.repaired} repaired` +
        (d.skipped ? `, ${d.skipped} edge span(s) left` : '');
    }
    clearImgCache();  // new track shifts the shared dB window
    load();
  } finally { ev.target.disabled = false; }
});
load();
</script></body></html>"""


class _RenderCache:
    """LRU of encoded image responses keyed by full request path+query.

    Panning back over a window the server just rendered used to re-pay
    the whole pipeline — device render, device->host fetch over the
    PCIe, PNG encode — for bytes it produced seconds ago
    (VERDICT r3 weak #6).  Every cache-able GET (the five image
    endpoints) now serves identical bytes straight from memory on
    re-entry.  Any session mutation (add/remove/set_setting) bumps
    ``gen``, which is part of the key, so stale pixels can never be
    served; capacity is bounded by bytes AND entries."""

    MAX_BYTES = 64 << 20
    MAX_ENTRIES = 256

    def __init__(self):
        from collections import OrderedDict

        self._d = OrderedDict()  # (gen, path) -> (ctype, body)
        self._bytes = 0
        self._lock = threading.Lock()
        self.gen = 0
        self.hits = 0
        self.misses = 0

    def bump_gen(self):
        """Invalidate everything (session state changed)."""
        with self._lock:
            self.gen += 1
            self._d.clear()
            self._bytes = 0

    def get(self, path):
        with self._lock:
            key = (self.gen, path)
            hit = self._d.get(key)
            if hit is None:
                self.misses += 1
                return None
            self._d.move_to_end(key)
            self.hits += 1
            return hit

    def put(self, path, ctype, body, gen=None):
        """``gen`` is the generation read at REQUEST START: if a session
        mutation landed while this response was being rendered, the gen
        no longer matches and the bytes are dropped instead of cached —
        the old put() keyed whatever was current at put time, so a
        render that straddled a mutation could be cached under the NEW
        generation and served stale forever (review finding, round 4).
        A skipped put is only a missed fill, never staleness."""
        if len(body) > self.MAX_BYTES // 4:
            return  # one giant render must not evict the whole cache
        with self._lock:
            if gen is not None and gen != self.gen:
                return
            key = (self.gen, path)
            if key in self._d:
                return
            self._d[key] = (ctype, body)
            self._bytes += len(body)
            while (self._bytes > self.MAX_BYTES
                   or len(self._d) > self.MAX_ENTRIES):
                _, (_, old) = self._d.popitem(last=False)
                self._bytes -= len(old)


class _RWLock:
    """Many concurrent readers OR one writer (writer-preferring).

    Render endpoints only READ session state (torch launches are thread-safe;
    the lazy per-track caches have their own small locks), so zoom/pan
    requests for different tracks no longer serialize behind one render —
    only session mutations (add/remove/set_setting) are exclusive.
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    class _Ctx:
        def __init__(self, lock, write):
            self._lock, self._write = lock, write

        def __enter__(self):
            self._lock._acquire(self._write)

        def __exit__(self, *exc):
            self._lock._release(self._write)

    def read(self):
        return self._Ctx(self, False)

    def write(self):
        return self._Ctx(self, True)

    def _acquire(self, write):
        with self._cond:
            if write:
                self._writers_waiting += 1
                while self._writer or self._readers:
                    self._cond.wait()
                self._writers_waiting -= 1
                self._writer = True
            else:
                while self._writer or self._writers_waiting:
                    self._cond.wait()
                self._readers += 1

    def _release(self, write):
        with self._cond:
            if write:
                self._writer = False
            else:
                self._readers -= 1
            self._cond.notify_all()


# image endpoints whose responses are pure functions of (session gen, URL)
_CACHEABLE = ("/api/spec/", "/api/wav/", "/api/spec_crop/",
              "/api/wav_crop/", "/api/adaptive_crop/", "/api/pitch/",
              "/api/formants/",
              "/api/loudness/", "/api/onsets/", "/api/beats/",
              "/api/segments/", "/api/key/", "/api/align/",
              "/api/notes/")
# routes that answer 400 for a bad parameter and 404 for an unknown track
# (the others answer 500, as msv_tpu's viewer does)
_CHECKED = ("/api/pitch/", "/api/formants/", "/api/segments/",
            "/api/notes/", "/api/key/", "/api/align/", "/api/analyze/",
            "/api/process")
ANALYZE_CAP_S = 600  # /api/analyze reads at most this much of a track
# POST /api/process's operations
PROCESS_OPS = ("denoise", "declick", "harmonic", "percussive", "separate",
               "specedit")


def analysis_window(n_samples, sr, start_s, end_s, cap_s):
    """The sample span ``[a, b)`` an analysis route reads: the request's
    window clipped to the track and to ``cap_s`` seconds from its start
    (a hostile span must not pin the device)."""
    a = min(max(0, int(start_s * sr)), n_samples)
    return a, min(n_samples, int(end_s * sr), a + cap_s * sr)


def display_rel(hz, sr, linear):
    """Hz as the 0..1 display position /api/freq's cursor readout maps:
    over Nyquist on the linear scale, else as mel (of f32 Hz) over
    Nyquist's mel, so an overlay lands where the readout reports that Hz.
    An array divides in its own dtype, a scalar in f64 (msv_tpu's pitch
    and formant routes, and its notes route)."""
    import numpy as np

    from .ops.mel import hz_to_mel

    half = np.float32(sr) / np.float32(2.0)
    if not linear:
        hz = hz_to_mel(np.asarray(hz, np.float32))
        hz = float(hz) if np.ndim(hz) == 0 else hz
        half = hz_to_mel(half)
    return hz / float(half)


def _error_status(path, e):
    from .utils.errors import TrackNotFoundError

    if path.startswith(_CHECKED):
        if isinstance(e, TrackNotFoundError):
            return 404
        if isinstance(e, ValueError):
            return 400
    return 500


class _Handler(BaseHTTPRequestHandler):
    session = None  # set by serve_viewer
    lock = None  # an _RWLock
    add_root = None  # restrict POST /api/add to this directory (None = any)
    loading = False  # True while the startup loader holds the write lock
    load_error = None  # set if the startup loader failed
    cache = None  # _RenderCache, created lazily per handler class

    def log_message(self, *a):  # quiet
        pass

    @classmethod
    def _cache(cls):
        c = cls.cache
        if c is None:
            c = cls.cache = _RenderCache()
        return c

    proc_dir = None  # server-owned temp dir for /api/process outputs

    @classmethod
    def _proc_dir(cls):
        d = cls.proc_dir
        if d is None:
            import atexit
            import shutil
            import tempfile

            d = cls.proc_dir = tempfile.mkdtemp(prefix="msv_proc_")
            # derived WAVs are full-length float32 (hundreds of MB for
            # hour tracks): reclaim them when the server process ends
            atexit.register(shutil.rmtree, d, ignore_errors=True)
        return d

    analyses = None  # per-server-class (gen, tid) -> analysis job dict

    @classmethod
    def _analyses(cls):
        a = cls.analyses
        if a is None:
            a = cls.analyses = ({}, threading.Lock())
        return a

    @staticmethod
    def _run_analysis(cls, key, tid):
        """Background worker for /api/analyze: snapshot the first
        ``ANALYZE_CAP_S`` of the signal under the read lock, then run the
        (long) analysis lock-free on the session's device."""
        from .features import analyze

        jobs, jlock = cls._analyses()
        try:
            with cls.lock.read():
                tr = cls.session._track(tid)
                sr = tr.sr
                n = min(tr.n_samples, ANALYZE_CAP_S * sr)
                wav = tr.wav_slice(0, n)
            rep = analyze(wav, sr, device=cls.session.device)
            rep["window_s"] = round(n / sr, 3)
            body, state = json.dumps(rep).encode(), "done"
        except Exception as e:  # surfaced as the endpoint's 500 body
            body, state = f"error: {e}".encode(), "error"
        with jlock:
            if key in jobs:  # not pruned by a mutation meanwhile
                jobs[key] = {"state": state, "body": body}

    def _process(self, body):
        """POST /api/process: run ``body["op"]`` on a loaded track's mono
        view on the session's device and add each output as a new track
        (float32 WAVs in the server-owned temp dir: no client path crosses
        the wire).  Returns the JSON answer."""
        import os as _os

        import numpy as np

        from .config import derive_stft_params
        from .io.audio import write_wav

        mt = self.session
        op = str(body.get("op", ""))
        if op not in PROCESS_OPS:
            raise ValueError(f"unknown op {op!r}: expected "
                             + " | ".join(PROCESS_OPS))
        if "id" not in body:
            raise ValueError("missing track id")
        sid = int(body["id"])
        with self.lock.read():
            tr = mt._track(sid)
            wav = np.asarray(tr.wav_slice(0, tr.n_samples), np.float32)
            sr = tr.sr
        p = derive_stft_params(sr, mt.setting)
        stft = (p.win_length, p.hop_length, p.n_fft)
        dev = {"device": mt.device}
        detail = None
        if op == "declick":
            from .ops.declick import declick

            rep, dspans, dskip = declick(wav, sr, **dev)
            outs = [rep]
            detail = {"repaired": len(dspans), "skipped": len(dskip)}
        elif op == "denoise":
            from .ops.denoise import denoise

            outs = [denoise(wav, *stft, sr=sr, **dev)]
        elif op == "specedit":
            # boxes in seconds x Hz, the schema of ops.specedit.Box dicts
            from .ops.specedit import Box, spectral_edit

            raw = body.get("boxes")
            if not isinstance(raw, list) or not raw or len(raw) > 32:
                raise ValueError(
                    "boxes must be a non-empty list of up to "
                    "32 {t0,t1,f0,f1[,gain_db][,mode]} dicts")
            try:
                boxes = [Box(float(b["t0"]), float(b["t1"]), float(b["f0"]),
                             float(b["f1"]), float(b.get("gain_db", -80.0)),
                             str(b.get("mode", "gain"))) for b in raw]
            except (KeyError, TypeError) as e:
                raise ValueError(f"bad box: {e!r}") from e
            outs = [spectral_edit(wav, sr, boxes, win_length=p.win_length,
                                  hop_length=p.hop_length, n_fft=p.n_fft,
                                  **dev)]
        elif op == "separate":
            from .ops.nmf import separate

            k = int(body.get("components", 2))
            if not 2 <= k <= 6:
                raise ValueError(f"components must be in [2, 6], got {k}")
            parts, _, _ = separate(wav, *stft, n_components=k, **dev)
            outs = list(parts[np.argsort(-(parts ** 2).sum(axis=1))])
        else:
            from .ops.hpss import hpss

            h, perc = hpss(wav, *stft, **dev)
            outs = [h if op == "harmonic" else perc]
        with self.lock.write():
            req_id = body.get("new_id")
            if req_id is not None and len(outs) > 1:
                raise ValueError("new_id only applies to single-output ops")
            if req_id is not None and int(req_id) in mt.tracks:
                # a re-add would REPLACE the track; this route ADDS one
                raise ValueError(f"new_id {int(req_id)} already loaded")
            nxt = (max(mt.tracks) + 1) if mt.tracks else 0
            new_ids = [int(req_id) if req_id is not None else nxt + j
                       for j in range(len(outs))]
            paths = [_os.path.join(self._proc_dir(),
                                   f"{op}{j}_{sid}_{new_id}.wav")
                     for j, new_id in enumerate(new_ids)]
            for out, path in zip(outs, paths):
                # float WAV: the derived track re-decodes bit-exactly
                write_wav(path, np.asarray(out, np.float32)[None], sr,
                          bits=32)
            mt.add_tracks(new_ids, paths)
        self._cache().bump_gen()
        resp = {"ok": True, "id": new_ids[0], "ids": new_ids, "op": op,
                "source": sid}
        if detail is not None:
            resp["detail"] = detail
        return resp

    def _window(self, tid, s0, s1, cap_s):
        """``(sr, a, samples, linear)`` of track ``tid`` over the
        :func:`analysis_window` of ``[s0, s1)`` s, read under the session's
        read lock with whether the display is on the linear scale."""
        from .config import FreqScale

        mt = self.session
        with self.lock.read():
            tr = mt._track(tid)
            a, b = analysis_window(tr.n_samples, tr.sr, s0, s1, cap_s)
            return (tr.sr, a, tr.wav_slice(a, b),
                    mt.setting.freq_scale == FreqScale.LINEAR)

    def _send_img(self, arr):
        """Encode + send a 200 image response, remembering the bytes so
        an identical request (same session generation) skips the render
        pipeline entirely."""
        body = self._png(arr)
        self._cache().put(self.path, "image/png", body,
                          gen=getattr(self, "_req_gen", None))
        self._send(200, "image/png", body)

    def _send(self, code, ctype, body):
        try:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            # client hung up mid-response (common for superseded renders);
            # nothing to salvage and nothing worth a traceback
            self.close_connection = True

    def _png(self, arr):
        from .io.png import encode_png

        return encode_png(arr)

    def do_GET(self):
        mt = self.session
        self._req_gen = self._cache().gen  # see _RenderCache.put
        url = urllib.parse.urlparse(self.path)
        q = urllib.parse.parse_qs(url.query)

        def qf(name, default, lo=-1e9, hi=1e9):
            # every numeric query param is range-checked: hostile/typo'd
            # values (px_per_sec=1e7 on an hour track derives ~36-billion-
            # column arrays; NaN poisons device math) must fail the request,
            # not the server (ADVICE r2)
            v = float(q.get(name, [default])[0])
            if not (lo <= v <= hi):  # NaN fails this too
                raise ValueError(f"{name} out of range [{lo}, {hi}]: {v}")
            return v

        def qh(name, default, cap=16384):
            # pixel-dimension params: bound them so a hostile/typo'd query
            # (height=1e9) cannot allocate gigabytes host-side
            return int(qf(name, default, 0, cap))

        def qpps():
            # the crop endpoints stay O(viewport) at any zoom, but the
            # full-width endpoints allocate O(px_per_sec * sec); the
            # session additionally hard-caps derived widths
            return qf("px_per_sec", 100.0, 0.0, 1e6)

        if (url.path.startswith(_CACHEABLE)
                and not self.__class__.loading):
            hit = self._cache().get(self.path)
            if hit is not None:
                self._send(200, hit[0], hit[1])
                return

        try:
            if url.path == "/" or url.path == "/index.html":
                self._send(200, "text/html; charset=utf-8", _PAGE.encode())
            elif (
                self.__class__.loading
                and url.path.startswith("/api/")
                # these never take the session lock; serve them normally
                and url.path not in ("/api/setting", "/api/colormap",
                                     "/api/colorbar")
            ):
                # the startup loader holds the write lock for as long as
                # the first decode and compute take — answer instead of
                # queueing behind it
                if url.path == "/api/tracks":
                    self._send(200, "application/json", json.dumps(
                        {"tracks": [], "loading": True,
                         "error": self.__class__.load_error}).encode())
                else:
                    self._send(503, "application/json",
                               b'{"error": "session loading"}')
            elif url.path == "/api/tracks":
                with self.lock.read():
                    body = json.dumps(
                        {
                            "tracks": [
                                {
                                    "id": i,
                                    "filename": mt.get_filename(i),
                                    "sec": mt.get_sec(i),
                                    "sr": mt.get_sr(i),
                                    # stereo support (extension over
                                    # lib.rs:42's sum-to-mono TODO)
                                    "channel": mt.get_channel(i),
                                    "n_channels": mt.get_n_channels(i),
                                }
                                for i in sorted(mt.tracks)
                            ],
                            "max_sec": mt.get_max_sec(),
                            "max_db": mt.get_max_db(),
                            "min_db": mt.get_min_db(),
                            # session generation: bumps on any mutation,
                            # from ANY client — lets every client drop
                            # its blob LRU when someone else mutates
                            "gen": self._cache().gen,
                        }
                    ).encode()
                self._send(200, "application/json", body)
            elif url.path.startswith("/api/spec/"):
                tid = int(url.path.rsplit("/", 1)[1])
                with self.lock.read():
                    img = mt.get_spec_image(
                        tid, qpps(), qh("height", 300)
                    )
                self._send_img(img)
            elif url.path.startswith("/api/wav/"):
                tid = int(url.path.rsplit("/", 1)[1])
                with self.lock.read():
                    img = mt.get_wav_image(
                        tid,
                        qpps(),
                        qh("height", 80),
                        qf("amp_min", -1.0, -1e6, 1e6),
                        qf("amp_max", 1.0, -1e6, 1e6),
                    )
                self._send_img(img)
            elif url.path.startswith("/api/audio/"):
                # audio playback (reference roadmap item "audio player",
                # ReadMe.md — unimplemented there): serve the mono mix as
                # a PCM16 WAV for the browser's <audio> element.  HTTP
                # Range requests are honored with O(range) work, so the
                # player can seek/stream an hour-scale track without the
                # server ever materializing its ~700 MB PCM (bytes are
                # converted from the track's carrier slice on demand).
                import struct as _struct

                import numpy as _np

                tid = int(url.path.rsplit("/", 1)[1])
                with self.lock.read():
                    track = mt._track(tid)  # typed 500, not a bare KeyError
                    n = track.n_samples
                    sr = track.sr
                pcm_len = n * 2
                hdr = b"RIFF" + _struct.pack("<I", 36 + pcm_len) + b"WAVE"
                hdr += b"fmt " + _struct.pack(
                    "<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16
                )
                hdr += b"data" + _struct.pack("<I", pcm_len)
                total = len(hdr) + pcm_len

                def _pcm_slice(s0, s1):
                    # identical bytes to the full-file encode of old: the
                    # int16/shift-15 carrier IS the PCM; anything else
                    # converts the f32 slice (O(slice), never the track)
                    raw = track._wav_int
                    if (raw is not None and raw.dtype == _np.int16
                            and track._wav_shift == 15):
                        return _np.ascontiguousarray(raw[s0:s1]).tobytes()
                    w = track.wav_slice(s0, s1)
                    return _np.clip(
                        w * 32768.0, -32768, 32767
                    ).astype("<i2").tobytes()

                def _file_bytes(a, b):
                    parts = []
                    if a < len(hdr):
                        parts.append(hdr[a:min(b, len(hdr))])
                    pa, pb = max(a - len(hdr), 0), b - len(hdr)
                    if pb > 0:
                        s0, s1 = pa // 2, min((pb + 1) // 2, n)
                        raw = _pcm_slice(s0, s1)
                        parts.append(raw[pa - 2 * s0: pa - 2 * s0 + pb - pa])
                    return b"".join(parts)

                rh = self.headers.get("Range", "")
                parsed = None
                if rh.startswith("bytes="):
                    try:
                        spec = rh[6:].split(",")[0].strip()
                        a_s, _, b_s = spec.partition("-")
                        if a_s:
                            parsed = (int(a_s),
                                      int(b_s) + 1 if b_s else total)
                        else:  # suffix form: last N bytes
                            parsed = (max(0, total - int(b_s)), total)
                    except ValueError:
                        parsed = None  # RFC 7233: ignore malformed -> 200
                if parsed is not None:
                    a, b = parsed
                    a, b = max(0, min(a, total)), max(0, min(b, total))
                    if b <= a:
                        self.send_response(416)
                        self.send_header("Content-Range", f"bytes */{total}")
                        self.send_header("Content-Length", "0")
                        self.end_headers()
                        return
                    body = _file_bytes(a, b)
                    try:
                        self.send_response(206)
                        self.send_header("Content-Type", "audio/wav")
                        self.send_header("Accept-Ranges", "bytes")
                        self.send_header(
                            "Content-Range", f"bytes {a}-{b - 1}/{total}"
                        )
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        self.wfile.write(body)
                    except (BrokenPipeError, ConnectionResetError):
                        self.close_connection = True
                    return
                body = _file_bytes(0, total)
                try:
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/wav")
                    self.send_header("Accept-Ranges", "bytes")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except (BrokenPipeError, ConnectionResetError):
                    self.close_connection = True
            elif url.path.startswith("/api/spec_crop/"):
                tid = int(url.path.rsplit("/", 1)[1])
                with self.lock.read():
                    img = mt.get_spec_image_crop(
                        tid,
                        qpps(),
                        qh("height", 300),
                        qf("start", 0.0, 0.0, 1e7),
                        qf("end", 10.0, 0.0, 1e7),
                    )
                self._send_img(img)
            elif url.path.startswith("/api/adaptive_crop/"):
                # adaptive multi-resolution STFT view (ReadMe.md:18
                # roadmap item, live) — same column math as spec_crop so
                # the client's two-stage fetch stitches pixel-exactly.
                # block=False: a zoomed-out view whose background full-dB
                # build hasn't covered this viewport yet answers 202 +
                # progress instead of stalling the request for the whole
                # (minutes at hour scale) build
                from .utils.errors import AdaptiveBuildPending

                tid = int(url.path.rsplit("/", 1)[1])
                try:
                    with self.lock.read():
                        img = mt.get_adaptive_spec_image_crop(
                            tid,
                            qpps(),
                            qh("height", 300),
                            qf("start", 0.0, 0.0, 1e7),
                            qf("end", 10.0, 0.0, 1e7),
                            block=False,
                        )
                except AdaptiveBuildPending as p:
                    self._send(202, "application/json", json.dumps({
                        "pending": True, "built": p.built, "total": p.total,
                    }).encode())
                    return
                self._send_img(img)
            elif url.path.startswith("/api/wav_crop/"):
                tid = int(url.path.rsplit("/", 1)[1])
                with self.lock.read():
                    img = mt.get_wav_image_crop(
                        tid,
                        qpps(),
                        qh("height", 80),
                        qf("amp_min", -1.0, -1e6, 1e6),
                        qf("amp_max", 1.0, -1e6, 1e6),
                        qf("start", 0.0, 0.0, 1e7),
                        qf("end", 10.0, 0.0, 1e7),
                    )
                self._send_img(img)
            elif url.path == "/api/colormap":
                # the 30-byte colormap export (lib.rs:473-480 FFI parity)
                from .render.colormap import get_colormap

                self._send(200, "application/octet-stream", get_colormap())
            elif url.path == "/api/setting":
                # live SpecSetting readout (lib.rs:64-70)
                from .config import FreqScale

                st = mt.setting
                body = json.dumps(
                    {
                        "win_ms": st.win_ms,
                        "t_overlap": st.t_overlap,
                        "f_overlap": st.f_overlap,
                        "freq_scale": "mel"
                        if st.freq_scale == FreqScale.MEL
                        else "linear",
                        "db_range": st.db_range,
                    }
                ).encode()
                self._send(200, "application/json", body)
            elif url.path == "/api/stats":
                # observability (SURVEY.md §5.e): stage timings + cache sizes
                with self.lock.read():
                    body = json.dumps(
                        {
                            "stage_timings": mt.timer.summary(),
                            "tracks": len(mt.tracks),
                            "sr_cache": sorted(mt._operands),
                            "env_states": len(mt._env_states),
                            "hbm": mt.hbm_stats(),
                            "adaptive_builds": mt.adaptive_build_progress(),
                            "render_cache": {
                                "hits": self._cache().hits,
                                "misses": self._cache().misses,
                                "entries": len(self._cache()._d),
                            },
                        }
                    ).encode()
                self._send(200, "application/json", body)
            elif url.path == "/api/colorbar":
                from .render.colormap import colorbar

                img = colorbar(qh("width", 24), qh("height", 300),
                               device=mt.device)
                self._send(200, "image/png", self._png(img))
            elif url.path.startswith("/api/freq/"):
                tid = int(url.path.rsplit("/", 1)[1])
                rel = qf("rel", 0.5, -10.0, 10.0)
                force_mel = q.get("mel", ["0"])[0] == "1"
                with self.lock.read():
                    if force_mel:
                        # the adaptive view is mel-scaled regardless of
                        # the session scale; the session mapping would
                        # misreport Hz on it in linear-scale sessions
                        import numpy as _np

                        from .ops.mel import hz_to_mel, mel_to_hz

                        half = _np.float32(mt._track(tid).sr) / _np.float32(2)
                        hz = float(
                            mel_to_hz(hz_to_mel(half) * _np.float32(rel))
                        )
                    else:
                        hz = mt.get_frequency_hz(tid, rel)
                self._send(200, "application/json", json.dumps({"hz": hz}).encode())
            elif url.path.startswith("/api/pitch/"):
                # f0 contour over a bounded time window (ops/pitch.py
                # YIN): {"t0", "hop_s", "f0": Hz, "ap", "rel"} — "rel"
                # is the 0..1 display position mirroring /api/freq's
                # cursor mapping, so the client overlay lands exactly
                # where the readout would report that Hz.  Cacheable:
                # rides the render LRU keyed by session generation.
                import numpy as _np

                from .ops.pitch import yin

                tid = int(url.path.rsplit("/", 1)[1])
                fmin = qf("fmin", 65.0, 10.0, 4000.0)
                fmax = qf("fmax", 2093.0, 20.0, 20000.0)
                s0 = qf("start", 0.0, 0.0, 1e7)
                s1 = qf("end", s0 + 30.0, 0.0, 1e7)
                force_mel = q.get("mel", ["0"])[0] == "1"
                # 120 s of audio per request (the client asks per viewport)
                sr, a, wav, linear = self._window(tid, s0, s1, 120)
                if len(wav) < 1:
                    self._send(200, "application/json", json.dumps(
                        {"t0": a / sr, "hop_s": 512 / sr, "f0": [],
                         "ap": [], "rel": []}).encode())
                    return
                fmax_eff = min(fmax, sr / 2.0 * 0.99)
                if fmax_eff <= fmin:
                    raise ValueError(
                        f"fmin {fmin} too high for sr {sr}")
                f0, ap = yin(wav, sr, fmin=fmin, fmax=fmax_eff,
                             with_aperiodicity=True, device=mt.device)
                f0 = f0.cpu().numpy()
                ap = ap.cpu().numpy()
                if q.get("smooth", ["0"])[0] == "1":
                    # Viterbi decode (ops/sequence.py): snapped contour
                    # + voicing mask, exposed through the same wire —
                    # ap becomes 0/1 so the client's pen-lift threshold
                    # needs no change
                    from .ops.sequence import smooth_f0_viterbi

                    f0, voiced = smooth_f0_viterbi(
                        f0, ap, fmin=fmin, fmax=fmax_eff, device=mt.device)
                    ap = _np.where(voiced, 0.0, 1.0).astype(_np.float32)
                rel = display_rel(f0, sr, linear and not force_mel)
                body = json.dumps({
                    "t0": a / sr, "hop_s": 512 / sr,
                    "f0": [round(float(v), 2) for v in f0],
                    "ap": [round(float(v), 3) for v in ap],
                    "rel": [round(float(v), 4) for v in rel],
                }).encode()
                self._cache().put(self.path, "application/json", body,
                                  gen=self._req_gen)
                self._send(200, "application/json", body)
            elif url.path.startswith("/api/formants/"):
                # Praat-style formant tracks over a bounded window
                # (ops/lpc.py: autocorrelation LPC -> all-pole envelope
                # -> ordered grid peaks).  Same wire shape idea as
                # /api/pitch but with K parallel contours; NaN gaps
                # travel as nulls (JSON has no NaN).
                import numpy as _np

                from .ops.lpc import formant_track

                tid = int(url.path.rsplit("/", 1)[1])
                nf = max(1, min(int(qf("n", 4, 1, 8)), 8))
                fmax = qf("fmax", 5500.0, 500.0, 20000.0)
                s0 = qf("start", 0.0, 0.0, 1e7)
                s1 = qf("end", s0 + 30.0, 0.0, 1e7)
                force_mel = q.get("mel", ["0"])[0] == "1"
                sr, a, wav, linear = self._window(tid, s0, s1, 120)
                if len(wav) < sr // 20:
                    self._send(200, "application/json", json.dumps(
                        {"t0": a / sr, "hop_s": 0.01, "f": [],
                         "rel": []}).encode())
                    return
                f, hop_s, _t0 = formant_track(
                    wav, sr, n_formants=nf, fmax=min(fmax, sr / 2.0),
                    device=mt.device)
                f = f.cpu().numpy()
                rel = display_rel(f, sr, linear and not force_mel)
                ok = _np.isfinite(f)
                body = json.dumps({
                    "t0": a / sr, "hop_s": hop_s,
                    "f": [[round(float(v), 1) if o else None
                           for v, o in zip(row, okr)]
                          for row, okr in zip(f, ok)],
                    "rel": [[round(float(v), 4) if o else None
                             for v, o in zip(row, okr)]
                            for row, okr in zip(rel, ok)],
                }).encode()
                self._cache().put(self.path, "application/json", body,
                                  gen=self._req_gen)
                self._send(200, "application/json", body)
            elif url.path.startswith("/api/onsets/"):
                # onset times over a bounded window (features.py
                # spectral-flux novelty); viewport-sized like /api/pitch
                # and LRU-cached under the same generation rules
                from .features import onset_detect

                tid = int(url.path.rsplit("/", 1)[1])
                s0 = qf("start", 0.0, 0.0, 1e7)
                s1 = qf("end", s0 + 30.0, 0.0, 1e7)
                delta = qf("delta", 3.0, 0.1, 100.0)
                sr, a, wav, _ = self._window(tid, s0, s1, 120)
                if len(wav) < sr // 10:
                    body = json.dumps({"t": []}).encode()
                else:
                    times = onset_detect(wav, sr, delta=delta,
                                         device=mt.device)
                    body = json.dumps({
                        "t": [round(a / sr + float(v), 3) for v in times]
                    }).encode()
                self._cache().put(self.path, "application/json", body,
                                  gen=self._req_gen)
                self._send(200, "application/json", body)
            elif url.path.startswith("/api/beats/"):
                # tempo + beat grid over a bounded window (ops/rhythm.py:
                # tempogram -> log-normal prior -> Ellis DP); viewport-
                # sized and LRU-cached like /api/onsets
                from .ops.rhythm import beat_track

                tid = int(url.path.rsplit("/", 1)[1])
                s0 = qf("start", 0.0, 0.0, 1e7)
                s1 = qf("end", s0 + 30.0, 0.0, 1e7)
                sr, a, wav, _ = self._window(tid, s0, s1, 120)
                if len(wav) < sr:  # < 1 s: no meaningful tempo
                    body = json.dumps({"bpm": 0.0, "t": []}).encode()
                else:
                    bpm, beats = beat_track(wav, sr, device=mt.device)
                    body = json.dumps({
                        "bpm": round(float(bpm), 1),
                        "t": [round(a / sr + float(v), 3) for v in beats],
                    }).encode()
                self._cache().put(self.path, "application/json", body,
                                  gen=self._req_gen)
                self._send(200, "application/json", body)
            elif url.path.startswith("/api/segments/"):
                # structure boundaries over a bounded window
                # (ops/segment.py: pooled log-mel -> SSM GEMM -> Foote
                # novelty -> absolute-threshold peaks); windows up to
                # 600 s (vs 120 s elsewhere: structure needs horizon,
                # and the pooled T stays ~1200 frames)
                from .ops.segment import segment

                tid = int(url.path.rsplit("/", 1)[1])
                s0 = qf("start", 0.0, 0.0, 1e7)
                s1 = qf("end", s0 + 120.0, 0.0, 1e7)
                sr, a, wav, _ = self._window(tid, s0, s1, 600)
                if len(wav) < 4 * sr:  # < 4 s: no meaningful structure
                    body = json.dumps({"t": []}).encode()
                else:
                    # horizon adapts to the window so zoomed-in views
                    # still resolve local structure
                    ks = max(1.5, min(8.0, len(wav) / sr / 4.0))
                    bounds = segment(wav, sr, hop_s=0.5, kernel_s=ks,
                                     device=mt.device)
                    body = json.dumps({
                        "t": [round(a / sr + float(v), 3) for v in bounds],
                    }).encode()
                self._cache().put(self.path, "application/json", body,
                                  gen=self._req_gen)
                self._send(200, "application/json", body)
            elif url.path.startswith("/api/notes/"):
                # transcribed note events over a bounded window
                # (ops/transcribe.py): piano-roll bars for the client.
                # "rel" maps each note's hz through the same display
                # mapping as /api/pitch so the bar lands where the
                # cursor readout would report that Hz.
                from .ops.transcribe import transcribe_notes

                tid = int(url.path.rsplit("/", 1)[1])
                s0 = qf("start", 0.0, 0.0, 1e7)
                s1 = qf("end", s0 + 30.0, 0.0, 1e7)
                fmin = qf("fmin", 65.0, 10.0, 4000.0)
                fmax = qf("fmax", 2093.0, 20.0, 20000.0)
                force_mel = q.get("mel", ["0"])[0] == "1"
                sr, a, wav, linear = self._window(tid, s0, s1, 120)
                fmax_eff = min(fmax, sr / 2.0 * 0.99)
                if fmax_eff <= fmin:
                    raise ValueError(f"fmin {fmin} too high for sr {sr}")
                notes = ([] if len(wav) < sr // 4 else transcribe_notes(
                    wav, sr, fmin=fmin, fmax=fmax_eff, device=mt.device))
                for nt in notes:
                    nt["start"] = round(nt["start"] + a / sr, 6)
                    nt["end"] = round(nt["end"] + a / sr, 6)
                    nt["rel"] = round(float(display_rel(
                        nt["hz"], sr, linear and not force_mel)), 4)
                body = json.dumps({"notes": notes}).encode()
                self._cache().put(self.path, "application/json", body,
                                  gen=self._req_gen)
                self._send(200, "application/json", body)
            elif url.path.startswith("/api/key/"):
                # Krumhansl-Schmuckler key of the track's mono view
                # (ops/tonal.py); on-demand (client button) + LRU-
                # cached.  Bounded: chroma over the first 10 min is
                # plenty of evidence for a global key.
                from .ops.tonal import estimate_key

                tid = int(url.path.rsplit("/", 1)[1])
                with self.lock.read():
                    tr = mt._track(tid)
                    sr = tr.sr
                    wav = tr.wav_slice(0, min(tr.n_samples, 600 * sr))
                tonic, mode, r, _ = estimate_key(wav, sr, device=mt.device)
                body = json.dumps({
                    "tonic": tonic, "mode": mode,
                    "r": None if tonic is None else round(r, 3),
                }).encode()
                self._cache().put(self.path, "application/json", body,
                                  gen=self._req_gen)
                self._send(200, "application/json", body)
            elif url.path.startswith("/api/align/"):
                # cross-track offset (ops/align.py NCC + GCC-PHAT):
                # /api/align/<id>?ref=<rid> answers how much later <id>'s
                # content occurs than <rid>'s, on the same mono views the
                # audio player uses.  LRU-cached; viewport-independent.
                from .ops.align import align_offset

                tid = int(url.path.rsplit("/", 1)[1])
                rid = int(q.get("ref", ["0"])[0])
                max_lag = float(q.get("max_lag", ["30"])[0])
                if not 0 < max_lag <= 600:
                    raise ValueError("max_lag outside (0, 600] s")
                with self.lock.read():
                    ta, tb = mt._track(rid), mt._track(tid)
                    wa = ta.wav_slice(0, ta.n_samples)
                    wb = tb.wav_slice(0, tb.n_samples)
                    sra, srb = ta.sr, tb.sr
                r = align_offset(wa, sra, wb, srb, max_lag_s=max_lag,
                                 device=mt.device)
                body = json.dumps({
                    "ref": rid, "id": tid,
                    "offset_s": round(r.offset_s, 6),
                    "confidence": round(r.confidence, 4),
                    "coarse_s": round(r.coarse_s, 4),
                }).encode()
                self._cache().put(self.path, "application/json", body,
                                  gen=self._req_gen)
                self._send(200, "application/json", body)
            elif url.path.startswith("/api/loudness/"):
                # EBU R128 numbers of the track's mono view — the SAME
                # signal /api/audio plays (channel sum or the selected
                # channel), so they match what you hear: integrated
                # LUFS, loudness range (LU), true peak (dBTP).
                # On-demand (client button) + LRU-cached; the chunked
                # K-weighting keeps memory bounded at any track length.
                from .ops.loudness import r128_stats

                tid = int(url.path.rsplit("/", 1)[1])
                with self.lock.read():
                    tr = mt._track(tid)
                    wav = tr.wav_slice(0, tr.n_samples)
                    sr = tr.sr
                body = json.dumps(r128_stats(wav, sr,
                                             device=mt.device)).encode()
                self._cache().put(self.path, "application/json", body,
                                  gen=self._req_gen)
                self._send(200, "application/json", body)
            elif url.path.startswith("/api/analyze/"):
                # The analyze report (features.analyze) of the track's mono
                # view over its first ANALYZE_CAP_S, as a background job:
                # 202 {"pending": true} until ready, then 200 with the
                # JSON.  Jobs are keyed by the session generation, as the
                # response cache is, so a mutation never serves a stale
                # report.
                tid = int(url.path.rsplit("/", 1)[1])
                with self.lock.read():
                    mt._track(tid)  # unknown ids -> 404
                jobs, jlock = self._analyses()
                key = (self._req_gen, tid)
                with jlock:
                    cur = self._cache().gen
                    for k in [k for k in jobs if k[0] != cur]:
                        del jobs[k]  # superseded by a session mutation
                    job = jobs.get(key)
                    if job is None and key[0] == cur:
                        job = jobs[key] = {"state": "running",
                                           "body": None}
                        threading.Thread(
                            target=self._run_analysis,
                            args=(self.__class__, key, tid),
                            daemon=True).start()
                if job is None or job["state"] == "running":
                    self._send(202, "application/json",
                               b'{"pending": true}')
                elif job["state"] == "done":
                    self._send(200, "application/json", job["body"])
                else:
                    self._send(500, "text/plain", job["body"])
            else:
                self._send(404, "text/plain", b"not found")
        except Exception as e:  # surface errors to the client, keep serving
            self._send(_error_status(url.path, e), "text/plain",
                       f"error: {e}".encode())

    def do_POST(self):
        """Session management (the reference's add_tracks/remove_track FFI
        surface, lib.rs:170,265, as HTTP endpoints)."""
        mt = self.session
        url = urllib.parse.urlparse(self.path)
        if self.__class__.loading:
            # mutations would queue behind the startup loader's write lock
            # for minutes with no feedback — refuse instead
            self._send(503, "application/json",
                       b'{"error": "session loading"}')
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(length) or b"{}")
            if url.path == "/api/add":
                import os as _os

                req_path = str(body["path"])
                if self.add_root is not None:
                    real = _os.path.realpath(req_path)
                    rroot = _os.path.realpath(self.add_root)
                    if not (real == rroot or real.startswith(rroot + _os.sep)):
                        self._send(
                            403, "text/plain",
                            f"error: path outside --add-root ({rroot})".encode(),
                        )
                        return
                ch = body.get("channel")
                if ch is not None:
                    ch = int(ch)
                    if not (0 <= ch <= 255):
                        raise ValueError("channel out of range")
                with self.lock.write():
                    tid = int(body["id"])
                    changed = mt.add_tracks([tid], [req_path],
                                            channels=[ch])
                self._cache().bump_gen()  # dB window/track set changed
                self._send(
                    200, "application/json",
                    json.dumps({"ok": True, "changed": bool(changed)}).encode(),
                )
            elif url.path == "/api/remove":
                with self.lock.write():
                    changed = mt.remove_track(int(body["id"]))
                self._cache().bump_gen()
                self._send(
                    200, "application/json",
                    json.dumps({"ok": True, "changed": bool(changed)}).encode(),
                )
            elif url.path == "/api/channel":
                # switch a loaded track's channel view (sum-to-mono when
                # channel is null) — re-adds the track's OWN path, so no
                # filesystem path crosses the wire and --add-root is moot
                ch = body.get("channel")
                if ch is not None:
                    ch = int(ch)
                with self.lock.write():
                    tid = int(body["id"])
                    tr_path = mt.get_path(tid)
                    if ch is not None and not (
                        0 <= ch < mt.get_n_channels(tid)
                    ):
                        raise ValueError(
                            f"channel {ch} out of range "
                            f"(track has {mt.get_n_channels(tid)})"
                        )
                    changed = mt.add_tracks([tid], [tr_path],
                                            channels=[ch])
                self._cache().bump_gen()
                self._send(
                    200, "application/json",
                    json.dumps({"ok": True, "changed": bool(changed)}).encode(),
                )
            elif url.path == "/api/process":
                self._send(200, "application/json",
                           json.dumps(self._process(body)).encode())
            elif url.path == "/api/setting":
                # live settings: merge partial fields into the current
                # SpecSetting and re-derive every track (lib.rs:57-61
                # reload semantics, which the reference never calls)
                import dataclasses

                from .config import FreqScale, SpecSetting

                cur = mt.setting
                fs = body.get("freq_scale")
                new = dataclasses.replace(
                    cur,
                    win_ms=float(body.get("win_ms", cur.win_ms)),
                    t_overlap=int(body.get("t_overlap", cur.t_overlap)),
                    f_overlap=int(body.get("f_overlap", cur.f_overlap)),
                    db_range=float(body.get("db_range", cur.db_range)),
                    freq_scale=(
                        FreqScale.MEL if fs == "mel"
                        else FreqScale.LINEAR if fs == "linear"
                        else cur.freq_scale
                    ),
                )
                if not (1 <= new.t_overlap <= 64) or not (
                    1 <= new.win_ms <= 2000
                ) or not (1 <= new.db_range <= 400):
                    raise ValueError("setting out of range")
                with self.lock.write():
                    changed = mt.set_setting(new)
                self._cache().bump_gen()
                self._send(
                    200, "application/json",
                    json.dumps({"ok": True, "changed": bool(changed)}).encode(),
                )
            else:
                self._send(404, "text/plain", b"not found")
        except Exception as e:
            self._send(_error_status(url.path, e), "text/plain",
                       f"error: {e}".encode())


def serve_viewer(paths, port: int = 8080, setting=None,
                 host: str = "127.0.0.1", add_root: str | None = None,
                 channel: int | None = None, *, device="cuda"):
    """Load tracks and serve the viewer UI.  Blocks.

    Binds loopback by default: POST /api/add takes filesystem paths and
    GET /api/audio streams decoded files, so exposing the server to the
    network would let any peer read decodable files on this host (the
    reference is a local Electron app with no network surface).  Pass an
    explicit ``host`` ("" / "0.0.0.0") to opt in to remote access, and
    ``add_root`` to confine /api/add to one directory tree.  The session
    computes on ``device`` (default the card; "cpu" runs the plain
    PyTorch versions) and request threads share it.
    """
    from .session import MultiTrack

    mt = MultiTrack(setting, device=device)
    lock = _RWLock()
    handler = type("H", (_Handler,), {"session": mt, "lock": lock,
                                      "add_root": add_root})
    # bind BEFORE the initial decode+compute: a first add of long files can
    # take a while (decode, the kernels' first build), and a silent pre-bind
    # hang is indistinguishable from a crash.  The API serves immediately;
    # tracks appear as the loader thread (an ordinary writer) lands them.
    srv = ThreadingHTTPServer((host, port), handler)
    shown = host or "0.0.0.0"
    print(f"msv_tpu_torch viewer on http://{shown}:{port}  "
          f"(loading {len(paths)} tracks)", flush=True)
    load_err: list = []
    if paths:
        handler.loading = True

        def _load():
            try:
                with lock.write():
                    mt.add_tracks(list(range(len(paths))), list(paths),
                                  channels=[channel] * len(paths))
            except Exception as e:  # surface instead of dying silently
                load_err.append(e)
                handler.load_error = str(e)
                handler.loading = False
                srv.shutdown()  # fail visibly, like the old sync path
                return
            handler.loading = False
            print(f"{len(paths)} tracks ready", flush=True)

        threading.Thread(target=_load, daemon=True).start()
    srv.serve_forever()
    if load_err:
        raise load_err[0]
