"""Batched audio data pipeline: files -> device feature batches, ported
from ``msv_tpu/data.py``.

Thousands of mixed-codec, mixed-rate files become fixed-shape device
batches without the card waiting on the host:

  * a thread pool decodes ahead (the WAV/FLAC/Ogg/MP3 decoders, the
    port's native C++ ones included, release the GIL in their C/numpy
    cores, so ``workers`` > 1 overlaps real work);
  * clips are grouped by SOURCE sample rate and padded/truncated to
    ``clip_seconds`` at the source rate, so every batch is one of a few
    fixed shapes;
  * each group is stacked in pinned host memory, copied to the device
    without waiting (``non_blocking``) and resampled to ``target_sr`` there
    (``ops/resample.py``), then feeds any feature fn;
  * one-batch lookahead: while the device runs batch k, the pool decodes
    k+1.  Nothing in the iterator waits for the device, so the overlap is
    real.

The iterator yields ``(batch, metas)`` — a (B, L) float32 tensor on
``device`` at ``target_sr`` plus one :class:`ClipMeta` per row.  Batches
arrive grouped by source rate (order within a group follows the input
order); ``metas`` says which file each row is.  Decode failures raise by
default or are skipped (and reported on ``.errors``) with
``on_error='skip'``.  Everything but ``AudioBatcher._assemble`` and the
``device`` arguments is msv_tpu's code, pinned by tests/test_torch_data.py.
"""

import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from .io.audio import open_audio_mono_ex
from .ops.resample import resample
from .utils.errors import AudioReadError


@dataclass(frozen=True)
class ClipMeta:
    """Provenance of one batch row."""
    path: str
    sr: int          # source rate (before device resampling)
    n_samples: int   # decoded length at the source rate (pre pad/trunc)
    n_channels: int
    truncated: bool


class AudioBatcher:
    """Iterate fixed-shape feature-ready device batches over ``paths``.

    Example::

        from msv_tpu_torch.data import AudioBatcher
        from msv_tpu_torch import whisper_log_mel
        for batch, metas in AudioBatcher(paths, target_sr=16000,
                                         clip_seconds=30.0, batch_size=16):
            feats = whisper_log_mel(batch)   # (B, 80, 3000), on device

    ``channel`` selects one source channel (default: channel sum, the
    session convention).  The last batch of each source-rate group may
    be short (its true size = ``len(metas)``); pass
    ``drop_remainder=True`` to keep every batch exactly ``batch_size``
    (dropped clips are listed on ``.dropped``).  ``device`` is where the
    batches go (default "cuda"; "cpu" runs the plain versions).
    """

    def __init__(
        self,
        paths,
        *,
        target_sr: int = 16000,
        clip_seconds: float = 30.0,
        batch_size: int = 16,
        workers: int = 4,
        channel: int | None = None,
        drop_remainder: bool = False,
        on_error: str = "raise",
        device="cuda",
    ):
        self.paths = list(paths)
        if not self.paths:
            raise ValueError("paths is empty")
        if target_sr <= 0 or clip_seconds <= 0 or batch_size < 1:
            raise ValueError(
                f"bad target_sr/clip_seconds/batch_size: "
                f"{target_sr}/{clip_seconds}/{batch_size}"
            )
        if on_error not in ("raise", "skip"):
            raise ValueError(f"on_error must be 'raise'|'skip': {on_error!r}")
        self.target_sr = int(target_sr)
        self.clip_seconds = float(clip_seconds)
        self.batch_size = int(batch_size)
        self.workers = max(1, int(workers))
        self.channel = channel
        self.drop_remainder = bool(drop_remainder)
        self.on_error = on_error
        self.errors: list[tuple[str, str]] = []   # (path, message), 'skip'
        self.dropped: list[str] = []              # drop_remainder leftovers
        self._lock = threading.Lock()
        self.device = torch.device(device)
        self._in_flight = []  # (copy's event, pinned host batch)

    # ----------------------------------------------------------- decode

    def _decode(self, path: str):
        # channel sum / select + bounds check live in the canonical loader
        wav, sr, _, _, n_ch = open_audio_mono_ex(path, channel=self.channel)
        n = len(wav)
        want = int(round(self.clip_seconds * sr))
        truncated = n > want
        if truncated:
            wav = wav[:want]
        elif n < want:
            wav = np.pad(wav, (0, want - n))
        meta = ClipMeta(path=path, sr=sr, n_samples=n,
                        n_channels=n_ch, truncated=truncated)
        return np.ascontiguousarray(wav, np.float32), meta

    def _decode_guarded(self, path: str):
        try:
            return self._decode(path)
        except AudioReadError as e:
            if self.on_error == "raise":
                raise
            with self._lock:
                self.errors.append((path, str(e)))
            return None

    # ------------------------------------------------------------ batch

    def _assemble(self, group):
        """Decoded same-sr clips -> (device batch at target_sr, metas).

        One stack in pinned host memory, one ``non_blocking`` copy to the
        device and the resample there: no step waits for the device.  The
        pinned batch is held, with its copy's event, until that copy has
        ended."""
        wavs, metas = zip(*group)
        host = torch.from_numpy(np.stack(wavs))
        if self.device.type == "cuda":
            host = host.pin_memory()
            self._in_flight = [(e, h) for e, h in self._in_flight
                               if not e.query()]
            batch = host.to(self.device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream(self.device))
            self._in_flight.append((copied, host))
        else:
            batch = host.to(self.device)
        sr = metas[0].sr
        if sr != self.target_sr:
            batch = resample(batch, sr, self.target_sr)
        return batch, list(metas)

    def __iter__(self):
        """Decode ahead with the pool; group by source sr; yield one
        batch while the NEXT one's decodes are already in flight."""
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            futures = [pool.submit(self._decode_guarded, p)
                       for p in self.paths]
            pending: dict[int, list] = {}   # sr -> [(wav, meta), ...]
            ready = []                      # full groups awaiting yield
            for fut in futures:
                item = fut.result()
                if item is None:
                    continue
                sr = item[1].sr
                pending.setdefault(sr, []).append(item)
                if len(pending[sr]) == self.batch_size:
                    ready.append(self._assemble(pending.pop(sr)))
                # lookahead of one: keep at most one assembled batch in
                # hand so the device result is consumed while the pool
                # decodes ahead
                while len(ready) > 1:
                    yield ready.pop(0)
            for sr in sorted(pending):
                group = pending[sr]
                if self.drop_remainder and len(group) < self.batch_size:
                    with self._lock:
                        self.dropped.extend(m.path for _, m in group)
                    continue
                ready.append(self._assemble(group))
            yield from ready



def extract_features(paths, feature_fn, *, target_sr: int = 16000,
                     clip_seconds: float = 30.0, batch_size: int = 16,
                     workers: int = 4, channel: int | None = None,
                     on_error: str = "raise", device="cuda"):
    """One-call dataset -> features: run ``feature_fn(batch)`` over every
    batch and return ``(list_of_feature_rows, list_of_ClipMeta)`` in
    matching order.  ``feature_fn`` is any frontend call taking a (B, L)
    device array at ``target_sr`` — e.g.
    ``lambda b: whisper_log_mel(b)`` or
    ``lambda b: log_mel_spectrogram(b, 16000)``.  Rows are fetched to
    host (np.ndarray); keep results on device by iterating
    :class:`AudioBatcher` yourself.
    """
    batcher = AudioBatcher(
        paths, target_sr=target_sr, clip_seconds=clip_seconds,
        batch_size=batch_size, workers=workers, channel=channel,
        on_error=on_error, device=device,
    )
    rows, metas = [], []
    for batch, ms in batcher:
        out = feature_fn(batch)
        out = (out.cpu().numpy() if isinstance(out, torch.Tensor)
               else np.asarray(out))
        rows.extend(out)
        metas.extend(ms)
    if batcher.errors:
        # surfaced, not silent: callers opted into skip but still get
        # the full account
        import logging

        logging.getLogger("msv_tpu.data").warning(
            "%d/%d files skipped: %s", len(batcher.errors),
            len(batcher.paths),
            "; ".join(f"{p}: {m}" for p, m in batcher.errors[:5]),
        )
    return rows, metas
