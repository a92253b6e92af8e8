"""Spectrogram and waveform renders (host clock, ending in the fetch of
the image), milliseconds an image request: the session's
``get_spec_image.render`` and ``get_wav_image.render`` stages over the
window's requests."""


def read(run):
    n = run.counts["requests"]
    total = sum(run.stages.get(k, (0, 0.0))[1]
                for k in ("get_spec_image.render", "get_wav_image.render"))
    if not n or not total:
        return None
    return 1e3 * total / n
