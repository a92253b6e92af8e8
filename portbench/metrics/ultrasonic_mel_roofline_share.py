"""The mel dB function's share of its roofline at 192 kHz and above, %:
the least time of those tracks' planes (``roofline.mel_work`` at the card's
peaks) times the opens, over the device time of the kernels, not copies or
sets, that start inside the groups' ``add_tracks.kernel_minmax`` stages
that launched the mel kernel at those rates (``ultrasonic_mel_ms.open``'s
stages: a ``mel.launch`` span ends before its kernel does, its stage ends
in the group's sync).  The least time counts the function, an FFT of
n_fft points a frame, so any later implementation is held to the same
floor."""

from portbench import registry, roofline

_ms = registry.metric("ultrasonic_mel_ms.open")
_linear = registry.metric("linear_roofline_share")


def read(run):
    got = _ms.ultrasonic_stages(run)
    if not got or not run.events or not run.counts["opens"]:
        return None
    ns = _linear.kernel_ns(run.events, got)
    if not ns:
        return None
    least = sum(roofline.least_seconds(*roofline.mel_work(
        t["pcm"].shape[1], t["sr"], run.config["setting"]))
        for t in run.tracks if t["sr"] >= _ms.MIN_SR)
    return 100.0 * run.counts["opens"] * least / (ns / 1e9)
