"""PNG encode, milliseconds an image: the harness's span around each
``io.png.encode_png`` call of the opens' first screens."""


def read(run):
    calls, total = run.spans.get("encode_png", (0, 0.0))
    if not calls or not run.counts["opens"]:
        return None
    return 1e3 * total / calls
