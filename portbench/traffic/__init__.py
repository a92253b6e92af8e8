"""Traffic kinds: each module drives one kind of use of the viewer, with
``setup(run)``, ``window(run, state, seconds)`` (returns the end-to-end
readings) and ``outputs(run, state)`` (what the window produced, on the
host, for the comparison; it frees the program's state).  A traffic mix
is a ``<name>.json`` here that names its ``kind`` and holds its
parameters."""
