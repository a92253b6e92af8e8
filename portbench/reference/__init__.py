"""Plain reference of what the viewer shows: the mel dB plane of a track,
the session's dB window, and the spectrogram and waveform crops.

Plain PyTorch and NumPy in float32 with TF32 off.  It imports nothing of
the program under test (nor JAX), and works everything out again from the
samples the benchmark generated.
"""
