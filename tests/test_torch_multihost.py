"""The port's multi-process mesh (``msv_tpu_torch/parallel/multihost.py``)
against msv_tpu's sharded pipelines, mirroring tests/test_multihost.py.

Two processes join one gloo process group on localhost, each with four
``cpu`` devices, and build global meshes over the eight: (2, 4), where each
process holds one dp row, and (1, 8), where the sp row spans both
processes, so the halo of the fourth shard and the envelope's halos cross
them (``dist.batch_isend_irecv``) and the dB range and the frequency sum
are all-reduced.  Each process saves the shards it holds; this process
checks that together they cover the result, and holds it to msv_tpu's on
its 8-device CPU mesh: dB planes by tests/test_parallel.py's
``_assert_db_close``, the dB max within 1e-4 and the min within 0.05 dB,
the envelope bit for bit.  The two processes are the only ones spawned,
bounded by ``communicate(timeout=240)``.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from msv_tpu_torch.parallel.multihost import (assign_tracks_by_host,  # noqa: E402
                                              initialize_distributed,
                                              make_global_mesh)

_RUNNER = r"""
import sys
pid, port, repo, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
sys.path.insert(0, repo)
import numpy as np
import torch
torch.set_num_threads(2)
from msv_tpu_torch.parallel.multihost import (
    assign_tracks_by_host, initialize_distributed, make_global_mesh)
initialize_distributed(f"127.0.0.1:{port}", num_processes=2, process_id=pid)
import torch.distributed as dist
from msv_tpu_torch.config import SpecSetting, derive_stft_params
from msv_tpu_torch.ops.dft import windowed_dft_matrices
from msv_tpu_torch.ops.framing import n_frames_for, reflect_pad_center
from msv_tpu_torch.ops.mel import calc_mel_fb_default
from msv_tpu_torch.ops.windows import default_stft_window
from msv_tpu_torch.parallel.sharded import (
    freq_sharded_spec, sharded_envelope_minmax, sharded_spec_pipeline,
    sharded_streaming_spec_db)

assert dist.get_world_size() == 2 and dist.get_rank() == pid
cpu4 = [torch.device("cpu")] * 4
mine = assign_tracks_by_host(["a", "b", "c"])
assert mine == (["a", "c"] if pid == 0 else ["b"]), mine

p = derive_stft_params(16000, SpecSetting())
c, s = windowed_dft_matrices(default_stft_window(p.win_length, p.n_fft),
                             p.n_fft)
fb = calc_mel_fb_default(16000, p.n_fft)
rng = np.random.default_rng(7)
B, L = 2, 16000
wavs = rng.standard_normal((B, L)).astype(np.float32) * 0.3
n_frames = n_frames_for(L, p.win_length, p.hop_length)
padded = np.stack([reflect_pad_center(w, p.win_length) for w in wavs])
need = (n_frames + 8) * p.hop_length + p.win_length
padded = np.pad(padded, ((0, 0), (0, need - padded.shape[1])))
i16 = (rng.standard_normal(16000 * 2) * 8000).astype(np.int16)
env = (rng.standard_normal(48000) * 0.3).astype(np.float32)

def shards(a):
    return [([(i.start, i.stop) for i in sh.index], sh.data)
            for sh in a.addressable_shards]

res = {}
for shape in ((2, 4), (1, 8)):
    mesh = make_global_mesh(*shape, local_devices=cpu4)
    assert [int(r) for r in mesh.ranks.flat] == [0] * 4 + [1] * 4
    db, lo, hi, n_total = sharded_spec_pipeline(
        mesh, padded, p.win_length, p.hop_length, c, s, fb, n_frames)
    res[f"spec{shape}"] = (shards(db), float(lo), float(hi), n_total)
mesh = make_global_mesh(1, 8, local_devices=cpu4)
db, n, lo, hi = sharded_streaming_spec_db(
    mesh, i16, p.win_length, p.hop_length, c, s, fb, chunk_frames=32)
res["stream"] = (shards(db), lo, hi, n)
res["freq_mel"] = freq_sharded_spec(mesh, wavs[0], p.win_length,
                                    p.hop_length, c, s, fb)[0]
res["freq_lin"] = freq_sharded_spec(mesh, wavs[0], p.win_length,
                                    p.hop_length, c, s, None)[0]
res["env"] = [torch.from_numpy(a) for a in sharded_envelope_minmax(
    mesh, env, 441)]
torch.save(res, f"{out}/rank{pid}.pt")
dist.destroy_process_group()
print(f"MULTIHOST_OK pid={pid}", flush=True)
"""


def test_helpers_single_process():
    cpu8 = [torch.device("cpu")] * 8
    initialize_distributed(num_processes=1)  # no-op path
    paths = [f"f{i}.wav" for i in range(7)]
    assert assign_tracks_by_host(paths) == paths
    assert assign_tracks_by_host(paths, 0, 1) == paths
    parts = [assign_tracks_by_host(paths, i, 3) for i in range(3)]
    assert sorted(sum(parts, [])) == sorted(paths)  # a partition
    assert not (set(parts[0]) & set(parts[1]))
    mesh = make_global_mesh(2, 4, local_devices=cpu8)
    assert mesh.shape == {"dp": 2, "sp": 4}
    assert (mesh.ranks == 0).all()


def _whole(shard_list, shape):
    out = torch.full(shape, float("nan"))
    for index, data in shard_list:
        out[tuple(slice(a, b) for a, b in index)] = data
    return out


def test_two_process_distributed_pipelines(tmp_path):
    pytest.importorskip("jax")
    from msv_tpu.parallel import make_mesh
    from msv_tpu.parallel.sharded import (freq_sharded_spec,
                                          sharded_envelope_minmax,
                                          sharded_spec_pipeline,
                                          sharded_streaming_spec_db)
    from test_parallel import _assert_db_close

    runner = tmp_path / "runner.py"
    runner.write_text(_RUNNER)
    with socket.socket() as s:  # free localhost port for the store
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [
        subprocess.Popen(
            [sys.executable, str(runner), str(pid), port, repo,
             str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)
    ]
    outs = []
    for pr in procs:
        try:
            out, _ = pr.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, f"process {pid} failed:\n{out[-3000:]}"
        assert f"MULTIHOST_OK pid={pid}" in out, out[-3000:]
    res = [torch.load(tmp_path / f"rank{pid}.pt") for pid in (0, 1)]

    # the same inputs as the runner's, through msv_tpu
    from msv_tpu_torch.config import SpecSetting, derive_stft_params
    from msv_tpu_torch.ops.dft import windowed_dft_matrices
    from msv_tpu_torch.ops.framing import n_frames_for, reflect_pad_center
    from msv_tpu_torch.ops.mel import calc_mel_fb_default
    from msv_tpu_torch.ops.windows import default_stft_window

    p = derive_stft_params(16000, SpecSetting())
    win, hop = p.win_length, p.hop_length
    c, s = windowed_dft_matrices(default_stft_window(win, p.n_fft), p.n_fft)
    fb = calc_mel_fb_default(16000, p.n_fft)
    rng = np.random.default_rng(7)
    wavs = rng.standard_normal((2, 16000)).astype(np.float32) * 0.3
    n_frames = n_frames_for(16000, win, hop)
    padded = np.stack([reflect_pad_center(w, win) for w in wavs])
    need = (n_frames + 8) * hop + win
    padded = np.pad(padded, ((0, 0), (0, need - padded.shape[1])))
    i16 = (rng.standard_normal(16000 * 2) * 8000).astype(np.int16)
    env = (rng.standard_normal(48000) * 0.3).astype(np.float32)

    for shape in ((2, 4), (1, 8)):
        jdb, jlo, jhi, jn = sharded_spec_pipeline(
            make_mesh(*shape), padded, win, hop, c, s, fb, n_frames)
        jdb = np.asarray(jdb)
        key = f"spec{shape}"
        # each process holds its own dp row (2, 4) or half the sp row
        assert [len(r[key][0]) for r in res] == [4, 4]
        got = _whole(res[0][key][0] + res[1][key][0], jdb.shape).numpy()
        _assert_db_close(got[:, :n_frames], jdb[:, :n_frames])
        for r in res:
            assert r[key][3] == jn
            assert r[key][2] == pytest.approx(float(jhi), abs=1e-4)
            assert r[key][1] == pytest.approx(float(jlo), abs=0.05)
    jmesh = make_mesh(1, 8)
    jdb, jn, jlo, jhi = sharded_streaming_spec_db(jmesh, i16, win, hop, c, s,
                                                  fb, chunk_frames=32)
    jdb = np.asarray(jdb)
    got = _whole(res[0]["stream"][0] + res[1]["stream"][0], jdb.shape)
    _assert_db_close(got.numpy()[:jn], jdb[:jn])
    for r in res:
        assert r["stream"][3] == jn
        assert abs(r["stream"][2] - jhi) < 1e-4
        assert abs(r["stream"][1] - jlo) < 0.05
    for key, m in (("freq_mel", fb), ("freq_lin", None)):
        want = np.asarray(freq_sharded_spec(jmesh, wavs[0], win, hop, c, s,
                                            m)[0])
        for r in res:
            _assert_db_close(r[key].numpy(), want)
    jmx, jmn = sharded_envelope_minmax(jmesh, env, 441)
    for r in res:
        np.testing.assert_array_equal(r["env"][0].numpy(), jmx)
        np.testing.assert_array_equal(r["env"][1].numpy(), jmn)
