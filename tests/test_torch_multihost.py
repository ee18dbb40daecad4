"""The port's runtime bootstrap (mmlspark_tpu_torch/parallel/mesh.py), the
counterpart of tests/test_multihost.py: two real processes rendezvous
through `initialize_runtime` over a TCP coordinator, a psum crosses them,
and their 2-process GBDT fit equals the one-process fit on both. Then the
mesh's own bookkeeping in this process, where no process group exists:
a one-shard mesh, its labels, its row blocks and its overrides.
"""

import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from mmlspark_tpu_torch.parallel import mesh as M  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "test_torch_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_rendezvous_psum_and_fit():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([REPO] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                                                  else []))
    env.update(COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}", WORLD_SIZE="2")
    procs = [subprocess.Popen([sys.executable, WORKER], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=REPO,
                              env=dict(env, RANK=str(rank)))
             for rank in range(2)]
    results = {}
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"worker failed:\n{err[-2000:]}"
            for line in out.splitlines():
                if line.startswith("RESULT"):
                    kv = dict(tok.split("=") for tok in line.split()[1:])
                    results[int(kv["rank"])] = kv
    finally:
        # one worker failing must not leave its sibling blocked in the
        # rendezvous for the rest of the test run
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait(timeout=10)
    assert set(results) == {0, 1}
    for rank, kv in results.items():
        assert kv["world"] == "2" and kv["shards"] == "2" and kv["shard"] == str(rank)
        assert float(kv["psum"]) == 3.0          # 1 + 2, across the processes
        assert kv["equal_local"] == "1"          # the replicated model is the local one
    assert results[0]["model_hash"] == results[1]["model_hash"]


def test_single_process_mesh_is_one_shard():
    """No coordinator: initialize_runtime does nothing, and get_mesh() is a
    one-shard mesh whose fit is the fit without a mesh."""
    saved = os.environ.pop("COORDINATOR_ADDRESS", None)
    try:
        M.initialize_runtime()
    finally:
        if saved is not None:
            os.environ["COORDINATOR_ADDRESS"] = saved
    assert not torch.distributed.is_initialized()
    mesh = M.get_mesh()
    assert mesh.size == 1 and mesh.shard_index == 0 and mesh.shape == {"data": 1, "model": 1}
    assert M.mesh_shape_label(mesh) == "1x1" and M.mesh_shape_label(None) == "1"
    assert M.mesh_device_count(mesh) == 1 and M.mesh_device_count(None) == 1
    with pytest.raises(ValueError, match="needs 2 processes"):
        M.make_mesh(n_data=2)
    with pytest.raises(ValueError, match="cannot split"):
        M.split_mesh(mesh, 2)
    assert [m.ranks for m in M.split_mesh(mesh, 1)] == [(0,)]


def test_shard_rows_pads_and_blocks():
    """A rank's block of P(DATA): rows padded to a multiple of the shards
    (pad_value), shard s holding rows [s * n_pad / S, (s + 1) * n_pad / S)."""
    arr = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    block, n = M.shard_rows(arr, M.make_mesh(), device="cpu")
    assert n == 10 and torch.equal(block, torch.from_numpy(arr))
    four = M.Mesh(ranks=(0, 1, 2, 3))          # shard 0 of a 4-shard table
    assert M.shard_bounds(10, four) == (12, 0, 3)
    block, n = M.shard_rows(arr, four, pad_value=-1, device="cpu")
    np.testing.assert_array_equal(block.numpy(), arr[:3])
    with pytest.raises(ValueError, match="distinct"):
        M.Mesh(ranks=(0, 0))


def test_use_mesh_is_thread_local():
    default = M.get_mesh()
    other = M.Mesh(ranks=(0,))
    seen = {}

    def probe():
        seen["thread"] = M.get_mesh()

    with M.use_mesh(other):
        assert M.get_mesh() is other
        t = threading.Thread(target=probe)
        t.start()
        t.join()
    assert seen["thread"] is default and M.get_mesh() is default
    M.set_default_mesh(other)
    try:
        assert M.get_mesh() is other
    finally:
        M.set_default_mesh(None)
    assert M.get_mesh().size == 1
