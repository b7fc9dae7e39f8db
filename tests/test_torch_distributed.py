"""``gsmvi_tpu_torch.parallel.initialize_distributed`` and the mesh's need
for a process group, the counterpart of ``tests/test_distributed.py``.

The process group is process-global, so every case that starts one runs in
spawned processes (``tests/torch_mesh_ranks.py``, through
``parallel.distributed.launch`` with a timeout); the cases that start
nothing run here.
"""

import socket

import pytest
import torch
import torch.distributed as dist

from gsmvi_tpu_torch.parallel import initialize_distributed, make_mesh
from gsmvi_tpu_torch.parallel.distributed import default_backend, launch

JOIN_TIMEOUT_S = 60


def _spawn(fn, nprocs, *args):
    launch(fn, nprocs, *args, timeout=JOIN_TIMEOUT_S)


def test_two_ranks_form_a_group(tmp_path):
    import torch_mesh_ranks

    _spawn(torch_mesh_ranks.two_rank_group, 2, str(tmp_path))
    for rank in range(2):
        got = torch.load(tmp_path / f"two_{rank}.pt", weights_only=False)
        assert got == {"ok": True, "again": True, "world": 2, "sum": 3.0}


def test_explicit_misconfiguration_raises(tmp_path):
    import torch_mesh_ranks

    _spawn(torch_mesh_ranks.misconfigured, 1, str(tmp_path))
    got = torch.load(tmp_path / "misconfigured.pt", weights_only=False)
    assert got.startswith("raised"), got


def test_auto_reads_torchrun_environment(tmp_path):
    """A one-rank torchrun environment starts the group (returns False:
    not distributed)."""
    import torch_mesh_ranks

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    _spawn(torch_mesh_ranks.torchrun_env, 1, str(tmp_path), port)
    got = torch.load(tmp_path / "auto.pt", weights_only=False)
    assert got == {"ok": False, "up": True}


def test_nothing_requested_starts_nothing(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed() is False
    assert initialize_distributed(auto=True) is False
    assert not dist.is_initialized()


def test_mesh_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        make_mesh(1, devices="cpu")


def test_backend_follows_the_machine():
    assert default_backend() == ("nccl" if torch.cuda.is_available()
                                 else "gloo")
