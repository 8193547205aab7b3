"""The port's entry points run on CUDA unless the caller asks for the
CPU: with no GPU and no explicit ``"cpu"`` they raise — they never fall
back silently (``distributedmnist_tpu_torch/core/device.py``)."""

import numpy as np
import pytest
import torch

from distributedmnist_tpu_torch.core.device import resolve_device
from distributedmnist_tpu_torch.launch.__main__ import build_decode_replica
from distributedmnist_tpu_torch.models.convert import params_from_reference
from distributedmnist_tpu_torch.servesvc import DecodeReplica


@pytest.fixture
def no_cuda(monkeypatch):
    """A machine without CUDA, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_entry_points_default_to_cuda(no_cuda, tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DecodeReplica(tmp_path / "train", serve_dir=tmp_path / "serve")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_reference({"embed": np.zeros((2, 2)), "blocks": []})
    assert params_from_reference({"embed": np.zeros((2, 2)), "blocks": []},
                                 device="cpu")["embed"].device.type == "cpu"


def test_cli_serves_decode_only(tmp_path):
    with pytest.raises(SystemExit):
        build_decode_replica(["serve", "--train-dir", str(tmp_path)])
