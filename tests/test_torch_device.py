"""The port's entry points run on CUDA unless the caller asks for the
CPU: with no GPU and no explicit ``"cpu"`` they raise — they never fall
back silently (``distributedmnist_tpu_torch/core/device.py``)."""

import threading

import numpy as np
import pytest
import torch

from distributedmnist_tpu_torch.core.device import cudnn_policy, resolve_device
from distributedmnist_tpu_torch.launch.__main__ import build_replica
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
    from distributedmnist_tpu_torch.core.config import ExperimentConfig
    from distributedmnist_tpu_torch.models.registry import get_model
    from distributedmnist_tpu_torch.quant import (QuantPublisher,
                                                  build_tier_predict,
                                                  calibrate_tiers)
    cfg = ExperimentConfig.from_dict({"model": {"name": "mnist_cnn"}})
    model = get_model(cfg.model)
    params = {"fc2": {"w": np.zeros((4, 10), np.float32),
                      "b": np.zeros(10, np.float32)}}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        QuantPublisher(model, cfg, np.zeros((2, 28, 28, 1), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calibrate_tiers(model, params, {},
                        np.zeros((2, 28, 28, 1), np.float32))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_tier_predict(model, "int8", None)


def test_cli_serves_decode_only(no_cuda, tmp_path):
    """``serve`` boots the decode replica with ``--decode`` and, since
    classification serving was ported, the classification replica
    without it: on CUDA by default, so here it raises; a verb other
    than ``serve`` is refused."""
    from distributedmnist_tpu_torch.core.config import ExperimentConfig
    from distributedmnist_tpu_torch.models.convert import \
        params_to_reference
    from distributedmnist_tpu_torch.models.registry import get_model
    from distributedmnist_tpu_torch.train.checkpoint import save_checkpoint
    cfg = ExperimentConfig.from_dict({"model": {"name": "mnist_cnn"}})
    params = get_model(cfg.model).init_params(0, torch.device("cpu"))
    save_checkpoint(tmp_path, params_to_reference(params), 1,
                    extra={"config": cfg.to_dict()})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_replica(["serve", "--train-dir", str(tmp_path)])
    with pytest.raises(SystemExit):
        build_replica(["train", "--config", "x.json"])


def test_cudnn_policy_one_thread_at_a_time():
    """cuDNN's flags are process-wide: a second thread's policy (the
    checkpoint writer's calibration, a serving batcher) waits until the
    first has restored them, so neither leaves its setting behind."""
    cudnn = torch.backends.cudnn
    before = (cudnn.deterministic, cudnn.allow_tf32)
    inside, release, seen = threading.Event(), threading.Event(), []

    def first():
        with cudnn_policy(True, False):
            inside.set()
            release.wait(timeout=10)

    def second():
        with cudnn_policy(False, True):
            seen.append((cudnn.deterministic, cudnn.allow_tf32))

    a = threading.Thread(target=first)
    a.start()
    assert inside.wait(timeout=10)
    b = threading.Thread(target=second)
    b.start()
    b.join(timeout=0.3)
    assert b.is_alive() and not seen  # waits for the first to exit
    release.set()
    a.join(timeout=10)
    b.join(timeout=10)
    assert not a.is_alive() and not b.is_alive()
    assert seen == [(False, True)]
    assert (cudnn.deterministic, cudnn.allow_tf32) == before
