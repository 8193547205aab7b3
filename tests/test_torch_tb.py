"""The port's tfevents writer (``distributedmnist_tpu_torch/obsv/tb.py``)
against the reference's (``distributedmnist_tpu/obsv/tb.py``): the
CRC32C test vectors, event files byte for byte equal for the same
scalars with the clock fixed (the reference's ``tests/test_tb.py``
reads those bytes back through TensorBoard's own loader), and the
Trainer's scalars on ``train.summary_every_steps``, read back through a
minimal record parser that checks every CRC."""

import struct
import time

import pytest

from distributedmnist_tpu.obsv import tb as ref_tb
from distributedmnist_tpu_torch.core.config import ExperimentConfig
from distributedmnist_tpu_torch.obsv import tb
from distributedmnist_tpu_torch.train.loop import Trainer

from _torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("data,crc", [
    (b"", 0x0), (b"123456789", 0xE3069283), (bytes(32), 0x8A9136AA),
    (bytes(range(32)), 0x46DD794E)])
def test_crc32c_known_vectors(data, crc):
    # RFC 3720 test vectors for CRC32C
    assert tb.crc32c(data) == crc == ref_tb.crc32c(data)


def _write(mod, log_dir):
    w = mod.SummaryWriter(log_dir)
    w.add_scalars({"train/loss": 0.5, "train/accuracy": 0.25}, step=10,
                  wall_time=123.0)
    w.add_scalar("train/loss", 0.125, step=20)
    w.add_scalars({"Validation Accuracy": 0.98, "Validation Loss": 0.07},
                  step=2**40)
    w.close()
    (path,) = log_dir.glob("events.out.tfevents.*")
    return path.read_bytes()


def test_event_file_bytes_equal_reference(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    assert _write(tb, tmp_path / "port") == _write(ref_tb, tmp_path / "ref")
    w = tb.SummaryWriter(tmp_path / "closed")
    w.close()
    with pytest.raises(RuntimeError, match="closed"):
        w.add_scalar("x", 1.0, step=1)


def _records(path):
    """(length-checked) payloads of a tfevents file, each record's two
    masked CRCs verified."""
    data = path.read_bytes()
    out, i = [], 0
    while i < len(data):
        header = data[i:i + 8]
        (n,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", data[i + 8:i + 12])[0] == \
            tb._masked_crc(header)
        payload = data[i + 12:i + 12 + n]
        assert struct.unpack("<I", data[i + 12 + n:i + 16 + n])[0] == \
            tb._masked_crc(payload)
        out.append(payload)
        i += 16 + n
    return out


def test_trainer_writes_train_scalars(tmp_path):
    cfg = ExperimentConfig.from_dict({
        "data": {"dataset": "synthetic", "batch_size": 32,
                 "synthetic_train_size": 256, "synthetic_test_size": 64,
                 "use_native_pipeline": False},
        "model": {"compute_dtype": "float32"}, "mesh": {"num_replicas": 1},
        "train": {"max_steps": 4, "log_every_steps": 2,
                  "summary_every_steps": 2, "save_interval_steps": 0,
                  "save_results_period": 0,
                  "train_dir": str(tmp_path / "run")}})
    Trainer(cfg, device="cpu").run()
    (path,) = (tmp_path / "run" / "tb").glob("events.out.tfevents.*")
    payloads = _records(path)
    assert b"brain.Event:2" in payloads[0]
    assert len(payloads) == 3  # the version record, steps 2 and 4
    for p in payloads[1:]:
        for tag in (b"train/loss", b"train/accuracy",
                    b"train/learning_rate", b"train/examples_per_sec",
                    b"train/num_contributors"):
            assert tag in p
