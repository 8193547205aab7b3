"""The port's post-training quantization (``distributedmnist_tpu_torch/
quant/ptq.py``) and its sidecars (``train/checkpoint.py``) against the
reference's ``quant/ptq.py`` on the CPU, for the MNIST CNN at its
published widths with params carried across by ``models/convert.py``:

* the int8 leaves and the bf16 words are the reference's bit for bit,
  and so are the sidecar files and their ``.sha256`` for the same state
  (``publish_ms``, a timing, pinned to 0 on both sides by a constant
  clock); each package reads the other's sidecar;
* ``tree_params_digest`` is the reference's and the artifact's params
  digest;
* each tier's predict agrees with the reference's ``build_tier_predict``
  (fp32 and int8 within 1e-5 of the probabilities; bf16, whose
  activations round to bfloat16 in two different libraries, within
  2e-2 and equal top-1 on all but one example in 64);
* ``calibrate_tiers`` gives the reference's verdicts, a refusal at a
  tiny ``parity_epsilon`` included;
* the port Trainer with ``quant.publish_tiers`` writes a sidecar before
  each artifact (synchronous and writer-thread saves), whose source
  digest is the artifact's and whose tiers are the artifact params'.
"""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from distributedmnist_tpu.core.config import ExperimentConfig as RefConfig
from distributedmnist_tpu.models.registry import get_model as ref_get_model
from distributedmnist_tpu.parallel.api import init_train_state
from distributedmnist_tpu.quant import ptq as ref_ptq
from distributedmnist_tpu.train import checkpoint as ref_ckpt
from distributedmnist_tpu_torch.core.config import ExperimentConfig
from distributedmnist_tpu_torch.models.convert import params_from_reference
from distributedmnist_tpu_torch.models.registry import get_model
from distributedmnist_tpu_torch.quant import ptq
from distributedmnist_tpu_torch.train import checkpoint as ckpt
from distributedmnist_tpu_torch.train.loop import Trainer

from _torch_threads import one_torch_thread  # noqa: F401

PROB_TOL = {"fp32": 1e-5, "int8": 1e-5, "bf16": 2e-2}
CALIB = 64


def _cfgs(**quant):
    d = {"model": {"name": "mnist_cnn", "compute_dtype": "float32"},
         "quant": {"publish_tiers": "int8,bf16",
                   "calibration_examples": CALIB, **quant}}
    return RefConfig.from_dict(d), ExperimentConfig.from_dict(d)


@pytest.fixture(scope="module")
def cnn():
    """Reference CNN params (numpy) and calibration images from a seed."""
    ref_cfg, _ = _cfgs()
    state = init_train_state(ref_get_model(ref_cfg.model), ref_cfg)
    params = jax.tree.map(np.asarray, jax.device_get(state.params))
    rng = np.random.default_rng(0)
    images = (rng.random((CALIB, 28, 28, 1)) - 0.5).astype(np.float32)
    labels = rng.integers(0, 10, CALIB).astype(np.int32)
    return params, images, labels


@pytest.fixture
def fixed_clock(monkeypatch):
    for mod in (ptq, ref_ptq):
        monkeypatch.setattr(mod.time, "perf_counter", lambda: 0.0)


@pytest.mark.parametrize("shape,zero_channel", [
    ((5, 5, 1, 32), False), ((3136, 512), False), ((512, 10), True),
    ((3, 4, 5), True)])
def test_quantize_leaf_int8_bitwise(shape, zero_channel):
    w = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    if zero_channel:
        w[..., 0] = 0.0
    got, want = ptq.quantize_leaf_int8(w), ref_ptq.quantize_leaf_int8(w)
    for k in ("q", "scale"):
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k
    if zero_channel:
        assert (got["scale"][..., 0] == 1.0).all()


def test_bf16_words_and_fake_quant_bitwise():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(64, 28, 28, 1)).astype(np.float32) * 3
    tree = ptq.cast_tree_bf16({"w": x})
    assert tree["w"].dtype == torch.bfloat16
    assert (tree["w"].view(torch.int16).numpy().tobytes()
            == x.astype(ml_dtypes.bfloat16).tobytes())
    got = ptq.dynamic_input_fake_quant(torch.from_numpy(x)).numpy()
    want = np.asarray(ref_ptq.dynamic_input_fake_quant(jnp.asarray(x)))
    assert got.tobytes() == want.tobytes()


def test_params_digest_is_the_references_and_the_artifacts(cnn, tmp_path):
    params = cnn[0]
    digest = ptq.tree_params_digest(ckpt.to_state_dict(params))
    assert digest == ref_ptq.tree_params_digest(params)
    ckpt.save_checkpoint(tmp_path, params, 3)
    assert ckpt.checkpoint_params_digest(tmp_path) == (digest, 3)


@pytest.mark.parametrize("tiers", ["int8", "bf16", "int8,bf16"])
def test_sidecar_bytes_equal_the_references(cnn, tmp_path, fixed_clock,
                                            tiers):
    params = cnn[0]
    for arm in ("ref", "port"):
        (tmp_path / arm).mkdir()
    ref_cfg, cfg = _cfgs(publish_tiers=tiers, calibration_examples=0)
    ref_pub = ref_ptq.QuantPublisher(ref_get_model(ref_cfg.model), ref_cfg,
                                     params, None)
    pub = ptq.QuantPublisher(get_model(cfg.model), cfg, None,
                             device="cpu")
    ref_meta = ref_pub.publish(tmp_path / "ref", ("full", {"params": params}),
                               7)
    meta = pub.publish(tmp_path / "port", {"params": params}, 7)
    assert meta == ref_meta
    for sfx in ("", ".sha256"):
        name = "ckpt-00000007.quant.msgpack" + sfx
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "ref" / name).read_bytes()), name
    # each package reads the other's sidecar; bf16 stays 2-byte words
    got = ckpt.read_quant_sidecar(tmp_path / "ref", 7)
    assert got["meta"] == ref_meta
    if "bf16" in got["tiers"]:
        w = got["tiers"]["bf16"]["fc1"]["w"]
        assert w.dtype == torch.bfloat16
        assert (w.view(torch.int16).numpy().tobytes()
                == params["fc1"]["w"].astype(ml_dtypes.bfloat16).tobytes())
    back = ref_ckpt.read_quant_sidecar(tmp_path / "port", 7)
    assert back["meta"] == meta
    assert ckpt.quant_sidecar_digest(tmp_path / "port", 7) == \
        ref_ckpt.quant_sidecar_digest(tmp_path / "ref", 7)


def test_torn_and_absent_sidecars_are_refused(cnn, tmp_path):
    _, cfg = _cfgs(calibration_examples=0)
    ptq.QuantPublisher(get_model(cfg.model), cfg, None, device="cpu"
                       ).publish(tmp_path, {"params": cnn[0]}, 2)
    with pytest.raises(FileNotFoundError):
        ckpt.read_quant_sidecar(tmp_path, 4)
    path = ckpt.quant_sidecar_path(tmp_path, 2)
    path.write_bytes(path.read_bytes()[:1000])
    with pytest.raises(ckpt.CheckpointCorruptError):
        ckpt.read_quant_sidecar(tmp_path, 2)


@pytest.mark.parametrize("tier", ["fp32", "int8", "bf16"])
def test_tier_predict_matches_the_references(cnn, tier):
    params, images, _ = cnn
    ref_cfg, cfg = _cfgs()
    if tier == "bf16":  # the serving replica's bf16 tier computes in bf16
        ref_cfg = ref_cfg.override({"model.compute_dtype": "bfloat16"})
        cfg = cfg.override({"model.compute_dtype": "bfloat16"})
    tree = {"fp32": lambda p: p, "int8": ref_ptq.quantize_tree_int8,
            "bf16": ref_ptq.cast_tree_bf16}[tier](params)
    ref_predict = jax.jit(ref_ptq.build_tier_predict(
        ref_get_model(ref_cfg.model), params, tier))
    want = np.asarray(ref_predict(tree, images))
    port_tree = params_from_reference(
        {"fp32": lambda p: p, "int8": ptq.quantize_tree_int8,
         "bf16": ptq.cast_tree_bf16}[tier](params), device="cpu")
    got = ptq.build_tier_predict(get_model(cfg.model), tier, "cpu")(
        port_tree, images).numpy()
    assert got.shape == want.shape == (CALIB, 10)
    assert np.abs(got - want).max() <= PROB_TOL[tier]
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agree >= (1.0 if tier != "bf16" else 1 - 1 / CALIB)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Params after 2 port steps on the synthetic split, and its 128
    test images: one example's top-1 moves under each tier (random
    weights predict one class for every image, which no tier moves)."""
    d = tmp_path_factory.mktemp("trained")
    tr = Trainer(_train_cfg(d, max_steps=2, save_interval_steps=0,
                            publish_tiers=""), device="cpu")
    tr.run()
    test = tr.datasets.test
    return ckpt.restore_params(d)[0], test.images, test.labels


@pytest.mark.parametrize("epsilon", [0.02, 1e-9])
def test_calibration_verdicts_equal_the_references(trained, tmp_path,
                                                   epsilon):
    params, images, labels = trained
    for arm in ("ref", "port"):
        (tmp_path / arm).mkdir()
    ref_cfg, cfg = _cfgs(parity_epsilon=epsilon,
                         calibration_examples=len(images))
    ref_pub = ref_ptq.QuantPublisher(ref_get_model(ref_cfg.model), ref_cfg,
                                     params, images, labels)
    pub = ptq.QuantPublisher(get_model(cfg.model), cfg, images, labels,
                             device="cpu")
    ref_meta = ref_pub.publish(tmp_path / "ref", ("full", {"params": params}),
                               5)
    meta = pub.publish(tmp_path / "port", {"params": params}, 5)
    assert pub.refused == ref_pub.refused
    if epsilon < 1e-6:
        assert pub.refused  # a tier moved some top-1: refused
    if ref_meta is None:
        assert meta is None
        return
    assert meta["tiers"] == ref_meta["tiers"]
    for tier in ("int8", "bf16"):
        got, want = meta["calibration"][tier], ref_meta["calibration"][tier]
        assert got["agreement"] == want["agreement"], tier
        assert got["top1_ref"] == want["top1_ref"]
        assert got["top1_tier"] == want["top1_tier"]
        assert abs(got["max_abs_prob_delta"]
                   - want["max_abs_prob_delta"]) <= 1e-4
    assert meta["calibration"]["input_amax"] == \
        ref_meta["calibration"]["input_amax"]


def test_publish_is_idempotent_and_never_raises(cnn, tmp_path):
    _, cfg = _cfgs(calibration_examples=0)
    pub = ptq.QuantPublisher(get_model(cfg.model), cfg, None, device="cpu")
    first = pub.publish(tmp_path, {"params": cnn[0]}, 3)
    assert pub.publish(tmp_path, {"params": cnn[0]}, 3) == first
    assert pub.published == 1
    (tmp_path / "file").write_text("")
    # a sidecar that cannot be written is logged, never raised
    assert pub.publish(tmp_path / "file" / "d", {"params": cnn[0]}, 4) \
        is None


def _train_cfg(train_dir, max_steps=4, save_interval_steps=2,
               publish_tiers="int8,bf16", **train):
    return ExperimentConfig.from_dict({
        "data": {"dataset": "synthetic", "batch_size": 64,
                 "synthetic_train_size": 512, "synthetic_test_size": 128,
                 "use_native_pipeline": False},
        "model": {"compute_dtype": "float32"}, "mesh": {"num_replicas": 1},
        # calibration runs; every tier is accepted (epsilon 1)
        "quant": {"publish_tiers": publish_tiers,
                  "calibration_examples": 32, "parity_epsilon": 1.0},
        "train": {"max_steps": max_steps, "log_every_steps": 2,
                  "save_interval_steps": save_interval_steps,
                  "save_results_period": 0, "summary_every_steps": 0,
                  "keep_checkpoints": 0, "train_dir": str(train_dir),
                  **train}})


@pytest.mark.parametrize("arm", [{"async_checkpoint": False},
                                 {"async_snapshot": False}, {}],
                         ids=["sync", "host_fetch", "snapshot"])
def test_trainer_publishes_sidecars_before_artifacts(tmp_path, arm):
    cfg = _train_cfg(tmp_path, **arm)
    Trainer(cfg, device="cpu").run()
    saves = [json.loads(line) for line in
             (tmp_path / "train_log.jsonl").read_text().splitlines()]
    saves = [r for r in saves if r.get("event") == "save"]
    assert saves and all(r["quant_tiers"] == ["int8", "bf16"]
                         for r in saves)
    for step in (2, 4):
        side = ckpt.read_quant_sidecar(tmp_path, step)
        art = ckpt.quant_sidecar_path(tmp_path, step)
        # written before the artifact (modification order)
        assert art.stat().st_mtime_ns <= \
            (tmp_path / f"ckpt-{step:08d}.msgpack").stat().st_mtime_ns
        digest, _ = ckpt.checkpoint_params_digest(tmp_path, step)
        assert side["meta"]["source_params_digest"] == digest
        params, _, _ = ckpt.restore_params(tmp_path, step)
        want = ref_ptq.quantize_tree_int8(jax.tree.map(np.asarray, params))
        got = side["tiers"]["int8"]
        for layer in ("conv1", "fc1"):
            assert got[layer]["w"]["q"].tobytes() == \
                want[layer]["w"]["q"].tobytes()
        calib = side["meta"]["calibration"]
        assert calib["examples"] == 32 and "int8" in calib
