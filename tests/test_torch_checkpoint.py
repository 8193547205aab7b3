"""Port parity: checkpoints (``distributedmnist_tpu_torch/train/
checkpoint.py``) and the config schema (``core/config.py``) against
the reference.

* A reference checkpoint (``init_train_state`` + ``save_checkpoint``
  with the run config in ``extra``) reads back BITWISE in the port, and
  its config parses to the same ``to_dict()``.
* A port-written checkpoint is the reference's layout: the reference
  reads it, and its ``checkpoint_params_digest`` equals the reference
  ``state_params_digest`` of the same params.
* A torn artifact raises ``CheckpointCorruptError`` and a restore with
  no step named falls back to the previous loadable step.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedmnist_tpu.core import config as ref_config
from distributedmnist_tpu.models.registry import get_model as ref_get_model
from distributedmnist_tpu.parallel.api import init_train_state
from distributedmnist_tpu.train import checkpoint as ref_ckpt
from distributedmnist_tpu_torch.core import config as port_config
from distributedmnist_tpu_torch.models.convert import (
    params_from_reference, params_to_reference)
from distributedmnist_tpu_torch.models.registry import get_model
from distributedmnist_tpu_torch.train import checkpoint as ckpt

RUN = {"model": {"name": "transformer", "seq_len": 64, "model_dim": 64,
                 "num_heads": 4, "num_layers": 2, "vocab_size": 32,
                 "compute_dtype": "float32"},
       "decode": {"decode_slots": 3, "block_size": 8, "num_blocks": 32,
                  "max_prompt_len": 16, "max_new_tokens": 8,
                  "attention_kernel": "paged"},
       "serve": {"compute_dtype": "float32"}}


def _port_params(seed=0):
    cfg = port_config.ExperimentConfig.from_dict(RUN)
    return get_model(cfg.model).init(torch.Generator().manual_seed(seed))


def test_reference_checkpoint_reads_back_bitwise(tmp_path):
    cfg = ref_config.ExperimentConfig.from_dict(RUN)
    state = init_train_state(ref_get_model(cfg.model), cfg)
    ref_ckpt.save_checkpoint(tmp_path, state, 7,
                             extra={"config": cfg.to_dict()})
    params, extra, step = ckpt.restore_params(tmp_path)
    assert step == 7 == ckpt.latest_checkpoint_step(tmp_path)
    want = jax.tree.map(np.asarray, state.params)
    got = params_to_reference(params_from_reference(params, device="cpu"))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert ckpt.artifact_digest(tmp_path, 7) == ref_ckpt.artifact_digest(
        tmp_path, 7)
    port_cfg = port_config.ExperimentConfig.from_dict(extra["config"])
    assert port_cfg.to_dict() == cfg.to_dict()
    assert ckpt.wait_for_run_config(tmp_path, 5).to_dict() == cfg.to_dict()
    assert ckpt.read_checkpoint_extra(tmp_path)[0] == extra


def test_port_checkpoint_digests_match_reference(tmp_path):
    params = params_to_reference(_port_params())
    cfg = port_config.ExperimentConfig.from_dict(RUN)
    ckpt.save_checkpoint(tmp_path, params, 3,
                         extra={"config": cfg.to_dict()})
    got, step = ref_ckpt.checkpoint_params_digest(tmp_path)
    want = ref_ckpt.state_params_digest(types.SimpleNamespace(
        params=jax.tree.map(jnp.asarray, params)))
    assert step == 3 and got == want
    # the reference reads the whole layout: pointer, sidecar, extra
    assert ref_ckpt.latest_checkpoint_step(tmp_path) == 3
    extra, _ = ref_ckpt.read_checkpoint_extra(tmp_path)
    assert ref_config.ExperimentConfig.from_dict(
        extra["config"]).to_dict() == cfg.to_dict()
    back, _, _ = ckpt.restore_params(tmp_path)
    for a, b in zip(jax.tree.leaves(params),
                    jax.tree.leaves(params_to_reference(
                        params_from_reference(back, device="cpu")))):
        np.testing.assert_array_equal(a, b)


def test_torn_checkpoint_falls_back_to_previous_step(tmp_path):
    for step in (1, 2):
        ckpt.save_checkpoint(tmp_path, params_to_reference(
            _port_params(step)), step)
    path = tmp_path / "ckpt-00000002.msgpack"
    path.write_bytes(path.read_bytes()[:-100])  # torn after publish
    with pytest.raises(ckpt.CheckpointCorruptError, match="sha256"):
        ckpt.restore_params(tmp_path, step=2)
    events = []
    params, _, step = ckpt.restore_params(tmp_path, on_event=events.append)
    assert step == 1
    assert [e["action"] for e in events] == [
        "corrupt_checkpoint_fallback", "fallback_restore"]
    assert events[0]["bad_step"] == 2 and events[1]["step"] == 1
    # without its sidecar the torn bytes fail to parse instead
    (tmp_path / "ckpt-00000002.msgpack.sha256").unlink()
    with pytest.raises(ckpt.CheckpointCorruptError, match="msgpack"):
        ckpt.restore_params(tmp_path, step=2)
    assert ckpt.restore_params(tmp_path / "empty") is None


def test_msgpack_codec_matches_flax():
    from flax import serialization
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.int32(4), "d": np.ones(3, np.int64)},
            "e": jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16)}
    got = ckpt.msgpack_restore(serialization.msgpack_serialize(tree))
    np.testing.assert_array_equal(got["a"], tree["a"])
    assert got["b"]["c"] == 4 and got["b"]["d"].dtype == np.int64
    # bfloat16 widens exactly to float32
    np.testing.assert_array_equal(got["e"], np.asarray([1.5, -2.25, 3.0],
                                                       np.float32))
    mine = {"a": tree["a"], "b": tree["b"]}
    back = serialization.msgpack_restore(ckpt.msgpack_serialize(mine))
    np.testing.assert_array_equal(back["a"], tree["a"])
    assert back["b"]["c"] == 4


def test_config_schema_copy_matches_reference():
    for d in ({}, RUN, {"name": "x", "train": {"profile_steps": [1, 3]},
                        "precision": {"compute_dtype": "bfloat16"}}):
        assert (port_config.ExperimentConfig.from_dict(d).to_dict()
                == ref_config.ExperimentConfig.from_dict(d).to_dict())
    with pytest.raises(port_config.ConfigError, match="unknown config key"):
        port_config.ExperimentConfig.from_dict({"model": {"seq_lenn": 1}})
    cfg = port_config.ExperimentConfig.from_dict(RUN)
    ref = ref_config.ExperimentConfig.from_dict(RUN)
    assert cfg.decode.max_blocks_per_seq() == ref.decode.max_blocks_per_seq()
    assert (port_config.effective_model_config(cfg, serving=True)
            == port_config.ModelConfig(**dataclasses.asdict(
                ref_config.effective_model_config(ref, serving=True))))
    with pytest.raises(port_config.ConfigError, match="attention_kernel"):
        port_config.DecodeConfig(attention_kernel="flash").validate()
    with pytest.raises(port_config.ConfigError, match="null block"):
        port_config.DecodeConfig(num_blocks=4, max_prompt_len=64).validate()
    with pytest.raises(port_config.ConfigError, match="serve.compute_dtype"):
        port_config.effective_model_config(
            cfg.override({"serve.compute_dtype": "float8"}), serving=True)
