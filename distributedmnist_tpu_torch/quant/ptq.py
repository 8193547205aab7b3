"""Post-training quantization at checkpoint-publish time (≙
``distributedmnist_tpu/quant/ptq.py``).

* **int8 tier** — every float param leaf with ndim ≥ 2 is quantized
  per channel of its LAST axis (the output channels of the HWIO conv
  kernels and ``[in, out]`` dense kernels): ``scale = amax / 127`` in
  float32 (an all-zero channel gets 1.0), ``q = clip(round(w / scale),
  ±127)`` as int8; 1-D leaves stay float32. numpy does this, so the
  tier is the reference's bit for bit. A serving replica keeps the int8
  leaves and the scales on the device and dequantizes inside the
  predict (``q.to(dtype) * scale``); a float network input goes through
  a per-batch dynamic int8 round trip first.
* **bf16 tier** — a straight bfloat16 cast of the float leaves (round
  to nearest even, as ml_dtypes casts), held as torch ``bfloat16``
  tensors; numpy has no bf16.
* **Calibration** — at publish time the held-out examples run through
  the fp32 predict and each tier's, on the trainer's device; a tier
  whose top-1 agreement with fp32 falls more than
  ``quant.parity_epsilon`` below 1 is refused (not published).

The sidecar (``train/checkpoint.py write_quant_sidecar``) holds the
tiers and a JSON meta with ``source_params_digest`` — the artifact's
params digest — and is written with the artifact's atomic-write and
sha256 contract. The full-precision artifact is unchanged by it.
"""

from __future__ import annotations

import hashlib
import time
from typing import Any, Callable

import numpy as np
import torch

from ..core.device import cudnn_policy, resolve_device
from ..core.log import get_logger
from ..models.convert import params_from_reference
from ..parallel.api import tree_map
from ..train import checkpoint as ckpt

logger = get_logger("quant")

# symmetric int8: ±127, so the scale maps amax exactly
_QMAX = 127.0


def _is_quantizable(a: np.ndarray) -> bool:
    return np.issubdtype(a.dtype, np.floating) and a.ndim >= 2


def quantize_leaf_int8(w: np.ndarray) -> dict[str, np.ndarray]:
    """One float leaf → ``{"q": int8, "scale": float32}``, the scale per
    last-axis channel, kept broadcast-shaped."""
    w = np.asarray(w, np.float32)
    absmax = np.max(np.abs(w), axis=tuple(range(w.ndim - 1)),
                    keepdims=True)
    scale = np.where(absmax > 0, absmax / _QMAX, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale), -_QMAX, _QMAX).astype(np.int8)
    return {"q": q, "scale": scale}


def quantize_tree_int8(params_sd: Any) -> Any:
    """A state-dict params tree → the int8 tier: quantizable leaves
    become ``{"q", "scale"}`` pairs, other float leaves float32."""
    def leaf(a):
        a = np.asarray(a)
        if _is_quantizable(a):
            return quantize_leaf_int8(a)
        if np.issubdtype(a.dtype, np.floating):
            return a.astype(np.float32)
        return a
    return tree_map(leaf, params_sd)


def cast_tree_bf16(params_sd: Any) -> Any:
    """A state-dict params tree → the bf16 tier: float leaves as CPU
    ``bfloat16`` tensors, integer leaves untouched."""
    def leaf(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            return torch.from_numpy(np.array(a, np.float32)).to(
                torch.bfloat16)
        return a
    return tree_map(leaf, params_sd)


def _is_qpair(node: Any) -> bool:
    return isinstance(node, dict) and set(node) == {"q", "scale"}


def dequantize_tree_int8(qtree: Any, dtype: torch.dtype = torch.float32
                         ) -> Any:
    """The int8 tier (torch leaves) back to a float tree, on the
    leaves' device: each pair becomes ``q.to(dtype) * scale``."""
    if _is_qpair(qtree):
        return qtree["q"].to(dtype) * qtree["scale"].to(dtype)
    if isinstance(qtree, dict):
        return {k: dequantize_tree_int8(v, dtype) for k, v in qtree.items()}
    if isinstance(qtree, list):
        return [dequantize_tree_int8(v, dtype) for v in qtree]
    return qtree


def dynamic_input_fake_quant(x: torch.Tensor) -> torch.Tensor:
    """Per-tensor dynamic int8 round trip of a float activation: scale
    = amax(|x|) / 127 of this batch, x rounded onto that grid and back."""
    scale = torch.clamp(x.abs().max(), min=1e-12) / _QMAX
    return torch.clamp(torch.round(x / scale), -_QMAX, _QMAX) * scale


def tier_param_bytes(tree: Any) -> int:
    """Resident weight bytes of a tier tree (numpy or torch leaves)."""
    if isinstance(tree, dict):
        return sum(tier_param_bytes(v) for v in tree.values())
    if tree is None:
        return 0
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return np.asarray(tree).nbytes


def tree_params_digest(params_sd: Any) -> str:
    """sha256 of a host state-dict params tree by the artifact digests'
    canonical walk: equal to ``checkpoint_params_digest`` of the
    artifact it was saved beside."""
    h = hashlib.sha256()
    ckpt._digest_tree(params_sd, h)
    return h.hexdigest()


# -- parity ------------------------------------------------------------------

def build_tier_predict(model, tier: str,
                       device) -> Callable[[Any, Any], Any]:
    """The per-tier predict ``predict(tree, x) -> probabilities``
    (float32, on ``device``, default ``cuda:$LOCAL_RANK``). ``tree`` is
    the tier's tree in the port's layout on ``device``
    (``params_from_reference`` of the tier), ``x`` a batch (numpy or
    tensor). ``int8`` fake-quantizes a float input and dequantizes the
    weights inside the call; ``bf16`` applies the bf16 leaves as they
    are. Runs without autograd, under the train step's cuDNN policy."""
    device = resolve_device(device)
    input_is_float = np.issubdtype(np.dtype(model.input_dtype), np.floating)
    tf32 = False if model.compute_dtype == torch.float32 else None

    @torch.no_grad()
    def predict(tree, x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        x = x.to(device) if input_is_float else x.to(device, torch.int64)
        with cudnn_policy(True, tf32):
            if tier == "int8":
                if input_is_float:
                    x = dynamic_input_fake_quant(x)
                tree = dequantize_tree_int8(tree)
            return model.predictions(model.apply(tree, x))
    return predict


def parity_report(probs_ref: np.ndarray, probs_tier: np.ndarray,
                  labels: np.ndarray | None = None) -> dict[str, Any]:
    """Top-1 parity of a tier's predictions with the reference set:
    ``agreement`` (what ``quant.parity_epsilon`` gates), the largest
    probability difference, and per-arm accuracy with labels."""
    top_ref = np.argmax(probs_ref, axis=-1)
    top_tier = np.argmax(probs_tier, axis=-1)
    out: dict[str, Any] = {
        "examples": int(top_ref.shape[0]),
        "agreement": round(float(np.mean(top_ref == top_tier)), 4),
        "max_abs_prob_delta": round(
            float(np.max(np.abs(probs_ref - probs_tier))), 5),
    }
    if labels is not None:
        labels = np.asarray(labels)
        out["top1_ref"] = round(float(np.mean(top_ref == labels)), 4)
        out["top1_tier"] = round(float(np.mean(top_tier == labels)), 4)
    return out


def calibrate_tiers(model, params_sd: Any, tiers: dict[str, Any],
                    calib_inputs: np.ndarray,
                    calib_labels: np.ndarray | None = None, *,
                    device=None, predict_cache: dict | None = None
                    ) -> dict[str, Any]:
    """The calibration examples through the fp32 predict and each
    tier's on ``device`` (default ``cuda:$LOCAL_RANK``) → ``{tier:
    parity_report, "examples", "input_amax"}``. ``predict_cache`` keeps
    the predicts across publishes."""
    device = resolve_device(device)
    cache = predict_cache if predict_cache is not None else {}

    def run(tier, tree):
        if tier not in cache:
            cache[tier] = build_tier_predict(model, tier, device)
        probs = cache[tier](params_from_reference(tree, device=device),
                            calib_inputs)
        return probs.float().cpu().numpy()

    x = np.asarray(calib_inputs)
    ref = run("fp32", params_sd)
    out: dict[str, Any] = {"examples": int(x.shape[0])}
    if np.issubdtype(x.dtype, np.floating):
        out["input_amax"] = round(float(np.max(np.abs(x))), 6)
    for tier, tree in tiers.items():
        out[tier] = parity_report(ref, run(tier, tree), calib_labels)
    return out


# -- the publish-time pass ---------------------------------------------------

class QuantPublisher:
    """The checkpoint-publish hook (``quant.publish_tiers``): quantize the
    just-saved params, calibrate on ``device`` and write the sidecar
    beside the artifact. The Trainer calls :meth:`publish` before a
    synchronous save and hands it to the ``AsyncCheckpointer`` as its
    ``publish`` hook otherwise (the writer's thread)."""

    def __init__(self, model, cfg, calib_inputs: np.ndarray | None,
                 calib_labels: np.ndarray | None = None, *, device=None):
        self.model = model
        self.qcfg = cfg.quant
        self.tiers = self.qcfg.resolved_publish_tiers()  # validates
        self.device = resolve_device(device)
        n = self.qcfg.calibration_examples
        self.calib_inputs = (None if calib_inputs is None or n <= 0
                             else np.asarray(calib_inputs[:n]))
        self.calib_labels = (None if calib_labels is None or n <= 0
                             else np.asarray(calib_labels[:n]))
        self._predict_cache: dict[str, Any] = {}
        self.published = 0     # sidecars written
        self.refused: list[tuple[int, str]] = []  # (step, tier) refusals

    def publish(self, train_dir, state: dict, step: int) -> dict | None:
        """Quantize, calibrate and write the sidecar for ``step`` from a
        host state dict (the reference layout). Returns the sidecar's
        meta, or None when nothing was published (no tiers, or every
        tier refused). Never raises: a failed sidecar must not cost a
        checkpoint (logged; the serving tier falls back to fp32)."""
        if not self.tiers:
            return None
        try:
            return self._publish(train_dir, state, step)
        except Exception as e:  # the sidecar is additive
            logger.warning("quant sidecar publish for step=%d failed "
                           "(%s: %s) — serving falls back to fp32",
                           step, type(e).__name__, e)
            return None

    def _publish(self, train_dir, state: dict, step: int) -> dict | None:
        params_sd = ckpt.to_state_dict(state["params"])
        src_digest = tree_params_digest(params_sd)
        try:
            # idempotent per (step, source digest, tier set): the final
            # save may repeat a cadence step's publish
            meta = ckpt.read_quant_sidecar(train_dir, step)["meta"] or {}
            if (meta.get("source_params_digest") == src_digest
                    and set(self.tiers) <= set(meta.get("tiers") or ())):
                logger.info("quant sidecar step=%d already published "
                            "for this source digest + tiers; skipping",
                            step)
                return meta
        except (OSError, ValueError, KeyError):
            pass  # absent or torn: publish (re-)writes it
        t0 = time.perf_counter()
        built: dict[str, Any] = {}
        for tier in self.tiers:
            built[tier] = (quantize_tree_int8(params_sd) if tier == "int8"
                           else cast_tree_bf16(params_sd))
        meta = {
            "step": step,
            "tiers": list(built),
            "source_params_digest": src_digest,
            "parity_epsilon": self.qcfg.parity_epsilon,
            "param_bytes": {"fp32": tier_param_bytes(params_sd),
                            **{t: tier_param_bytes(tr)
                               for t, tr in built.items()}},
        }
        if self.calib_inputs is not None:
            calib = calibrate_tiers(self.model, params_sd, built,
                                    self.calib_inputs, self.calib_labels,
                                    device=self.device,
                                    predict_cache=self._predict_cache)
            meta["calibration"] = calib
            floor = 1.0 - self.qcfg.parity_epsilon
            for tier in list(built):
                agreement = calib[tier]["agreement"]
                if agreement < floor:
                    logger.warning(
                        "quant tier %s REFUSED at step=%d: calibration "
                        "top-1 agreement %.4f < %.4f (epsilon %.3f)",
                        tier, step, agreement, floor,
                        self.qcfg.parity_epsilon)
                    self.refused.append((step, tier))
                    del built[tier]
            meta["tiers"] = list(built)
        if not built:
            return None
        meta["publish_ms"] = round((time.perf_counter() - t0) * 1e3, 3)
        ckpt.write_quant_sidecar(train_dir, step, built, meta)
        self.published += 1
        logger.info("published quant sidecar step=%d tiers=%s (%.0f ms)",
                    step, ",".join(built), meta["publish_ms"])
        return meta
