"""Post-training quantization (≙ ``distributedmnist_tpu/quant``): the
publish-time pass that writes the int8/bf16 serving tiers as
digest-verified sidecars, and the dequantize/parity helpers the serving
replica shares."""

from .ptq import (QuantPublisher, build_tier_predict, calibrate_tiers,
                  cast_tree_bf16, dequantize_tree_int8,
                  dynamic_input_fake_quant, parity_report,
                  quantize_leaf_int8, quantize_tree_int8, tier_param_bytes,
                  tree_params_digest)

__all__ = [
    "QuantPublisher", "build_tier_predict", "calibrate_tiers",
    "cast_tree_bf16", "dequantize_tree_int8", "dynamic_input_fake_quant",
    "parity_report", "quantize_leaf_int8", "quantize_tree_int8",
    "tier_param_bytes", "tree_params_digest",
]
