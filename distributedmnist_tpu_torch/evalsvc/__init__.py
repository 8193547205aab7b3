"""The continuous checkpoint evaluator (≙ ``distributedmnist_tpu/
evalsvc``): ``python -m distributedmnist_tpu_torch.evalsvc`` or
``python -m distributedmnist_tpu_torch.launch eval``."""

from .evaluator import Evaluator

__all__ = ["Evaluator"]
