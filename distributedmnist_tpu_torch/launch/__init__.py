"""Command-line entry points (``python -m distributedmnist_tpu_torch.launch``)."""
