"""distributedmnist_tpu_torch — the PyTorch / CUDA port of
``distributedmnist_tpu``.

The JAX package beside this one is the reference: every module here
mirrors a module there by path and name, and the tests in
``tests/test_torch_*.py`` hold each against its counterpart on the CPU.
This package imports ``torch`` (plus numpy and msgpack), never ``jax``,
``flax`` or anything of the reference package.

Ported so far (slice 1, the decode-serving path; slice 2, transformer-LM
training on one device):

* ``core``     — config schema (own copy), logging, device resolution.
* ``ops``      — attention: the plain oracle, flash attention with its
                 autograd binding (CUDA kernels K1/K1-lse in
                 ``csrc/flash_attention_fwd.cu``, K2/K3/K4 in
                 ``csrc/flash_attention_bwd.cu``) and the paged decode
                 attention (K5, ``csrc/paged_attention.cu``), built by
                 ``ops/_build.py``.
* ``models``   — the causal-LM transformer (forward, loss, accuracy,
                 prefill, decode step), its registry entry, and the
                 converter of params and whole TrainStates.
* ``data``     — ``synthetic_lm`` and the seeded, resumable batch stream.
* ``parallel`` — TrainState, the sync train step and the eval step.
* ``train``    — sgd/momentum, the LR schedules, checkpoints in the
                 reference's single-file layout, full-split eval and the
                 Trainer.
* ``servesvc`` — the continuous-batching decode replica over a paged KV
                 cache, its socket server and client.
* ``launch``   — ``python -m distributedmnist_tpu_torch.launch train``
                 and ``serve --decode``.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
