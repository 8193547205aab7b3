"""distributedmnist_tpu_torch — the PyTorch / CUDA port of
``distributedmnist_tpu``.

The JAX package beside this one is the reference: every module here
mirrors a module there by path and name, and the tests in
``tests/test_torch_*.py`` hold each against its counterpart on the CPU.
This package imports ``torch`` (plus numpy and msgpack), never ``jax``,
``flax`` or anything of the reference package.

Ported so far (slice 1, the decode-serving path):

* ``core``     — config schema (own copy), logging, device resolution.
* ``ops``      — attention: the plain oracle, the flash-attention
                 forward (CUDA kernel, ``csrc/flash_attention_fwd.cu``)
                 and the paged decode attention (CUDA kernel,
                 ``csrc/paged_attention.cu``), built by ``ops/_build.py``.
* ``models``   — the causal-LM transformer, its registry entry, and the
                 weight converter from the reference's param tree.
* ``train``    — checkpoint read/write in the reference's single-file
                 layout.
* ``servesvc`` — the continuous-batching decode replica over a paged KV
                 cache, its socket server and client.
* ``launch``   — ``python -m distributedmnist_tpu_torch.launch serve
                 --decode``.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
