"""The port's static checks (≙ ``distributedmnist_tpu/analysis/``): a
pytest-free, import-free AST toolchain (``python -m
distributedmnist_tpu_torch.analysis``) that moves contract violations
from chaos-campaign time to CI time. Seven checkers:

* ``schema``     — every journal emit site's literal payload verified
  against the ``obsv/schema.py`` event registry;
* ``config``     — every ``cfg.<section>.<field>`` access resolves to a
  declared dataclass field in ``core/config.py``; declared knobs never
  read anywhere are flagged dead;
* ``threads``    — instance attributes written from more than one
  thread-entry reachability root without a lock guard;
* ``durability`` — raw writes that bypass the storage shim
  (``train/storage.py``);
* ``net``        — unbounded blocking socket operations in ``servesvc/``
  and ``launch/``;
* ``paged``      — dense gathers and block-table rebuilds on the decode
  hot path;
* ``torch``      — host syncs (``.item()``, ``.cpu()``, ``.tolist()``)
  inside step, batcher and decode loops.

Never imports the analyzed modules (no torch required): everything is
``ast.parse`` over source. Findings are machine-readable JSON;
known-accepted findings live in ``analysis/baseline.json`` with a
one-line justification each.
"""

from .core import (Finding, iter_sources, load_baseline, run_checkers,
                   CHECKERS)

__all__ = ["Finding", "iter_sources", "load_baseline", "run_checkers",
           "CHECKERS"]
