#!/usr/bin/env python3
"""Runs ``chip_smoke.py`` with the wall seconds of every function call
recorded, to find where the card script's time goes.

    python3 chip_smoke_times.py TAG

Every function of ``chip_smoke`` (but ``main`` and the printing
helpers) is wrapped: each call adds its seconds under
``"function<caller>"`` (nested calls overlap), with the first 40 calls'
seconds in order. The totals go to ``chiprun_out/TAG_times.json`` after
each phase and when the script exits, whatever its result; the script's
own output and exit code are unchanged.
"""

import atexit
import collections
import functools
import inspect
import json
import os
import sys
import time

import chip_smoke as cs

TAG = sys.argv[1]
acc: dict = collections.defaultdict(lambda: [0, 0.0, []])


def _wrap(name, fn):
    @functools.wraps(fn)
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        caller = sys._getframe(1).f_code.co_name
        try:
            return fn(*args, **kwargs)
        finally:
            rec = acc[f"{name}<{caller}"]
            dt = time.perf_counter() - t0
            rec[0] += 1
            rec[1] += dt
            if len(rec[2]) < 40:
                rec[2].append(round(dt, 2))
            if name.startswith("phase_"):
                _dump()
    return timed


for _name, _fn in list(vars(cs).items()):
    if (inspect.isfunction(_fn) and _fn.__module__ == cs.__name__
            and _name not in ("main", "emit", "check", "nvidia_smi",
                              "bound", "_exact")):
        setattr(cs, _name, _wrap(_name, _fn))


@atexit.register
def _dump():
    os.makedirs("chiprun_out", exist_ok=True)
    with open(f"chiprun_out/{TAG}_times.json", "w") as f:
        json.dump(dict(sorted(acc.items(), key=lambda kv: -kv[1][1])), f,
                  indent=0)


if __name__ == "__main__":
    sys.exit(cs.main())
