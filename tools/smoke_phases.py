"""Seconds of each phase of a tree's ``chip_smoke.py``, by function.

Runs ``chip_smoke.main()`` of the tree at ``--root`` (imported from there,
with that tree as the working directory) with every module-level
``phase_*`` function and ``check_sass`` wrapped to add its seconds to a
tally, then prints the tally as one JSON line, ``{"phase_seconds": ...}``.
The smoke's own output comes first, unchanged. Use it to hold one tree's
phases against another's in one call on the card, e.g. an older tree
unpacked with ``git archive`` under ``build/``:

    python3 tools/smoke_phases.py --root build/parent
    python3 tools/smoke_phases.py --root . -- --kernels-only

Arguments after ``--`` go to the smoke. Exits with the smoke's code.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=".", help="the tree whose chip_smoke.py runs")
    ap.add_argument("smoke_args", nargs="*", help="arguments of chip_smoke.py (after --)")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    os.chdir(root)
    sys.path.insert(0, root)
    smoke = importlib.import_module("chip_smoke")
    tally = {}

    def timed(name, fn):
        @functools.wraps(fn)
        def run(*a, **k):
            t0 = time.time()
            try:
                return fn(*a, **k)
            finally:
                tally[name] = tally.get(name, 0.0) + time.time() - t0
        return run

    for name in dir(smoke):
        if name.startswith("phase_") or name == "check_sass":
            setattr(smoke, name, timed(name, getattr(smoke, name)))
    sys.argv = ["chip_smoke.py"] + args.smoke_args
    t0 = time.time()
    rc = smoke.main()
    tally["total"] = time.time() - t0
    print(json.dumps({"phase_seconds": {k: round(v, 2) for k, v in tally.items()},
                      "root": args.root}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
