"""How long a fresh interpreter takes to import the runtime, and whether it loads torch.

    python -m rio_tpu_torch.utils.import_probe [--root DIR] [--repeat N] MODULES...

Each argument is one comma-separated set of modules, imported together by a new
``python`` with a clean environment (``PATH``, ``HOME`` and ``PYTHONPATH=DIR``, the
repo's root by default), the way a sharded worker, a load generator or an
autoscaled node starts. ``--root`` may name another checkout of the repo, so two
trees are timed by one script on one host. Prints one JSON line: for each set, the
median over ``--repeat`` runs of the import's seconds and of the whole process's,
and whether the child had torch (or jax) in ``sys.modules`` afterwards.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_CHILD = """
import json, sys, time
t = time.perf_counter()
for name in sys.argv[1:]:
    __import__(name)
print(json.dumps({"seconds": time.perf_counter() - t,
                  "loaded": sorted(n for n in ("torch", "jax") if n in sys.modules)}))
"""


def probe(modules: list[str], root: str | None = None, repeat: int = 3) -> dict:
    """Import ``modules`` in ``repeat`` fresh clean-environment interpreters."""
    root = os.path.abspath(root or _ROOT)
    env = {
        "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
        "HOME": os.environ.get("HOME", "/tmp"),
        "PYTHONPATH": root,
    }
    imports, processes, loaded = [], [], set()
    for _ in range(repeat):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-c", _CHILD, *modules],
            cwd=root, env=env, capture_output=True, text=True, timeout=120,
        )
        processes.append(time.perf_counter() - t0)
        if out.returncode != 0:
            raise RuntimeError(f"importing {modules} failed: {out.stderr[-2000:]}")
        child = json.loads(out.stdout.strip().splitlines()[-1])
        imports.append(child["seconds"])
        loaded.update(child["loaded"])
    return {
        "modules": modules,
        "import_s": statistics.median(imports),
        "process_s": statistics.median(processes),
        "loaded": sorted(loaded),
        "repeat": repeat,
    }


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(prog="python -m rio_tpu_torch.utils.import_probe")
    ap.add_argument("--root", default=None, help="the checkout to import from (this one)")
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("sets", nargs="+", help="comma-separated modules imported together")
    args = ap.parse_args(argv)
    results = [probe(s.split(","), args.root, args.repeat) for s in args.sets]
    print(json.dumps({"root": os.path.abspath(args.root or _ROOT), "probes": results}), flush=True)
    return results


if __name__ == "__main__":
    main()
