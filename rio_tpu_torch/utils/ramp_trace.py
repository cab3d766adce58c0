"""The autoscale tier, with the times of its ramp's controller decisions.

    python -m rio_tpu_torch.utils.ramp_trace [--trials N] [--idle JSON] [--ramp JSON]

Runs ``rio_tpu_torch.bench.autoscale_stage(ramp=RAMP, **IDLE)`` ``--trials`` times
in this process and prints one JSON line a trial: the stage's result (or the
error it raised), the ramp's seconds from its start to each provision it began
and to each decision its supervisor journaled (``scale_out``, ``scale_in``,
``drain_requested`` or ``drain_request_failed``, ``retired``), and the hand kernels'
launch counts over the trial (0: the runtime reaches none of them). The marks show
which wait a slow ramp spent its time in: the scale-out, which comes once one
node serves over the policy's 600 requests/s, or the scale-in's drain.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback


def run(idle: dict, ramp: dict) -> dict:
    """One ``autoscale_stage`` with its marks and launch counts."""
    from .. import autoscale, bench
    from ..autoscale import provision
    from ..kernels import launch
    from . import autoscale_live

    marks: list[list] = []
    start = 0.0
    measure, journal = autoscale_live.measure_autoscale_ramp, autoscale.AutoscaleRuntime._journal
    provision_node = provision.SubprocessProvisioner.provision

    async def timed_ramp(**kwargs):
        nonlocal start
        start = time.monotonic()
        return await measure(**kwargs)

    def timed_journal(self, action, key, **attrs):
        marks.append([action, time.monotonic() - start])
        return journal(self, action, key, **attrs)

    async def timed_provision(self):
        marks.append(["provision", time.monotonic() - start])
        return await provision_node(self)

    launch.reset_launches()
    autoscale_live.measure_autoscale_ramp = timed_ramp
    autoscale.AutoscaleRuntime._journal = timed_journal
    provision.SubprocessProvisioner.provision = timed_provision
    out: dict = {}
    try:
        out["result"] = bench.autoscale_stage(ramp=ramp, **idle)
    except Exception:  # noqa: BLE001 - reported with the marks, which say where it stopped
        out["error"] = traceback.format_exc()
    finally:
        autoscale_live.measure_autoscale_ramp = measure
        autoscale.AutoscaleRuntime._journal = journal
        provision.SubprocessProvisioner.provision = provision_node
    out["marks"] = marks
    out["launches"] = launch.launches()
    return out


def main(argv: list[str] | None = None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trials", type=int, default=1)
    ap.add_argument("--idle", default="{}", help="autoscale_stage's idle A/B keywords, as JSON")
    ap.add_argument("--ramp", default="{}", help="measure_autoscale_ramp's keywords, as JSON")
    args = ap.parse_args(argv)
    idle, ramp = json.loads(args.idle), json.loads(args.ramp)
    outs = []
    for _ in range(args.trials):
        out = run(idle, ramp)
        print(json.dumps(out), flush=True)
        outs.append(out)
    return outs


if __name__ == "__main__":
    sys.exit(0 if all("result" in out for out in main()) else 1)
