"""Which calls of a driver step make the host wait for the card, against
the program's ``host_sync`` counter.

    python3 tools/host_sync_check.py [config] [--refinements R]
        [--warmup 1] [--steps 1] [--out FILE]

Runs the config (default ``input/turek_3d_re20_stationary.json``, output
off) through the port's ``Driver`` on CUDA for ``--warmup`` steps, then
``--steps`` more (a stationary config is one solve: the warm-up solves
it and the checked run solves it again from its start) under
``torch.cuda.set_sync_debug_mode("warn")``, which warns at every
synchronizing CUDA call.  Prints, and writes to ``--out`` as JSON: the
synchronizing calls of the checked run, the ``host_sync`` count of its
steps (``Driver.step_stats``), and the calls by site, the innermost
frame of the port with the line that called into it, each marked
counted where it went through ``utils/timer.py`` (``host_sync``, or the
fence of a top-level scope).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import traceback
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
PORT = os.path.join(ROOT, "ns_gls_tpu_torch")
TIMER = os.path.join(PORT, "utils", "timer.py")


def site_of(stack) -> tuple:
    """(site, counted): the innermost frames of the port outside
    ``utils/timer.py`` (the call and its caller), and whether the call
    went through the counting helper or a fence."""
    counted = any(f.filename == TIMER and f.name in ("host_sync", "_fence")
                  for f in stack)
    port = [f for f in stack
            if f.filename.startswith(PORT) and f.filename != TIMER]
    frames = port[-2:] if port else stack[-3:-1]
    site = " <- ".join(f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} "
                       f"{f.name}" for f in reversed(frames))
    return site, counted


def main(argv=None):
    import torch

    from ns_gls_tpu_torch.config import Parameters, _load_json
    from ns_gls_tpu_torch.driver import Driver
    from ns_gls_tpu_torch.utils.logging import set_verbose

    ap = argparse.ArgumentParser()
    ap.add_argument("config", nargs="?", default=os.path.join(
        ROOT, "input", "turek_3d_re20_stationary.json"))
    ap.add_argument("--refinements", type=int, default=None)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--steps", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    raw = _load_json(args.config)
    raw.update({"paraview prefix": "", "output granularity": 0.0})
    if args.refinements is not None:
        raw["n global refinements"] = args.refinements
    set_verbose(False)
    drv = Driver(Parameters.from_dict(raw), device="cuda")
    drv.setup()
    drv._setup_done = True
    start = [v.cpu().numpy() for v in drv.solution.vectors]
    drv.run(max_steps=args.warmup)
    if drv.time_integrator.order == 0:
        sol, dts, t, counter = start, [], 0.0, 1
    else:
        sol = [v.cpu().numpy() for v in drv.solution.vectors]
        dts, t = list(drv.time_integrator._dt), drv.time_reached
        counter = args.warmup + 1
    drv.restart_from(sol, dts, t, counter)
    torch.cuda.synchronize()
    n0 = len(drv.step_stats)

    sites = collections.Counter()
    shown = warnings.showwarning

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing CUDA operation" in str(message):
            sites[site_of(traceback.extract_stack()[:-1])] += 1
        else:
            shown(message, category, filename, lineno, file, line)

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            drv.run(max_steps=counter - 1 + args.steps)
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = shown
    stats = drv.step_stats[n0:]
    counted = sum(n for (_, c), n in sites.items() if c)
    out = dict(
        config=os.path.basename(args.config), steps=len(stats),
        newton=[s["newton"] for s in stats], gmres=[s["gmres"] for s in stats],
        host_sync=[s["counters"]["host_sync"] for s in stats],
        sync_calls=sum(sites.values()), sync_calls_counted=counted,
        sites=[dict(site=s, counted=c, calls=n)
               for (s, c), n in sites.most_common()])
    print(f"{out['steps']} step(s), Newton {out['newton']}, GMRES "
          f"{out['gmres']}: host_sync {out['host_sync']}; synchronizing "
          f"calls {out['sync_calls']} ({counted} through the counter)")
    for rec in out["sites"]:
        print(f"  {rec['calls']:6d} {'counted  ' if rec['counted'] else 'UNCOUNTED'}"
              f" {rec['site']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
