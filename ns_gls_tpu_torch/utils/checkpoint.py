"""Checkpoint / resume (the reference has none; the JAX package added it
so long runs survive restarts).

Port of ``ns_gls_tpu/utils/checkpoint.py`` in the layout of its npz
branch: ``path + ".npz"`` holds the solution history, newest first, as
``solution_0``, ``solution_1``, ...; ``path + ".json"`` holds ``t``,
``counter`` (the next cycle), ``dt_history`` (the integrator's step
sizes, newest first) and ``n_vectors``.  The JAX package's
``load_checkpoint`` reads this layout when it finds no orbax directory
beside it, so a run of either package continues the other's state.  The
orbax branch is not ported (orbax needs JAX).
"""

from __future__ import annotations

import json
import os

import numpy as np


def save_checkpoint(path: str, driver, t: float, counter: int) -> None:
    state = {
        f"solution_{i}": v.detach().cpu().numpy()
        for i, v in enumerate(driver.solution.vectors)
    }
    raw_dt = getattr(driver.time_integrator, "_dt", None)
    if isinstance(raw_dt, list):
        dt_history = [float(x) for x in raw_dt]
    elif raw_dt is not None:
        dt_history = [float(raw_dt)]
    else:
        dt_history = []
    meta = dict(
        t=t,
        counter=counter,
        dt_history=dt_history,
        n_vectors=len(driver.solution.vectors),
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path + ".npz", **state)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str, driver) -> tuple[float, int]:
    """Restores the solution history and the integrator's step sizes into
    a set-up ``driver`` (``Driver.restart_from``); returns (t, counter)."""
    with open(path + ".json") as f:
        meta = json.load(f)
    with np.load(path + ".npz") as data:
        vectors = [data[f"solution_{i}"] for i in range(meta["n_vectors"])]
    t, counter = float(meta["t"]), int(meta["counter"])
    driver.restart_from(vectors, meta["dt_history"], t, counter)
    return t, counter
