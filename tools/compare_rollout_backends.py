#!/usr/bin/env python3
"""Time the controller's two rollout backends against each other on one GPU.

For each task cell, builds one controller per rollout backend through
``make_controller``, times its first ``update_action``
(compile plus one solve), then times depth-0 solves (dispatch to synced
mirror) in alternating rounds, so that slow drift of the card's clocks falls
on every variant alike. Prints the card, then one JSON line per variant.

    python tools/compare_rollout_backends.py [--solves 30] [--rounds 3]

Cells: leap_cube + MPPI at R=320, horizon 1.0 s, and spot_navigate + MPPI
at R=24, horizon 2.0 s.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CELLS = (("leap_cube", 320, 1.0), ("spot_navigate", 24, 2.0))
BACKENDS = ("vmap", "lanes_xla")


def build(task: str, num_rollouts: int, horizon: float, backend: str):
    import numpy as np

    from judo_tpu.controller import make_controller

    np.random.seed(0)
    c = make_controller(task, "mppi", rollout_backend=backend)
    c.optimizer_cfg.num_rollouts = num_rollouts
    c.controller_cfg.horizon = horizon
    c.reset()
    t0 = time.perf_counter()
    c.update_action()
    return c, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--solves", type=int, default=30, help="depth-0 solves per variant")
    ap.add_argument("--rounds", type=int, default=3, help="alternating rounds they split into")
    args = ap.parse_args()

    import numpy as np

    from judo_tpu.utils.device import card_name_and_power_limit, require_gpu

    card = card_name_and_power_limit()
    device = require_gpu()
    print(f"card: {card}; device: {json.dumps(device)}", flush=True)
    per_round = -(-args.solves // args.rounds)
    for task, R, horizon in CELLS:
        variants = {}
        for backend in BACKENDS:
            c, first = build(task, R, horizon, backend)
            variants[backend] = (c, first, [])
            print(f"built {task} {backend}: first call {first:.3f} s", flush=True)
        order = list(variants)
        for r in range(args.rounds):
            for key in order if r % 2 == 0 else order[::-1]:
                c, _, times = variants[key]
                for _ in range(per_round):
                    t0 = time.perf_counter()
                    c.update_action()
                    times.append(time.perf_counter() - t0)
        for backend, (c, first, times) in variants.items():
            t = np.asarray(times) * 1e3
            print(json.dumps({
                "task": task, "num_rollouts": R, "horizon_steps": c.num_timesteps,
                "backend": backend,
                "first_call_s": first, "depth0_solves": len(t),
                "depth0_p50_ms": float(np.median(t)), "depth0_min_ms": float(t.min()),
                "depth0_max_ms": float(t.max()),
                "reward_mean": float(np.mean(c.rewards)), "card": card,
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
