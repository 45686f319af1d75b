#!/usr/bin/env python3
"""Do a tenant's packed scores equal its standalone run, and at what width?

    python3 scripts/packing_width.py [--rows 16] [--tenants 4] [--steps 20]
        [--device cuda|cpu]

Packs ``--tenants`` matrices of ``--rows`` flagship rows (Humanoid,
``tanh_mlp(109, 17, [64, 64])``, 0.1 x N(0, 1), each with its own
generator) into one ``episodes_refill`` rollout of ``rows x tenants``
solutions at the refill width the evaluation server takes for that slab,
each solution with the table rows its tenant's generator drew
(``vecrl.draw_solution_tables``), and holds each tenant's scores against
its standalone ``episodes_refill`` run from the same generator state
twice: at the server's width (``same_width``; clamped to the tenant's
rows when it has fewer, as the engine does) and at the engine's default
width for the tenant alone (``default_width``). It prints the largest
absolute score difference of each (0.0: bit for bit) and the widths, as
one JSON line. It runs on the card unless ``--device cpu`` is given. A
standalone run whose lane width differs from the packed run's runs the
policy's ``baddbmm`` at another shape.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--rows", type=int, default=16)
    parser.add_argument("--tenants", type=int, default=4)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--device", default=None, help="the card unless 'cpu' is asked for")
    args = parser.parse_args(argv)

    from evotorch_tpu_torch._device import resolve_device
    from evotorch_tpu_torch.envs import Humanoid
    from evotorch_tpu_torch.neuroevolution.net import FlatParamsPolicy, tanh_mlp
    from evotorch_tpu_torch.neuroevolution.net.vecrl import (
        SolutionTables,
        _default_refill_width,
        draw_solution_tables,
        run_vectorized_rollout,
    )

    device = resolve_device(args.device)
    env = Humanoid(device=device, reset_noise_scale=0.01)
    policy = FlatParamsPolicy(tanh_mlp(env.observation_size, env.action_size, [64, 64]))
    slab = args.rows * args.tenants
    width = _default_refill_width(slab)
    kw = dict(eval_mode="episodes_refill", episode_length=args.steps)

    def gen(k):
        return torch.Generator(device=device).manual_seed(100 + k)

    values = [0.1 * torch.randn((args.rows, policy.parameter_count), generator=gen(1000 + k), device=device) for k in range(args.tenants)]
    tables = [draw_solution_tables(env, args.rows, gen(k), episode_length=args.steps) for k in range(args.tenants)]
    packed = run_vectorized_rollout(
        env, policy, torch.cat(values), gen(99), None, refill_width=width,
        solution_tables=SolutionTables(torch.cat([t.reset for t in tables])), **kw,
    ).scores.split(args.rows)  # fmt: skip
    diffs = {"same_width": 0.0, "default_width": 0.0}
    for k in range(args.tenants):
        for name, w in (("same_width", width), ("default_width", None)):
            alone = run_vectorized_rollout(env, policy, values[k], gen(k), None, refill_width=w, **kw).scores
            diffs[name] = max(diffs[name], float((packed[k] - alone).abs().max()))
    out = {
        "device": device.type,
        "rows": args.rows,
        "tenants": args.tenants,
        "packed_width": width,
        "standalone_same_width": min(width, args.rows),
        "standalone_default_width": _default_refill_width(args.rows),
        "max_abs_diff_same_width": diffs["same_width"],
        "max_abs_diff_default_width": diffs["default_width"],
    }
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
