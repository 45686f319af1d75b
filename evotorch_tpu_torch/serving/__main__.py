"""``python -m evotorch_tpu_torch.serving``: the stdio evaluation service
(counterpart of ``python -m evotorch_tpu.serving``).

Builds one :class:`EvalServer` from the command line and speaks the
JSON-lines protocol on stdin/stdout (``serving/stdio.py``). The policy is a
tanh MLP over ``--hidden`` (empty: linear). It runs on the card unless
``--device cpu`` is given, and raises without one.
"""

from __future__ import annotations

import argparse
import sys


def _build_policy(env, hidden: str):
    from ..neuroevolution.net import FlatParamsPolicy, Linear, Tanh

    sizes = [int(h) for h in hidden.split(",") if h.strip()] if hidden else []
    widths = [env.observation_size, *sizes, env.action_size]
    net = None
    for n_in, n_out in zip(widths[:-1], widths[1:]):
        layer = Linear(n_in, n_out) >> Tanh()
        net = layer if net is None else net >> layer
    return FlatParamsPolicy(net)


def _main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m evotorch_tpu_torch.serving", description="JSON-lines-over-stdio multi-tenant evaluation service"
    )
    parser.add_argument("--env", required=True, help="registry env name")
    parser.add_argument("--hidden", default="", help="MLP hidden sizes, e.g. 64,64")
    parser.add_argument("--slab", type=int, required=True, help="slab size (rows per dispatch)")
    parser.add_argument("--width", type=int, default=None, help="refill lane width")
    parser.add_argument("--max-tenants", type=int, default=4)
    parser.add_argument("--num-episodes", type=int, default=1)
    parser.add_argument("--episode-length", type=int, default=None)
    parser.add_argument("--obs-norm", action="store_true")
    parser.add_argument("--admission", default="fifo", choices=("fifo", "starvation"))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default=None, help="the device to serve on (default: the card; 'cpu' for the CPU)")
    args = parser.parse_args(argv)

    from .._device import resolve_device
    from ..envs import make_env
    from .server import EvalServer
    from .stdio import serve_stdio

    device = resolve_device(args.device)
    env = make_env(args.env, device=device)
    server = EvalServer(
        env,
        _build_policy(env, args.hidden),
        slab_size=args.slab,
        max_tenants=args.max_tenants,
        refill_width=args.width,
        num_episodes=args.num_episodes,
        episode_length=args.episode_length,
        observation_normalization=args.obs_norm,
        admission=args.admission,
        seed=args.seed,
        device=device,
    )
    print(f"serving {args.env} on {device} slab={args.slab} max_tenants={args.max_tenants} program={server.program.key}", file=sys.stderr)
    serve_stdio(server, sys.stdin, sys.stdout)
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
