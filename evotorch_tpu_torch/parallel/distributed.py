"""Joining the process group, and the multi-process dry run (counterpart of
``evotorch_tpu/parallel/distributed.py``).

The JAX package joins hosts with ``jax.distributed.initialize``; the port
joins one process per card with ``torch.distributed.init_process_group``:
NCCL for ``cuda``, gloo for ``cpu``. Under ``torchrun --nproc-per-node=G``
each rank reads its place from the launcher's environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``); without a launcher, pass an
``init_method`` (``tcp://host:port`` or ``file:///path``) with the world
size and the rank.

``dryrun_multihost`` is the runnable proof: every rank runs the same sharded
generations and prints one JSON line of global figures, the same on every
rank and the same as a one-rank run of the same shape::

    torchrun --nproc-per-node=2 -m evotorch_tpu_torch.parallel.distributed
    python -m evotorch_tpu_torch.parallel.distributed \\
        --init-method file:///tmp/rendezvous --world-size 2 --rank 0 --device cpu
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Callable, Optional, Tuple, Type

import torch
import torch.distributed as dist

from .._device import resolve_device

__all__ = ["dryrun_multihost", "init_distributed"]

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def _retry_call(
    fn: Callable, *, retries: int, base_delay: float, max_delay: float, exceptions: Tuple[Type[BaseException], ...]
):
    """``fn()`` with up to ``retries`` retries on ``exceptions``, sleeping
    ``base_delay`` doubled each time up to ``max_delay`` (no jitter); the
    last failure is raised as it is (the JAX package's
    ``resilience.retry.retry_call``, without its counters and spans)."""
    delay = float(base_delay)
    for attempt in range(int(retries) + 1):
        try:
            return fn()
        except exceptions:
            if attempt == int(retries):
                raise
            time.sleep(delay)
            delay = min(delay * 2.0, float(max_delay))


def init_distributed(
    init_method: Optional[str] = None,
    *,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device=None,
    backend: Optional[str] = None,
    timeout: datetime.timedelta = datetime.timedelta(minutes=5),
) -> bool:
    """Join the default process group if the caller or the environment asks
    for one; returns True when a group is formed (or was already), False
    for a single process left untouched (no ``init_method`` and no
    launcher environment).

    ``device`` (default: the card; without one this raises, naming
    ``device="cpu"``) picks the backend: ``nccl`` for ``cuda``, ``gloo``
    for ``cpu``; ``backend`` overrides it (``"gloo"`` carries ranks that
    share one card, which NCCL refuses). A ``cuda`` rank pins its card,
    ``torch.cuda.set_device(LOCAL_RANK)`` (its rank without a launcher).
    The rendezvous is retried with bounded backoff (a rank may dial before
    the store is up); the group is then formed at once by one
    ``all_reduce``, so a group that cannot form raises here. ``timeout``
    bounds every collective of the group."""
    if dist.is_initialized():
        return True
    from_env = all(k in os.environ for k in _LAUNCHER_ENV)
    if init_method is None and not from_env:
        return False
    device = resolve_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if init_method is None:
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
        rank = int(os.environ["RANK"]) if rank is None else rank
    if world_size is None or rank is None:
        raise ValueError("init_distributed with an init_method needs world_size and rank")
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        count = torch.cuda.device_count()
        if local >= count and backend == "nccl":
            raise RuntimeError(f"rank {rank} asks for card {local} of {count}: NCCL takes one rank per card")
        torch.cuda.set_device(local % count)
        device = torch.device("cuda", local % count)

    _retry_call(
        lambda: dist.init_process_group(
            backend, init_method=init_method, world_size=int(world_size), rank=int(rank), timeout=timeout
        ),
        retries=5,
        base_delay=0.2,
        max_delay=5.0,
        exceptions=(OSError, dist.DistStoreError),
    )
    try:
        probe = torch.ones(1, device=device)
        dist.all_reduce(probe)
        if int(probe.item()) != int(world_size):
            raise RuntimeError(f"the process group formed with {int(probe.item())} ranks, not {world_size}")
    except BaseException:
        dist.destroy_process_group()
        raise
    return True


def dryrun_multihost(
    *,
    popsize: int = 64,
    episode_length: int = 20,
    generations: int = 2,
    env_name: str = "cartpole",
    eval_mode: str = "budget",
    seed: int = 0,
    device=None,
) -> dict:
    """A few sharded generations over every rank of the default group (one
    rank without one), returning global figures every rank agrees on."""
    from ..algorithms.functional import pgpe, pgpe_ask, pgpe_tell
    from ..envs import make_env
    from ..neuroevolution.net import FlatParamsPolicy, Linear, Tanh, stats_init
    from .evaluate import make_generation_step
    from .mesh import default_mesh, device_count, mesh_label

    device = resolve_device(device)
    env = make_env(env_name, device=device)
    policy = FlatParamsPolicy(Linear(env.observation_size, 8) >> Tanh() >> Linear(8, env.action_size))
    mesh = default_mesh()
    generation = make_generation_step(
        env, policy, ask=lambda g, s: pgpe_ask(g, s, popsize=popsize), tell=pgpe_tell, popsize=popsize, mesh=mesh,
        device=device, num_episodes=1, episode_length=episode_length, eval_mode=eval_mode,
    )  # fmt: skip
    state = pgpe(
        center_init=torch.zeros(policy.parameter_count, device=device),
        center_learning_rate=0.1,
        stdev_learning_rate=0.1,
        objective_sense="max",
        stdev_init=0.1,
    )
    stats = stats_init(env.observation_size, device=device)
    generator = torch.Generator(device=device).manual_seed(int(seed))
    total_steps, mean_score = 0, 0.0
    for _ in range(int(generations)):
        state, scores, stats, steps, _ = generation(state, generator, stats)
        total_steps += int(steps)
        mean_score = float(scores.mean())
    return {
        "process_index": mesh.rank,
        "process_count": mesh.size,
        "mesh": mesh_label(mesh),
        "devices": device_count(),
        "popsize": popsize,
        "generations": int(generations),
        "total_steps": total_steps,
        "mean_score": round(mean_score, 6),
        "stdev_norm": round(float(torch.linalg.vector_norm(state.stdev)), 6),
    }


def _main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--init-method", default=None, help="tcp://host:port or file:///path (default: torchrun's env)")
    parser.add_argument("--world-size", type=int, default=None)
    parser.add_argument("--rank", type=int, default=None)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("--backend", default=None)
    parser.add_argument("--popsize", type=int, default=64)
    parser.add_argument("--episode-length", type=int, default=20)
    parser.add_argument("--generations", type=int, default=2)
    parser.add_argument("--env", default="cartpole")
    parser.add_argument("--eval-mode", default="budget")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    init_distributed(args.init_method, world_size=args.world_size, rank=args.rank, device=args.device, backend=args.backend)
    try:
        out = dryrun_multihost(
            popsize=args.popsize, episode_length=args.episode_length, generations=args.generations, env_name=args.env,
            eval_mode=args.eval_mode, seed=args.seed, device=args.device,
        )  # fmt: skip
        print(json.dumps(out))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
