"""Host-side parallel evaluation: a pool of worker processes (counterpart
of ``evotorch_tpu/parallel/hostpool.py``).

The sharded paths cover vectorized objectives; this module covers the
reference's other use: fanning a per-solution Python fitness function out
over worker processes (the reference's Ray ``EvaluationActor``s and
``ActorPool``). Workers are started with the ``spawn`` method (forking a
process after PyTorch initialized CUDA is unsafe), each holding a pickled
clone of the problem, and the reference's main/actor synchronization maps
onto the four ``Problem`` hooks it defines: ``_make_sync_data_for_actors``,
``_use_sync_data_from_main``, ``_make_sync_data_for_main`` and
``_use_sync_data_from_actors``. A worker evaluates on the problem's device.

The JAX pool's fault injection (``EVOTORCH_FAULTS``) and its counters and
spans belong to ROADMAP items A.13 and A.12; a dead worker is replaced by a
clone with the same seed and its piece handed out again, as there.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import signal
import time
import traceback
from collections import deque
from multiprocessing.connection import wait as _conn_wait
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..tools.objectarray import ObjectArray

__all__ = ["HostEvaluatorPool"]

_STARTUP_TIMEOUT = 300.0

_MAIN_GUARD_HINT = (
    "HostEvaluatorPool was constructed inside a child process. This happens when a script using num_actors is not"
    " wrapped in an `if __name__ == '__main__':` guard: the 'spawn' start method re-imports the main module in each"
    " worker, which would recursively spawn pools. Wrap the script body in the guard."
)


def _worker_main(problem_bytes: bytes, seed: int, conn):
    torch.set_num_threads(1)  # the pool is the parallelism
    try:
        problem = pickle.loads(problem_bytes)
        problem._num_actors_requested = None  # workers never start pools of their own
        problem._is_main = False
        problem.manual_seed(seed)
    except Exception:
        conn.send(("fatal", -1, traceback.format_exc()))
        return
    conn.send(("ready", -1, None))

    from ..core import SolutionBatch

    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):  # the main process went away
            return
        if msg is None:
            return
        _, idx, values, sync = msg
        try:
            if sync is not None:
                problem._use_sync_data_from_main(sync)
            if not isinstance(values, ObjectArray):  # an object problem's pieces stay ObjectArrays
                values = torch.as_tensor(values, dtype=problem.dtype, device=problem.device)
            batch = SolutionBatch(problem, len(values), values=values)
            problem.evaluate(batch)
            result = ("ok", idx, batch.evals.cpu().numpy(), problem._make_sync_data_for_main())
        except Exception:
            result = ("error", idx, traceback.format_exc())
        try:
            conn.send(result)
        except (EOFError, OSError):
            return


class HostEvaluatorPool:
    """``num_workers`` processes, each holding a pickled clone of the
    problem, fed one piece at a time over a pipe of its own (a pull
    scheduler: each finished piece fetches the next, the dynamic balance of
    the reference's ``ActorPool.map_unordered``). Pipes rather than a shared
    queue: a worker killed while it holds a queue's lock would deadlock its
    siblings, while a dead pipe takes down only its own worker's channel.

    ``timeout`` (seconds; None: no limit) bounds the wait for any piece's
    result, so a hung worker fails the round instead of blocking it."""

    def __init__(self, problem, num_workers: int, *, seeds: Optional[Sequence[int]] = None, timeout: Optional[float] = 1800.0):
        if mp.current_process().name != "MainProcess":
            raise RuntimeError(_MAIN_GUARD_HINT)
        self._num_workers = int(num_workers)
        if self._num_workers < 1:
            raise ValueError(f"num_workers must be >= 1, got {num_workers}")
        self._timeout = timeout
        self._ctx = mp.get_context("spawn")
        # kept to respawn a dead worker as the same clone with the same seed
        self._problem_bytes = pickle.dumps(problem)
        seeds = [None] * self._num_workers if seeds is None else list(seeds)
        self._seeds = [int(seeds[i]) if seeds[i] is not None else i for i in range(self._num_workers)]
        # a worker that keeps dying (an objective that crashes every time)
        # fails the round once this is spent
        self._respawn_budget = 2 * self._num_workers
        self._procs, self._conns = [], []
        for seed in self._seeds:
            proc, conn = self._spawn(seed)
            self._procs.append(proc)
            self._conns.append(conn)
        self._await_ready()

    def _spawn(self, seed: int):
        parent_conn, child_conn = self._ctx.Pipe(duplex=True)
        proc = self._ctx.Process(target=_worker_main, args=(self._problem_bytes, int(seed), child_conn), daemon=True)
        proc.start()
        # the parent's copy of the child end is closed, so that a dead
        # worker's pipe reads EOF instead of blocking
        child_conn.close()
        return proc, parent_conn

    def _worker_index(self, conn) -> int:
        for i, c in enumerate(self._conns):
            if c is conn:
                return i
        raise KeyError("connection does not belong to this pool")

    def _respawn_dead(self, pending, inflight, evals, broken=()) -> int:
        """Replace every dead worker (or one whose pipe broke) by a clone
        with the same seed on a fresh pipe, and put its unfinished piece back
        at the front of the queue; returns how many were replaced."""
        respawned = 0
        for wi, proc in enumerate(self._procs):
            if proc.is_alive() and wi not in broken:
                continue
            if proc.is_alive():
                os.kill(proc.pid, signal.SIGKILL)
                proc.join(timeout=10)
            if self._respawn_budget <= 0:
                raise RuntimeError(
                    f"a host evaluation worker died mid-evaluation and the respawn budget ({2 * self._num_workers}) is"
                    " spent: the objective is likely crashing every time"
                )
            self._respawn_budget -= 1
            piece, inflight[wi] = inflight[wi], None
            if piece is not None and evals[piece] is None:
                pending.appendleft(piece)
            try:
                self._conns[wi].close()
            except OSError:
                pass  # a severed pipe: closing it is only descriptor hygiene
            self._procs[wi], self._conns[wi] = self._spawn(self._seeds[wi])
            respawned += 1
        return respawned

    def _await_ready(self):
        """Wait for every worker to load its clone; fail fast, with the
        worker's traceback, if one died on the way (an unpicklable objective,
        a script without its ``__main__`` guard)."""
        ready: set = set()
        deadline = time.monotonic() + _STARTUP_TIMEOUT
        while len(ready) < self._num_workers:
            if time.monotonic() > deadline:
                self.shutdown()
                raise RuntimeError("host evaluation workers timed out during startup")
            waiting = [c for i, c in enumerate(self._conns) if i not in ready]
            for conn in _conn_wait(waiting, timeout=1.0):
                wi = self._worker_index(conn)
                try:
                    status, _, payload = conn.recv()
                except (EOFError, OSError):
                    self.shutdown()
                    raise RuntimeError("a host evaluation worker died during startup. " + _MAIN_GUARD_HINT) from None
                if status == "fatal":
                    self.shutdown()
                    raise RuntimeError(f"host evaluation worker failed to start:\n{payload}")
                if status == "ready":
                    ready.add(wi)

    @property
    def num_workers(self) -> int:
        return self._num_workers

    @property
    def worker_pids(self) -> List[int]:
        return [p.pid for p in self._procs]

    def is_alive(self) -> bool:
        return any(p.is_alive() for p in self._procs)

    def evaluate_pieces(self, pieces_values: Sequence, sync_data: Optional[dict]) -> Tuple[List[np.ndarray], List[dict]]:
        """Evaluate the value arrays of each piece; returns the eval matrices
        in piece order and the per-piece sync payloads (unordered). Any
        failure shuts the pool down, so no stale result can reach a later
        round."""
        try:
            return self._evaluate_pieces(pieces_values, sync_data)
        except Exception:
            self.shutdown()
            raise

    def _evaluate_pieces(self, pieces_values, sync_data):
        # every payload is made before anything is sent
        # tensors as numpy arrays; an object problem's ObjectArrays as they are
        transport = [
            v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v if isinstance(v, ObjectArray) else np.asarray(v)
            for v in pieces_values
        ]
        n = len(transport)
        evals: List[Optional[np.ndarray]] = [None] * n
        sync_back: List[dict] = []
        pending = deque(range(n))
        inflight: List[Optional[int]] = [None] * self._num_workers

        def dispatch(wi: int) -> None:
            # a send to a worker that just died puts the piece back; the
            # death sweep below respawns it and hands the piece out again
            if inflight[wi] is not None or not pending:
                return
            i = pending.popleft()
            try:
                self._conns[wi].send(("eval", i, transport[i], sync_data))
            except (OSError, ValueError):
                pending.appendleft(i)
            else:
                inflight[wi] = i

        for wi in range(self._num_workers):
            dispatch(wi)
        received = 0
        deadline = None if self._timeout is None else time.monotonic() + self._timeout
        while received < n:
            try:
                readable = _conn_wait(list(self._conns), timeout=1.0)
            except OSError:
                readable = []
            broken: List[int] = []
            results = []
            for conn in readable:
                wi = self._worker_index(conn)
                try:
                    results.append((wi, conn.recv()))
                except (EOFError, OSError):  # a torn message: the worker died
                    broken.append(wi)
            if broken or not all(p.is_alive() for p in self._procs):
                self._respawn_dead(pending, inflight, evals, broken)
                for wi in range(self._num_workers):
                    dispatch(wi)
                if deadline is not None:
                    deadline = time.monotonic() + self._timeout
            for wi, msg in results:
                status, idx, *payload = msg
                if status == "ready":  # a respawned worker finished loading
                    dispatch(wi)
                    continue
                if status != "ok":
                    raise RuntimeError(f"host evaluation worker failed:\n{payload[-1]}")
                if inflight[wi] == idx:
                    inflight[wi] = None
                if evals[idx] is None:  # a duplicate after a respawn loses
                    evals[idx] = payload[0]
                    sync_back.append(payload[1])
                    received += 1
                    if deadline is not None:
                        deadline = time.monotonic() + self._timeout
                dispatch(wi)
            if not readable and deadline is not None and time.monotonic() > deadline:
                raise RuntimeError("host evaluation pool timed out")
        return evals, sync_back

    def shutdown(self):
        for conn in self._conns:
            try:
                conn.send(None)
            except (OSError, ValueError):
                pass  # the pipe may already be severed
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
        for conn in self._conns:
            try:
                conn.close()
            except OSError:
                pass
        self._procs, self._conns = [], []

    def __del__(self):
        try:
            self.shutdown()
        except Exception:  # noqa: BLE001 - a destructor at interpreter exit must not raise
            pass
