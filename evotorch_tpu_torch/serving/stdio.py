"""JSON-lines-over-stdio front for out-of-process clients (counterpart of
``evotorch_tpu/serving/stdio.py``).

``python -m evotorch_tpu_torch.serving --env cartpole --slab 16`` runs an
:class:`EvalServer` behind a line protocol: one JSON object per request
line on stdin, one per response line on stdout (stderr is free for logs).
Every response carries ``ok`` and echoes ``op``; a failure is ``{"ok":
false, "error": ...}`` and never stops the server. It is the
out-of-process escape hatch, not the fast path (in-process clients use
:class:`RemoteEvalBackend`).

Ops: ``admit`` ``submit`` ``poll`` ``step`` ``result`` ``depart``
``status`` ``shutdown``. A ``submit`` with ``"seed": s`` draws the
request's random rows from a generator seeded with ``s`` on the server's
device; without one, from the server's default for the request.
"""

from __future__ import annotations

import json
from typing import Dict

import numpy as np

from .server import EvalServer

__all__ = ["serve_stdio"]


def _op_admit(server, futures, msg):
    tenant = server.admit(name=msg.get("tenant"))
    return {"tenant": tenant.name, "group": tenant.group}


def _op_submit(server, futures, msg):
    import torch

    tenant = _tenant(server, msg)
    values = np.asarray(msg["values"], dtype=np.float32)
    if values.ndim != 2:
        raise ValueError(f"values must be 2-D (n, params), got shape {values.shape}")
    generator = None
    if "seed" in msg:
        generator = torch.Generator(device=server.device).manual_seed(int(msg["seed"]))
    future = server.submit(tenant, values, generator)
    futures[future.request_id] = future
    return {"request_id": future.request_id, "num_solutions": int(values.shape[0])}


def _op_poll(server, futures, msg):
    return {"done": _future(futures, msg).done()}


def _op_step(server, futures, msg):
    return {"served": server.step()}


def _op_result(server, futures, msg):
    future = _future(futures, msg)
    result = future.result()
    del futures[int(msg["request_id"])]
    tenant = future.tenant
    out = {
        "scores": [float(s) for s in result.scores.cpu().numpy()],
        "env_steps": int(result.total_steps),
        "episodes": int(result.total_episodes),
    }
    if tenant.telemetry is not None:
        out["queue_wait_p50"] = tenant.telemetry.queue_wait_quantile(0.5)
        out["queue_wait_p99"] = tenant.telemetry.queue_wait_quantile(0.99)
    return out


def _op_depart(server, futures, msg):
    tenant = _tenant(server, msg)
    server.depart(tenant, cancel=bool(msg.get("cancel", False)))
    return {"tenant": tenant.name}


def _op_status(server, futures, msg):
    return server.status()


_OPS = {
    "admit": _op_admit,
    "submit": _op_submit,
    "poll": _op_poll,
    "step": _op_step,
    "result": _op_result,
    "depart": _op_depart,
    "status": _op_status,
}


def _tenant(server: EvalServer, msg: dict):
    name = msg.get("tenant")
    for tenant in server.tenants:
        if tenant.name == name:
            return tenant
    raise ValueError(f"unknown tenant {name!r}")


def _future(futures: Dict[int, object], msg: dict):
    request_id = int(msg["request_id"])
    if request_id not in futures:
        raise ValueError(f"unknown request_id {request_id}")
    return futures[request_id]


def serve_stdio(server: EvalServer, infile, outfile) -> int:
    """Run the line protocol until EOF or a ``shutdown`` op; returns the
    number of requests handled. Pure function of its streams — the tests
    drive it with StringIO pairs."""
    handled = 0
    futures: Dict[int, object] = {}
    for raw in infile:
        raw = raw.strip()
        if not raw:
            continue
        handled += 1
        try:
            msg = json.loads(raw)
            op = msg.get("op")
            if op == "shutdown":
                _write(outfile, {"ok": True, "op": "shutdown"})
                break
            handler = _OPS.get(op)
            if handler is None:
                raise ValueError(f"unknown op {op!r}")
            response = {"ok": True, "op": op}
            response.update(handler(server, futures, msg))
            if "id" in msg:
                response["id"] = msg["id"]
            _write(outfile, response)
        except Exception as exc:  # every failure is reported on the protocol stream as an error line
            _write(outfile, {"ok": False, "error": f"{type(exc).__name__}: {exc}"})
    return handled


def _write(outfile, obj: dict) -> None:
    outfile.write(json.dumps(obj, sort_keys=True))
    outfile.write("\n")
    outfile.flush()
