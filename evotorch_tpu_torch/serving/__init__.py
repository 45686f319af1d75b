"""Multi-tenant continuous-batching evaluation service (counterpart of
``evotorch_tpu/serving``).

One long-running :class:`EvalServer` keeps one resident
``episodes_refill`` rollout configuration and packs (solution, episode)
items of many concurrent searches into its fixed-width lanes: continuous
batching in which the telemetry group id is the tenant id.
``RemoteEvalBackend`` plugs an unmodified ``VecNE`` into a shared server
(``eval_backend=``); ``python -m evotorch_tpu_torch.serving`` is the
JSON-lines-over-stdio front for out-of-process clients.
"""

from .admission import AdmissionPolicy, FIFOAdmission, StarvationAwareAdmission
from .backend import RemoteEvalBackend
from .requests import EvalFuture, EvalRequest
from .server import EvalServer, Tenant
from .stdio import serve_stdio

__all__ = [
    "AdmissionPolicy",
    "EvalFuture",
    "EvalRequest",
    "EvalServer",
    "FIFOAdmission",
    "RemoteEvalBackend",
    "StarvationAwareAdmission",
    "Tenant",
    "serve_stdio",
]
