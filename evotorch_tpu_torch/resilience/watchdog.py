"""First-device-use watchdog (counterpart of
``evotorch_tpu/resilience/watchdog.py``): a card that hangs at its first use
should be an error, not an endless wait.

:func:`probe_devices` runs the first CUDA use (``torch.cuda.init()``, the
device count and each card's name) on a daemon thread with a deadline and
turns a hang into :class:`DeviceProbeTimeout`. With
``expect_accelerator=True`` it also raises when no card is found, the torch
form of the JAX package's "silent CPU fallback" check: a script that needs
the card must not quietly run its workload on the CPU.
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional

__all__ = ["DeviceProbeTimeout", "probe_devices"]

_ENV_TIMEOUT = "EVOTORCH_DEVICE_TIMEOUT"


class DeviceProbeTimeout(RuntimeError):
    """The first device use did not complete within the deadline, or found
    no card where one was required."""


def _probe() -> List[str]:
    import torch

    if not torch.cuda.is_available():
        return []
    torch.cuda.init()
    return [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]


def probe_devices(timeout: Optional[float] = None, *, expect_accelerator: bool = False) -> List[str]:
    """The names of the CUDA devices, found under a deadline (an empty list
    without one). ``timeout`` defaults to ``EVOTORCH_DEVICE_TIMEOUT``
    (seconds), else 60. On timeout the probe thread is left parked (a
    daemon: it cannot be cancelled, which is why the hang is detected here
    and not at the first rollout) and ``watchdog.device_probe.timeouts``
    is counted."""
    if timeout is None:
        timeout = float(os.environ.get(_ENV_TIMEOUT, "60"))
    result: dict = {}

    def run():
        try:
            result["devices"] = _probe()
        except BaseException as exc:  # re-raised on the caller's thread below
            result["error"] = exc

    thread = threading.Thread(target=run, name="device-probe", daemon=True)
    thread.start()
    thread.join(timeout)
    if thread.is_alive():
        from ..observability.registry import counters

        counters.increment("watchdog.device_probe.timeouts")
        raise DeviceProbeTimeout(
            f"the first CUDA use is still hanging after {timeout:g} s: the card or its driver is not answering."
            ' Pass device="cpu" to run on the CPU, or fix the card and retry.'
        )
    if "error" in result:
        raise result["error"]
    devices = result["devices"]
    if expect_accelerator and not devices:
        raise DeviceProbeTimeout(
            "the device probe found no CUDA device but one was required: refusing to run a card workload on the CPU"
        )
    return devices
