"""Supervised neuroevolution: the minibatch loss as fitness (counterpart of
``evotorch_tpu/neuroevolution/supervisedne.py``).

A network's fitness is its loss on the next minibatch; one minibatch is
shared by the whole population in each of ``num_minibatches`` draws, and
the losses are averaged over them. The dataset lives on the problem's
device, the minibatch indices come from the problem's ``torch.Generator``,
and a population's losses are one batched forward: each ``Linear`` is one
``baddbmm`` of the ``(popsize, minibatch, in)`` inputs, and the loss, written
for one network as in the JAX package, is batched over the population by
``torch.vmap``.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import SolutionBatch
from .neproblem import NEProblem

__all__ = ["SupervisedNE", "cross_entropy_loss", "mse_loss"]


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error of one network's predictions."""
    return torch.mean((pred - target) ** 2)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of one network's logits against integer labels or
    one-hot (or soft) label rows."""
    logp = F.log_softmax(logits, dim=-1)
    if labels.ndim == logits.ndim:
        return -torch.mean(torch.sum(labels * logp, dim=-1))
    return -torch.mean(torch.gather(logp, -1, labels[..., None]))


class SupervisedNE(NEProblem):
    def __init__(
        self,
        dataset: Tuple,
        network,
        loss_func: Optional[Callable] = None,
        *,
        network_args: Optional[dict] = None,
        initial_bounds=(-0.00001, 0.00001),
        minibatch_size: Optional[int] = None,
        num_minibatches: Optional[int] = None,
        seed: Optional[int] = None,
        num_actors=None,
        common_minibatch: bool = True,
        device=None,
        **kwargs,
    ):
        """``dataset`` is a pair ``(inputs, targets)`` of arrays or tensors
        with one leading length. ``common_minibatch`` is accepted and has no
        effect: every minibatch is shared by the population, as in the JAX
        package."""
        if not (isinstance(dataset, tuple) and len(dataset) == 2):
            raise TypeError(
                "dataset is expected as a pair (inputs, targets) of arrays"
                " (convert a DataLoader's data to arrays first)"
            )
        inputs, targets = (torch.as_tensor(x) for x in dataset)
        if inputs.shape[0] != targets.shape[0]:
            raise ValueError("inputs and targets must have the same leading length")
        self._dataset_size = int(inputs.shape[0])
        self._minibatch_size = int(minibatch_size) if minibatch_size is not None else min(64, self._dataset_size)
        self._num_minibatches = int(num_minibatches) if num_minibatches is not None else 1
        self._common_minibatch = bool(common_minibatch)
        self._loss_func = loss_func if loss_func is not None else mse_loss

        super().__init__(
            "min",
            network,
            network_args=network_args,
            initial_bounds=initial_bounds,
            seed=seed,
            num_actors=num_actors,
            device=device,
            **kwargs,
        )
        # floating data in the problem's dtype (the JAX package's arrays are
        # float32), integer labels as they are
        self._inputs, self._targets = (
            x.to(device=self.device, dtype=self.dtype if x.is_floating_point() else x.dtype) for x in (inputs, targets)
        )

    @property
    def minibatch_size(self) -> int:
        return self._minibatch_size

    def _sample_minibatch(self, generator: torch.Generator):
        """``minibatch_size`` rows drawn with replacement."""
        idx = torch.randint(0, self._dataset_size, (self._minibatch_size,), generator=generator, device=self.device)
        return self._inputs[idx], self._targets[idx]

    def loss(self, pred, target):
        return self._loss_func(pred, target)

    def _population_losses(self, values: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The loss of each of the ``(N, L)`` networks on one minibatch."""
        rows = x.unsqueeze(0).expand(values.shape[0], *x.shape)
        pred, _ = self._policy(values, rows)  # (N, minibatch, out)
        return torch.vmap(self._loss_func, in_dims=(0, None))(pred, y)

    def _evaluate_batch(self, batch: SolutionBatch):
        values = batch.values
        total = None
        for _ in range(self._num_minibatches):
            x, y = self._sample_minibatch(self.generator)
            losses = self._population_losses(values, x, y)
            total = losses if total is None else total + losses
        batch.set_evals(total / self._num_minibatches)
