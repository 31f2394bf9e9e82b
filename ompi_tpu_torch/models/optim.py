"""AdamW for the port: the JAX package's ``optax.adamw`` as plain functions.

The JAX package trains with ``optax.adamw(lr, b1=0.9, b2=0.95,
weight_decay=0.01, mu_dtype=...)``; the card's machine has no optax, so
the port keeps its own copy of those semantics, on dicts of tensors:

- the chain ``scale_by_adam → add_decayed_weights →
  scale_by_learning_rate``;
- ``eps`` outside the square root, ``eps_root`` 0;
- ``count`` an int32 that starts at 0, bias corrections with ``count+1``;
- weight decay on every leaf (no mask);
- ``mu`` computed in f32 from the (possibly bf16) stored value, with
  ``b1`` in the stored dtype, ``mu_hat`` formed from that f32 value, and
  only then ``mu`` cast to ``mu_dtype`` for storage, as the jitted optax
  does;
- ``lr`` a float or a callable ``count → lr``, called with the count
  before the increment, as ``scale_by_schedule`` does.

``count`` lives on the CPU, so a schedule reads it without a device
sync; the moments live beside the parameters.  ``update`` returns a new
state, as optax does; ``update_`` writes the new moments into the
state's own tensors instead (the counterpart of the JAX package's
donated buffers), so a training step holds one set of moments, not two.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Union

import numpy as np
import torch

__all__ = ["AdamWState", "AdamW", "adamw"]


@dataclasses.dataclass
class AdamWState:
    """``count`` (0-d int32, CPU), first and second moments per leaf."""

    count: torch.Tensor
    mu: dict
    nu: dict


@dataclasses.dataclass(frozen=True)
class AdamW:
    """``init(params) → AdamWState``; ``update(grads, state, params) →
    (updates, state)``, updates to be added to the parameters; ``update_``
    the same with the state updated in place."""

    lr: Union[float, Callable[[int], Any]]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 1e-4
    mu_dtype: Any = None

    def _mu_dtype(self, p: torch.Tensor) -> torch.dtype:
        if self.mu_dtype is None:
            return p.dtype
        from ompi_tpu_torch.models.transformer import torch_dtype

        return torch_dtype(self.mu_dtype)

    def init(self, params: dict) -> AdamWState:
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32),
            mu={k: torch.zeros_like(p, dtype=self._mu_dtype(p))
                for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()})

    def update(self, grads: dict, state: AdamWState, params: dict):
        fresh = AdamWState(count=state.count.clone(),
                           mu={k: t.clone() for k, t in state.mu.items()},
                           nu={k: t.clone() for k, t in state.nu.items()})
        return self.update_(grads, fresh, params)

    def update_(self, grads: dict, state: AdamWState, params: dict):
        b1, b2 = self.b1, self.b2
        n = int(state.count) + 1
        # 1 - decay**count in f32, as optax's bias correction
        bc1 = float(1 - np.float32(b1) ** np.float32(n))
        bc2 = float(1 - np.float32(b2) ** np.float32(n))
        lr = self.lr(int(state.count)) if callable(self.lr) else self.lr
        step = -float(lr)
        updates = {}
        with torch.no_grad():
            for k, g in grads.items():
                # optax's ``b1 * mu`` takes the Python float in mu's stored
                # dtype (JAX weak typing: b1 = 0.8984375 for a bf16 mu);
                # the product itself stays f32, as XLA fuses it in the
                # jitted step.  In place, each product and sum rounds as
                # in ``(1 - b1) * g + b1_k * mu`` (a sum commutes exactly)
                mu_k, nu_k = state.mu[k], state.nu[k]
                b1_k = float(torch.tensor(b1, dtype=mu_k.dtype))
                if mu_k.dtype == g.dtype:
                    m = mu_k.mul_(b1_k).add_(g * (1 - b1))
                else:
                    m = (1 - b1) * g + b1_k * mu_k.to(g.dtype)
                    mu_k.copy_(m)               # rounds to mu's dtype
                v = nu_k.mul_(b2).add_((g * g).mul_(1 - b2))
                u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
                u = u + self.weight_decay * params[k]
                updates[k] = step * u
        state.count = torch.tensor(min(n, np.iinfo(np.int32).max),
                                   dtype=torch.int32)
        return updates, state


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4,
          mu_dtype: Any = None) -> AdamW:
    """The signature of ``optax.adamw`` (without ``eps_root``, ``mask`` and
    ``nesterov``, which the JAX package leaves at their defaults)."""
    return AdamW(lr=learning_rate, b1=b1, b2=b2, eps=eps,
                 weight_decay=weight_decay, mu_dtype=mu_dtype)
