"""Training step for the flow-matching shape DiT on one device (counterpart
of regen3d_tpu/parallel/train.py's ``make_optimizer``, ``init_state`` and
``train_step``; the mesh and ``data_sharding`` wait for the port's parallel
layer).

The model holds the parameters (f32, ``param_dtype``) and the optimizer
holds AdamW's state and step count, where JAX's ``TrainState`` holds both.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch

from regen3d_tpu_torch.models.dit import (
    ShapeDiT,
    flow_matching_loss,
    init_flax_style_,
)


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float = 1e-4,
                   weight_decay: float = 0.01) -> torch.optim.AdamW:
    """optax's ``adamw(lr, b1=0.9, b2=0.95, weight_decay=wd)`` (eps 1e-8,
    decay on every parameter). Both take the update
    p ← p − lr·(m̂ / (√v̂ + eps) + wd·p) with bias-corrected moments
    m̂ = m / (1 − b1ᵗ) and v̂ = v / (1 − b2ᵗ); torch applies the decoupled
    decay as p·(1 − lr·wd) before the Adam step, which is the same update
    up to f32 rounding."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.95), eps=1e-8,
                             weight_decay=weight_decay)


def init_state(model: ShapeDiT, generator: torch.Generator, lr: float = 1e-4,
               weight_decay: float = 0.01) -> torch.optim.AdamW:
    """Initialise ``model`` flax-style from ``generator`` (as JAX's
    ``model.init``) and return its optimizer, the rest of the state."""
    init_flax_style_(model, generator)
    return make_optimizer(model.parameters(), lr, weight_decay)


def train_step(model: ShapeDiT, optimizer: torch.optim.Optimizer,
               x0: torch.Tensor, cond: torch.Tensor,
               generator: Optional[torch.Generator],
               draws: Optional[Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]] = None) -> torch.Tensor:
    """One flow-matching step: the loss's gradient and an AdamW update.
    Returns the loss (before the update). ``draws`` as in
    ``flow_matching_loss``."""
    optimizer.zero_grad(set_to_none=True)
    loss = flow_matching_loss(model, x0, cond, generator, draws=draws)
    loss.backward()
    optimizer.step()
    return loss.detach()
