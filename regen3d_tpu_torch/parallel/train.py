"""Training step for the flow-matching shape DiT (counterpart of
regen3d_tpu/parallel/train.py's ``make_optimizer``, ``init_state``,
``train_step`` and ``data_sharding``): on one device (:func:`train_step`)
and over a (dp, tp) mesh (:func:`train_step_sharded`, the parameters placed
by ``parallel/mesh.shard_params``); and the optax chains the distillation
trainers use (``OptaxAdamW`` with ``cosine_decay_schedule``,
``warmup_cosine_decay_schedule`` and optax's ``clip_by_global_norm``).

The model holds the parameters (f32, ``param_dtype``) and the optimizer
holds AdamW's state and step count, where JAX's ``TrainState`` holds both.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from regen3d_tpu_torch.models.dit import (
    ShapeDiT,
    flow_draws,
    flow_matching_loss,
    init_flax_style_,
)
from regen3d_tpu_torch.utils import profiling

log = logging.getLogger(__name__)


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


def data_sharding(mesh) -> Tuple:
    """The batch's DTensor placements on a (dp, tp) mesh: its first axis
    over 'dp', replicated over every other axis (JAX's ``P('dp')``)."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(0) if a == "dp" else Replicate()
                 for a in mesh.mesh_dim_names)


def shard_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a global batch under :func:`data_sharding`
    (every rank passes the whole batch, so no rank sends). Raises unless
    dp divides it."""
    from torch.distributed.tensor import distribute_tensor

    dp = mesh.size(mesh.mesh_dim_names.index("dp"))
    if x.shape[0] % dp:
        raise ValueError(f"a batch of {x.shape[0]} does not split over "
                         f"dp={dp}")
    return distribute_tensor(x, mesh, data_sharding(mesh),
                             src_data_rank=None).to_local()


def train_step_sharded(model: ShapeDiT, optimizer: torch.optim.Optimizer,
                       x0: torch.Tensor, cond: torch.Tensor,
                       generator: Optional[torch.Generator], mesh,
                       draws: Optional[Tuple[torch.Tensor, torch.Tensor,
                                             torch.Tensor]] = None
                       ) -> torch.Tensor:
    """One flow-matching step over a (dp, tp) mesh: the global batch's loss,
    its gradient and an AdamW update, as :func:`train_step` computes them
    on one device. ``model``'s parameters are placed by
    ``parallel/mesh.shard_params``; every rank passes the same global batch
    (``x0``, ``cond``) and a generator in the same state (or the global
    ``draws``), and takes its dp rows. The global mean is the mean of the
    dp ranks' equal-sized means, so each gradient is summed over 'dp' and
    divided by dp (one all-reduce per dtype; none at dp = 1). Returns the
    global loss (before the update)."""
    i = mesh.mesh_dim_names.index("dp")
    dp, group = mesh.size(i), mesh.get_group(i)
    if draws is None:
        draws = flow_draws(x0, generator)
    optimizer.zero_grad(set_to_none=True)
    loss = flow_matching_loss(model, shard_batch(x0, mesh),
                              shard_batch(cond, mesh), None,
                              draws=tuple(shard_batch(d, mesh)
                                          for d in draws))
    loss.backward()
    loss = loss.detach()
    if dp > 1:
        _mean_over(model, group, dp)
        loss = loss.clone()
        dist.all_reduce(loss, group=group)
        loss = loss / dp
    optimizer.step()
    return loss


def _mean_over(model: torch.nn.Module, group, n: int) -> None:
    """Every gradient summed over ``group`` and divided by ``n``, in one
    all-reduce per dtype (a flat copy of the gradients, written back)."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in model.parameters():
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=group)
        flat /= n
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


# ---------------------------------------------------------------------------
# optax's schedules and AdamW, step for step


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """optax's ``cosine_decay_schedule`` in f32: init·((1 − alpha)·½(1 +
    cos(π·min(count, T)/T)) + alpha)."""
    if decay_steps <= 0:
        raise ValueError(f"cosine_decay_schedule: decay_steps {decay_steps}")
    f = np.float32

    def schedule(count: int) -> float:
        c = f(min(count, decay_steps))
        cosine = f(0.5) * (f(1) + np.cos(f(np.pi) * c / f(decay_steps)))
        return float(f(init_value) * ((f(1) - f(alpha)) * cosine + f(alpha)))

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax's ``warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps`` (a constant ``init_value``
    schedule at 0 warm-up steps, as optax's ``linear_schedule``), then a
    cosine from ``peak_value`` to ``end_value`` over the other
    ``decay_steps − warmup_steps``, joined at ``warmup_steps``."""
    f = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                   alpha)

    def linear(count: int) -> float:
        if warmup_steps <= 0:
            return float(f(init_value))
        c = f(min(max(count, 0), warmup_steps))
        frac = f(1) - c / f(warmup_steps)
        return float((f(init_value) - f(peak_value)) * frac + f(peak_value))

    def schedule(count: int) -> float:
        return linear(count) if count < warmup_steps else \
            cosine(count - warmup_steps)

    return schedule


class OptaxAdamW:
    """optax's ``adamw(schedule, b1, b2, eps, weight_decay)``, optionally
    after ``clip_by_global_norm(clip_norm)`` (``optax.chain``), on a list
    of f32 parameters, step for step:

    * the clip: with g_norm = √Σ g² over every gradient, the gradients stay
      as they are where g_norm < clip_norm and become (g / g_norm)·clip_norm
      otherwise (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``);
    * μ = (1 − b1)·g + b1·μ, ν = (1 − b2)·g² + b2·ν, bias-corrected by
      1 − bᵗ at the count after the step, u = μ̂ / (√ν̂ + eps);
    * u + wd·p, every parameter decayed (optax's default mask);
    * p − lr·(…) with lr the schedule at the count BEFORE the step, so the
      first step takes ``schedule(0)``.

    Gradients come from ``p.grad`` (a parameter without one takes a zero
    gradient, as an unused flax leaf does)."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4,
                 clip_norm: Optional[float] = None):
        self.params: List[torch.nn.Parameter] = list(params)
        for p in self.params:
            if p.dtype != torch.float32:
                raise ValueError(f"OptaxAdamW takes f32 parameters, got "
                                 f"{p.dtype}")
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.weight_decay, self.clip_norm = weight_decay, clip_norm
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One update of every parameter, with multi-tensor (``foreach``)
        operations: a few launches for the whole list on the card."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.clip_norm is not None:
            g_norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            # (g / g_norm)·clip as g·(clip / g_norm): the same to an ulp
            scale = torch.where(g_norm < self.clip_norm,
                                torch.ones_like(g_norm),
                                self.clip_norm / g_norm)
            grads = torch._foreach_mul(grads, scale)
        f = np.float32
        lr = self.schedule(self.count)
        self.count += 1
        c1 = float(f(1) - f(self.b1) ** f(self.count))
        c2 = float(f(1) - f(self.b2) ** f(self.count))
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, c2))
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(torch._foreach_div(self.mu, c1), denom)
        torch._foreach_add_(u, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, u, alpha=-lr)


def on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def train_steps(tag: str, steps: int, sample: Callable[[int], tuple],
                loss_fn: Callable[..., torch.Tensor], optimizer: OptaxAdamW,
                device, log_every: int = 0) -> np.ndarray:
    """The distillation trainers' loop: ``sample(i)`` draws step i's batch
    on the host (numpy arrays, or tensors it made), one step ahead in a
    worker thread, so the draws keep their order while the card runs the
    step before (span ``<tag>.data``: the wait for it); the arrays go to
    ``device``; then the loss of ``loss_fn(*batch)``, its gradient and the
    optimiser step (host span and device span ``<tag>.step``).
    ``loss_fn`` returns the loss, or (loss, {name: term}) whose terms are
    logged beside it. Every ``log_every`` steps (and the last) the loss is
    logged, which waits for the card; otherwise the host runs ahead.
    Returns the losses (f32)."""
    import concurrent.futures

    def to_device(a):
        return torch.from_numpy(a).to(device) if isinstance(a, np.ndarray) \
            else a

    losses = []
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        nxt = pool.submit(sample, 0) if steps else None
        for i in range(steps):
            with profiling.timed(f"{tag}.data", log_it=False):
                batch = tuple(to_device(a) for a in nxt.result())
            if i + 1 < steps:
                nxt = pool.submit(sample, i + 1)
            with profiling.timed(f"{tag}.step", log_it=False), \
                    profiling.device_timed(f"{tag}.step", device):
                optimizer.zero_grad()
                out = loss_fn(*batch)
                loss, aux = out if isinstance(out, tuple) else (out, {})
                loss.backward()
                optimizer.step()
            losses.append(loss.detach())
            if log_every and (i % log_every == 0 or i == steps - 1):
                terms = " ".join(f"{k} {float(v.detach()):.3f}"
                                 for k, v in aux.items())
                log.info("%s step %d/%d loss %.4f%s", tag, i, steps,
                         float(loss.detach()), f" ({terms})" if terms else "")
    return torch.stack(losses).float().cpu().numpy() if losses else \
        np.zeros(0, np.float32)
