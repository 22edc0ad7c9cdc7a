"""Optimizers: AdamW, gradient clipping, LR schedules, and the paper's solver
inside an optimizer — an EbV-preconditioned second-order optimizer whose
inverse application is a batched EbV LU solve.  For every eligible 2-D
parameter it keeps a Kronecker-factor covariance ``C = β₂C + (1−β₂) G Gᵀ``
and preconditions with the solution of ``(C/τ + λI) P = G``: the linear
system the paper's solver was built for, in place of the usual
inverse-p-th-root eigendecomposition.

Both optimizers are ``torch.optim.Optimizer`` s: they read each
parameter's ``.grad``, update the parameters in place, and keep ``step``,
``mu``, ``nu`` (and ``cov``) per parameter in ``self.state``.  ``lr`` is a
float or a schedule ``step -> lr`` (:func:`warmup_cosine`,
:func:`constant_lr`).  Every other hyperparameter may differ between param
groups; the global-norm clip spans all of them.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable

import torch

__all__ = [
    "warmup_cosine",
    "constant_lr",
    "global_norm",
    "clip_by_global_norm",
    "AdamW",
    "EbvPreconditioned",
    "get_optimizer",
]

# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1) -> Callable[[int], float]:
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``floor · peak_lr`` at ``total_steps``."""

    def schedule(step) -> float:
        step = float(step)
        if step < warmup_steps:
            return peak_lr * step / max(warmup_steps, 1)
        frac = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return peak_lr * (floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * frac)))

    return schedule


def constant_lr(lr: float) -> Callable[[int], float]:
    return lambda step: float(lr)


# ---------------------------------------------------------------------------
# global-norm clipping
# ---------------------------------------------------------------------------
def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """fp32 L2 norm over every entry of ``tensors``."""
    return torch.sqrt(sum(x.to(torch.float32).square().sum() for x in tensors))


def clip_by_global_norm(tensors, max_norm: float):
    """``(clipped, norm)``: every tensor scaled by ``min(1, max_norm / norm)``
    and cast back to its dtype."""
    tensors = list(tensors)
    norm = global_norm(tensors)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return [(x * scale).to(x.dtype) for x in tensors], norm


def _lr(group: dict, step: int) -> float:
    lr = group["lr"]
    return float(lr(step)) if callable(lr) else float(lr)


def _with_grads(optimizer: torch.optim.Optimizer):
    """``(group, param)`` for every parameter that has a gradient."""
    return [(g, p) for g in optimizer.param_groups for p in g["params"] if p.grad is not None]


def _adam_moments(g32, mu, nu, group, step):
    b1, b2 = group["b1"], group["b2"]
    mu32 = mu.to(torch.float32) * b1 + (1 - b1) * g32
    nu32 = nu.to(torch.float32) * b2 + (1 - b2) * g32 * g32
    bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
    adam_dir = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + group["eps"])
    return mu32, nu32, adam_dir, bc1


def _apply(p, step_dir, group, lr) -> None:
    if group["weight_decay"] and p.ndim >= 2:  # no decay on norms and scalars
        step_dir = step_dir + group["weight_decay"] * p.to(torch.float32)
    p.copy_((p.to(torch.float32) - lr * step_dir).to(p.dtype))


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
class AdamW(torch.optim.Optimizer):
    """AdamW with decoupled weight decay and optional global-norm clipping;
    ``state_dtype`` keeps ``mu``/``nu`` in another dtype than the
    parameters'."""

    def __init__(self, params, lr=1e-3, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float | None = 1.0,
                 state_dtype: torch.dtype | None = None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay))
        self.max_grad_norm = max_grad_norm
        self.state_dtype = state_dtype
        self.last_grad_norm: torch.Tensor | None = None

    def _state(self, p):
        st = self.state[p]
        if not st:
            dt = self.state_dtype or (p.dtype if p.dtype.is_floating_point else torch.float32)
            st.update(step=0, mu=torch.zeros_like(p, dtype=dt), nu=torch.zeros_like(p, dtype=dt))
        return st

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        pairs = _with_grads(self)
        grads = [p.grad for _, p in pairs]
        if self.max_grad_norm is not None:
            grads, self.last_grad_norm = clip_by_global_norm(grads, self.max_grad_norm)
        else:
            self.last_grad_norm = global_norm(grads)
        for (group, p), g in zip(pairs, grads):
            st = self._state(p)
            st["step"] += 1
            mu32, nu32, adam_dir, _ = _adam_moments(g.to(torch.float32), st["mu"], st["nu"],
                                                    group, st["step"])
            _apply(p, adam_dir, group, _lr(group, st["step"]))
            st["mu"].copy_(mu32)
            st["nu"].copy_(nu32)
        return loss


# ---------------------------------------------------------------------------
# EbV-preconditioned optimizer (the paper's solver inside the optimizer)
# ---------------------------------------------------------------------------
class EbvPreconditioned(torch.optim.Optimizer):
    """Second-order preconditioning via batched EbV LU solves.

    Eligible parameters: 2-D with ``min(shape) <= max_precond_dim``; the
    covariance is built on the smaller dimension.  The rest take the AdamW
    step.  Per step the covariance EMA sees the *raw* gradient (clipping
    rescales each step differently, and an EMA over inconsistently scaled
    ``G·Gᵀ`` terms stops estimating curvature), and the solve's right-hand
    side is the bias-corrected Adam momentum built from clipped gradients.
    The solved direction is norm-grafted onto ``graft_scale ×`` the Adam
    step's magnitude.

    The ``(C/τ + λI) P = G`` systems are grouped by order and each group
    is solved by one ``ops.linear_solve`` on the stacked ``(B, n, n)``
    operands (a narrower RHS zero-pads to the group's widest), factored
    with ``enrich=True``: on the card the batched CUDA factor and solve
    (:mod:`repro_torch.kernels.batched_lu`), one launch each per group.
    ``solver_impl`` forces a backend (``"torch"`` for the plain versions).

    ``solve_tolerance`` opens the registry's approximate tiers for the
    preconditioner solves: a float is the largest acceptable relative
    residual; ``"auto"`` derives it from the EMA noise floor — each update
    replaces a fraction ``1 − b2`` of ``C`` with one sample's ``G Gᵀ``, so
    the solve is taken one decade past that noise, and never below the
    ``bf16_ir`` tier's 1e-6 floor.  On the card a group then runs the
    batched ``bf16_ir`` tier (B9 on the bf16-rounded stack, B10 for every
    refinement sweep).  ``None`` (the default) keeps the exact tier."""

    def __init__(self, params, lr=1e-3, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float | None = 1.0,
                 damping: float = 1e-3, max_precond_dim: int = 1024, solver_block: int = 128,
                 graft_scale: float = 0.3, solver_impl: str | None = None,
                 solve_tolerance: float | str | None = None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                                      damping=damping, max_precond_dim=max_precond_dim,
                                      graft_scale=graft_scale))
        self.max_grad_norm = max_grad_norm
        self.solver_block = solver_block
        self.solver_impl = solver_impl
        if solve_tolerance == "auto":
            self.solve_tolerance = max(1e-6, (1.0 - b2) * 0.1)
        else:
            self.solve_tolerance = float(solve_tolerance) if solve_tolerance else 0.0
        self.last_grad_norm: torch.Tensor | None = None

    @staticmethod
    def eligible(p: torch.Tensor, group: dict) -> bool:
        return p.ndim == 2 and min(p.shape) <= group["max_precond_dim"]

    def _state(self, p, group):
        st = self.state[p]
        if not st:
            k = min(p.shape) if self.eligible(p, group) else 0
            st.update(step=0, mu=torch.zeros_like(p, dtype=torch.float32),
                      nu=torch.zeros_like(p, dtype=torch.float32),
                      cov=torch.zeros((k, k), dtype=torch.float32, device=p.device))
        return st

    @torch.no_grad()
    def step(self, closure=None):
        from ..kernels import ops  # deferred: the kernels import the solver stack

        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        pairs = _with_grads(self)
        gnorm = global_norm(p.grad for _, p in pairs)
        self.last_grad_norm = gnorm
        clip_scale = (torch.clamp(self.max_grad_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
                      if self.max_grad_norm is not None else 1.0)

        # pass 1: Adam moments and covariance EMAs; collect the eligible
        # (C/tau + lambda I) P = G systems, grouped by order n
        stats, groups = [], {}
        for i, (group, p) in enumerate(pairs):
            st = self._state(p, group)
            st["step"] += 1
            g32 = p.grad.to(torch.float32)
            mu32, nu32, adam_dir, bc1 = _adam_moments(g32 * clip_scale, st["mu"], st["nu"], group,
                                                      st["step"])
            left = None
            if self.eligible(p, group):
                left = p.shape[0] <= p.shape[1]
                gg = g32 @ g32.T if left else g32.T @ g32
                b2 = group["b2"]
                st["cov"] = b2 * st["cov"] + (1 - b2) * gg
                n = gg.shape[0]
                tr = torch.trace(st["cov"]) / n
                a = (st["cov"] / torch.clamp(tr, min=1e-12)
                     + group["damping"] * torch.eye(n, dtype=torch.float32, device=p.device))
                rhs = mu32 / bc1
                groups.setdefault(n, []).append((i, a, rhs if left else rhs.T))
            stats.append((mu32, nu32, adam_dir, left))

        # one batched dispatch per order group; narrower RHS zero-pad to the widest
        solved = {}
        for n, items in sorted(groups.items()):
            mmax = max(r.shape[1] for _, _, r in items)
            a3 = torch.stack([a for _, a, _ in items])
            r3 = torch.stack([torch.nn.functional.pad(r, (0, mmax - r.shape[1]))
                              for _, _, r in items])
            x3 = ops.linear_solve(a3, r3, impl=self.solver_impl, block=min(self.solver_block, n),
                                  tolerance=self.solve_tolerance, enrich=True)
            for j, (i, _, r) in enumerate(items):
                solved[i] = x3[j, :, :r.shape[1]]

        # pass 2: grafting, weight decay, parameter update
        for i, (group, p) in enumerate(pairs):
            mu32, nu32, adam_dir, left = stats[i]
            if i in solved:
                pre = solved[i] if left else solved[i].T
                target = group["graft_scale"] * torch.linalg.norm(adam_dir)
                step_dir = pre * (target / torch.clamp(torch.linalg.norm(pre), min=1e-12))
            else:
                step_dir = adam_dir
            st = self.state[p]
            _apply(p, step_dir, group, _lr(group, st["step"]))
            st["mu"].copy_(mu32)
            st["nu"].copy_(nu32)
        return loss


def get_optimizer(name: str, params, lr, **kw) -> torch.optim.Optimizer:
    """``"adamw"`` or ``"ebv"`` over ``params`` with ``lr`` a float or a
    schedule."""
    if name == "adamw":
        return AdamW(params, lr, **kw)
    if name == "ebv":
        return EbvPreconditioned(params, lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
