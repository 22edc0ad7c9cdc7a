"""Training loop on one device: the train step (gradient accumulation over
microbatches, the optimizer's update), checkpoint and resume, straggler
flagging and throughput logging.

The trainer's parameters are the reference's tree as named leaves in its
flattening order, every block leaf one layer-stacked tensor
(:func:`repro_torch.models.lm.train_params`), and the optimizer is built
over them in that order: its decay (``ndim >= 2``), its preconditioning
(2-D with ``min(shape) <= 1024``), its global-norm sum and its order
groups then see exactly the reference's leaves.  A checkpoint holds
(params, opt_state) in the reference's structure
(:mod:`repro_torch.ckpt.manager`).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import device as _device
from ..ckpt.manager import CheckpointManager
from ..configs.base import ModelConfig
from ..data.pipeline import TokenPipeline
from ..models import lm
from ..models.common import unported
from . import optimizer as opt_lib

__all__ = ["TrainConfig", "make_batch_fn", "make_train_step", "train", "state_tree",
           "load_state_tree"]


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    seq_len: int = 256
    global_batch: int = 8
    microbatches: int = 1
    learning_rate: float = 3e-4
    warmup_steps: int = 20
    optimizer: str = "adamw"  # adamw | ebv
    max_grad_norm: float = 1.0
    seed: int = 0
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0  # a step slower than EMA x this is flagged


def make_batch_fn(model_cfg: ModelConfig, train_cfg: TrainConfig, *, device=None):
    """Pipeline token batches → the model's input dict on ``device`` (the
    card unless ``device="cpu"``): ``{"tokens"}``, and for the encdec family
    also the frontend stub's ``frames`` (B, max(S // 4, 1), d), drawn from
    ``train_cfg.seed`` (:func:`repro_torch.models.lm.stub_frames`: the same
    frames for every batch).  The vlm family's stub comes with that family."""
    if model_cfg.family == "vlm":
        raise unported("training batches of the vlm family", "A6")
    dev = _device.resolve(device)

    def fn(tokens):
        tokens = torch.as_tensor(np.asarray(tokens), device=dev)
        if model_cfg.family == "encdec":
            b, s = tokens.shape
            return {"tokens": tokens, "frames": lm.stub_frames(b, max(s // 4, 1), model_cfg,
                                                               train_cfg.seed, device=dev)}
        return {"tokens": tokens}

    return fn


def make_train_step(model_cfg: ModelConfig, optimizer: torch.optim.Optimizer, *,
                    microbatches: int = 1):
    """``step(params, batch) -> metrics``: one update of ``params`` (the
    trainer's named leaves, the optimizer's parameters in the same order)
    in place.  With ``microbatches > 1`` the batch's rows split into that
    many consecutive microbatches, whose gradients sum in fp32; the sum
    over ``microbatches`` is cast to each parameter's dtype (a ``.grad``
    carries its parameter's dtype).  ``metrics``: loss, gnorm (the
    optimizer's ``last_grad_norm``, before clipping), ce, aux."""

    def grads_of(leaves, params, batch):
        loss, metrics = lm.train_loss(params, batch, model_cfg)
        return loss.detach(), metrics, torch.autograd.grad(loss, leaves)

    def step(params: dict, batch: dict) -> dict:
        leaves = list(params.values())
        if microbatches == 1:
            loss, metrics, grads = grads_of(leaves, params, batch)
        else:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            parts = []
            for i in range(microbatches):
                mb = {k: v.reshape((microbatches, v.shape[0] // microbatches) + v.shape[1:])[i]
                      for k, v in batch.items()}
                l, m, g = grads_of(leaves, params, mb)
                for a, gi in zip(acc, g):
                    a.add_(gi)
                loss = loss + l
                parts.append(m)
            grads = [(a / microbatches).to(p.dtype) for a, p in zip(acc, leaves)]
            loss = loss / microbatches
            metrics = {k: torch.stack([m[k] for m in parts]).mean() for k in parts[0]}
        for p, g in zip(leaves, grads):
            p.grad = g
        optimizer.step()
        for p in leaves:
            p.grad = None
        out = {"loss": loss, "gnorm": optimizer.last_grad_norm}
        out.update({k: v.detach() for k, v in metrics.items()})
        return out

    return step


# ---------------------------------------------------------------------------
# the (params, opt_state) tree of a checkpoint, in the reference's structure
# ---------------------------------------------------------------------------
def _state_keys(optimizer) -> tuple:
    return ("mu", "nu", "cov") if isinstance(optimizer, opt_lib.EbvPreconditioned) else ("mu", "nu")


def state_tree(params: dict, optimizer) -> tuple:
    """``(params, opt_state)`` as the reference's trainer holds them: nested
    dicts, ``opt_state = {"step", "mu", "nu"}`` (and ``"cov"`` for the EbV
    optimizer); a fresh optimizer's state is its zero state."""
    ebv = isinstance(optimizer, opt_lib.EbvPreconditioned)
    for group in optimizer.param_groups:  # the optimizers make their state on first use
        for p in group["params"]:
            if ebv:
                optimizer._state(p, group)
            else:
                optimizer._state(p)
    states = [optimizer.state[p] for p in params.values()]
    opt = {"step": torch.tensor(states[0]["step"], dtype=torch.int32)}
    for key in _state_keys(optimizer):
        opt[key] = lm._nested({k: st[key] for k, st in zip(params, states)})
    return lm._nested(params), opt


def _template(params: dict, optimizer) -> tuple:
    tree = lm._nested(params)
    return tree, {"step": 0, **{key: tree for key in _state_keys(optimizer)}}


def load_state_tree(params: dict, optimizer, tree) -> None:
    """Load a ``(params, opt_state)`` tree (:func:`state_tree`'s structure,
    leaves tensors or numpy arrays) into ``params`` and ``optimizer``."""
    from ..convert import named_leaves

    ptree, otree = tree
    values = named_leaves(ptree)
    parts = {key: named_leaves(otree[key]) for key in _state_keys(optimizer)}
    step = int(otree["step"])
    with torch.no_grad():
        for name, p in params.items():
            v = torch.as_tensor(values[name]).to(p.device)
            if v.shape != p.shape or v.dtype != p.dtype:
                raise ValueError(f"{name}: the checkpoint holds {tuple(v.shape)} {v.dtype}, the "
                                 f"trainer {tuple(p.shape)} {p.dtype}")
            p.copy_(v)
            optimizer.state[p] = {"step": step, **{key: torch.as_tensor(leaves[name]).to(p.device)
                                                   for key, leaves in parts.items()}}


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------
def train(model_cfg: ModelConfig, train_cfg: TrainConfig, *, params=None, on_metrics=None,
          device=None):
    """End-to-end driver on one device (the card unless ``device="cpu"``).
    ``params``: the trainer's leaves (:func:`~repro_torch.models.lm.train_params`)
    or an :class:`~repro_torch.models.lm.LM`; drawn from ``train_cfg.seed``
    when None.  Resumes from the newest checkpoint in ``ckpt_dir`` and the
    pipeline's saved state.  Returns (params, history)."""
    dev = _device.resolve(device)
    schedule = opt_lib.warmup_cosine(train_cfg.learning_rate, train_cfg.warmup_steps,
                                     train_cfg.steps)
    if params is None:
        params = lm.init_params(train_cfg.seed, model_cfg, device=dev)
    if isinstance(params, lm.LM):
        params = lm.train_params(params)
    params = {k: params[k] for k in sorted(params, key=lm._leaf_order)}
    optimizer = opt_lib.get_optimizer(train_cfg.optimizer, list(params.values()), schedule,
                                      max_grad_norm=train_cfg.max_grad_norm)
    pipe = TokenPipeline(vocab_size=model_cfg.vocab_size, seq_len=train_cfg.seq_len,
                         global_batch=train_cfg.global_batch, seed=train_cfg.seed)
    mgr = CheckpointManager(train_cfg.ckpt_dir) if train_cfg.ckpt_dir else None
    start_step = 0
    if mgr and mgr.latest_step() is not None:
        tree, extra, start_step = mgr.restore(_template(params, optimizer))
        load_state_tree(params, optimizer, tree)
        pipe.restore(extra["data"])
        print(f"[train] resumed from step {start_step}")
    pipe.step = max(pipe.step, start_step)

    batch_fn = make_batch_fn(model_cfg, train_cfg, device=dev)
    step_fn = make_train_step(model_cfg, optimizer, microbatches=train_cfg.microbatches)
    history = []
    ema = None
    for step in range(start_step, train_cfg.steps):
        batch = batch_fn(next(pipe)["tokens"])
        t0 = time.perf_counter()
        metrics = {k: float(v) for k, v in step_fn(params, batch).items()}
        dt = time.perf_counter() - t0
        # a slow host shows up as a slow step: flag it for a restart policy
        if ema is not None and dt > train_cfg.straggler_factor * ema and step > start_step + 2:
            print(f"[train][straggler] step {step} took {dt:.3f}s (ema {ema:.3f}s)")
        ema = dt if ema is None else 0.9 * ema + 0.1 * dt
        history.append({"step": step, "time_s": dt, **metrics})
        if on_metrics:
            on_metrics(history[-1])
        if step % train_cfg.log_every == 0:
            tok_s = train_cfg.global_batch * train_cfg.seq_len / dt
            print(f"[train] step {step:5d} loss {metrics['loss']:.4f} {dt*1e3:7.1f} ms/step "
                  f"{tok_s:,.0f} tok/s")
        if mgr and (step + 1) % train_cfg.ckpt_every == 0:
            mgr.save(step + 1, state_tree(params, optimizer), extra={"data": pipe.state()},
                     blocking=False)
    if mgr:
        mgr.save(train_cfg.steps, state_tree(params, optimizer), extra={"data": pipe.state()})
        mgr.wait()
    return params, history
