"""State carried across from the JAX package.

The solver's state is the matrix, the right-hand sides and the
``Factorization`` artifact (a stack of them for the batched path); the
optimizer's is the parameter tree and its ``step``/``mu``/``nu``/``cov``
state; the language model's is its parameter tree.  These helpers take the
numpy arrays ``np.asarray`` gives of the reference's tensors (bfloat16
ones included) and rebuild them here, on the card unless ``device="cpu"``
is asked for.
"""
from __future__ import annotations

import numpy as np
import torch

from . import device as _device
from .core.factorization import Factorization

__all__ = ["tensor_from_numpy", "factorization_from_numpy", "named_leaves",
           "optimizer_from_numpy", "lm_params_from_numpy", "train_state_from_numpy"]


def tensor_from_numpy(x, *, device=None) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype on ``device``; a
    bfloat16 array (numpy's ``ml_dtypes`` extension type) as bfloat16."""
    x = np.array(x)  # a writable copy
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16).to(_device.resolve(device))
    return torch.from_numpy(x).to(_device.resolve(device))


def factorization_from_numpy(packed, linv=None, uinv=None, tlo=None, tup=None, *, block: int,
                             tier: float = 0.0, structure: str = "dense", bw: int = 0,
                             device=None) -> Factorization:
    """A reference ``Factorization`` (its ``packed``, ``linv``, ``uinv``,
    ``tlo`` and ``tup`` as numpy arrays, plus its ``block``, ``tier``,
    ``structure`` and ``bw``) as this package's artifact; a batched one
    (leading batch axes on every array) gives a batched artifact.  The
    health record is not carried: it is recomputed here when asked for."""
    if structure not in ("dense", "banded"):
        raise ValueError(f"structure is 'dense' or 'banded', got {structure!r}")
    if (structure == "banded") != (bw > 0):
        raise ValueError(f"a {structure} artifact with bw={bw}")
    parts = (linv, uinv, tlo, tup) if structure == "banded" else (linv, uinv)
    if len({x is None for x in parts}) > 1:
        raise ValueError("the enrichments come together (an enriched artifact) or not at all")
    if structure == "dense" and (tlo is not None or tup is not None):
        raise ValueError("a dense artifact has no transfer blocks")
    dev = _device.resolve(device)
    conv = (lambda x: None if x is None else tensor_from_numpy(x, device=dev))
    return Factorization(packed=conv(packed), linv=conv(linv), uinv=conv(uinv), tlo=conv(tlo),
                         tup=conv(tup), structure=structure, bw=int(bw), block=int(block),
                         tier=float(tier))


def named_leaves(tree, prefix: str = "") -> dict:
    """The leaves of a nested dict, in the order ``jax.tree`` flattens it
    (keys sorted at every level), named by their ``.``-joined key paths."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for key in sorted(tree):
        out.update(named_leaves(tree[key], f"{prefix}.{key}" if prefix else str(key)))
    return out


def optimizer_from_numpy(params, state, make_optimizer, *, device=None):
    """The reference's parameter tree (a nested dict of numpy arrays) as
    named ``torch.nn.Parameter`` s, and the optimizer ``make_optimizer``
    builds over them (in the reference's leaf order) carrying the
    reference optimizer's state: ``step`` and the ``mu``/``nu`` (and, for
    the EbV optimizer, ``cov``) trees of ``adamw`` / ``ebv_preconditioned``.
    ``state=None`` leaves the optimizer fresh, as the reference's ``init``
    does.  Returns ``(named_params, optimizer)``; both then compute the
    reference's next step."""
    dev = _device.resolve(device)
    named = {name: torch.nn.Parameter(tensor_from_numpy(x, device=dev))
             for name, x in named_leaves(params).items()}
    opt = make_optimizer(list(named.values()))
    if state is not None:
        parts = {key: named_leaves(state[key]) for key in ("mu", "nu", "cov") if key in state}
        step = int(np.asarray(state["step"]))
        for name, p in named.items():
            st = opt.state[p]
            st["step"] = step
            for key, leaves in parts.items():
                st[key] = tensor_from_numpy(leaves[name], device=dev)
    return named, opt


def lm_params_from_numpy(tree, cfg, *, device=None):
    """The reference's language-model parameter tree (``models/lm.py:
    init_params`` as numpy arrays: ``embed``, ``ln_f.scale``, ``unembed``
    and ``blocks`` stacked on a leading layer axis; the encdec family's
    ``enc_blocks``, stacked too, and ``enc_ln_f.scale``) as this package's
    :class:`repro_torch.models.lm.LM`, so both compute the same function."""
    from .models import lm

    dev = _device.resolve(device)
    model = lm.init_params(0, cfg, device=dev)
    leaves = named_leaves(tree)
    with torch.no_grad():
        for name, p in model.named_parameters():
            parts = name.split(".")
            if parts[0] in ("blocks", "enc_blocks"):  # blocks.<layer>.<path> ← blocks.<path>[layer]
                x = np.asarray(leaves[".".join(parts[:1] + parts[2:])])[int(parts[1])]
            else:
                x = leaves[name]
            t = tensor_from_numpy(x, device=dev)
            if t.shape != p.shape or t.dtype != p.dtype:
                raise ValueError(f"{name}: the tree holds {tuple(t.shape)} {t.dtype}, the model "
                                 f"{tuple(p.shape)} {p.dtype}")
            p.copy_(t)
    return model


def train_state_from_numpy(params, state, cfg, make_optimizer, *, device=None):
    """The reference trainer's state as the port's trainer's: ``params``,
    the language model's tree (``models/lm.py:init_params``, block leaves
    stacked over the layers), and ``state``, the optimizer's
    (``{"step", "mu", "nu"}``, plus ``"cov"`` for ``ebv_preconditioned``;
    None for a fresh one), all numpy arrays.  Returns ``(params,
    optimizer)``: the named stacked leaves of
    :func:`repro_torch.models.lm.train_params` (checked against ``cfg``'s
    layout) and the optimizer ``make_optimizer`` builds over them in that
    order, carrying ``state``; ``repro_torch.train.loop.make_train_step``
    then takes the reference's next step."""
    from .models import lm

    named, opt = optimizer_from_numpy(params, state, make_optimizer, device=device)
    want = lm._train_shapes(cfg)
    got = {k: (tuple(v.shape), v.dtype) for k, v in named.items()}
    if list(got) != list(want) or got != want:
        raise ValueError(f"the tree's leaves {got} are not {cfg.name}'s {want}")
    return named, opt
