"""Top-level language model: embedding → blocks → final norm → logits, for
the dense, encdec and moe families.

Entry points, as the reference's ``models/lm.py``:

* ``init_params(key, cfg)`` — the model (:class:`LM`), drawn from a
  ``torch.Generator`` (or an int seed) on the card unless ``device="cpu"``;
* ``prefill(params, batch, cfg)`` — (caches, last-token logits);
* ``decode_step(params, caches, tokens, pos, cfg)`` — (caches, logits);
* ``init_caches`` / ``init_paged_caches`` — empty layer-stacked caches;
* ``train_params(model)`` — the trainer's parameters: the reference's
  tree, every block leaf one layer-stacked tensor (L, ...);
* ``train_loss(params, batch, cfg)`` — (scalar CE + aux_weight · aux,
  {"ce", "aux"}), the CE in fp32 over ``seq_chunk`` slices of the
  sequence, the aux the moe family's load-balance loss summed over the
  layers;
* ``stub_frames(batch, enc_len, cfg, seed)`` — the encdec family's audio
  frontend stub, frame embeddings drawn from a seed.

The encdec family (whisper) takes ``batch = {"tokens", "frames"}``: the
frames plus a sinusoid run through ``enc_blocks`` and ``enc_ln_f``, and the
decoder's tokens get a sinusoid at their plain positions; each decoder
layer's cross attention reads the encoder's output, and its decode cache
keeps the cross K/V per slot (``cross_k`` / ``cross_v``).  The moe family
(mixtral, granite) takes ``batch = {"tokens"}``; its blocks hold a
:class:`~.moe.MoE` layer in place of the MLP, and mixtral's sliding window
keeps a ring of ``window`` cache slots.

The reference's ``lax.scan`` over stacked blocks is a Python loop over
``LM.blocks``; caches stay layer-stacked ((L, ...) leading axis), and each
layer works on its view, so a decode step updates its caches in place.
Serving keeps one :class:`~.blocks.Block` per layer.  Training keeps the
reference's stacked leaves (the optimizers key their rules on a leaf's
shape), unbinds them into the layers' weights once per forward (the
backward of ``unbind`` is one stack) and runs each layer under
``torch.utils.checkpoint``, the reference's ``jax.checkpoint``.
"""
from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import device as _device
from ..configs.base import ModelConfig
from . import blocks as B
from . import common as C

__all__ = ["LM", "padded_vocab_size", "init_params", "prefill", "decode_step", "init_caches",
           "init_paged_caches", "train_params", "train_loss", "stub_frames"]


def padded_vocab_size(cfg: ModelConfig) -> int:
    return -(-cfg.vocab_size // 128) * 128


class LM(nn.Module):
    """``embed`` (V, d), ``blocks`` (one :class:`~.blocks.Block` per layer),
    ``ln_f``, ``unembed`` (d, V); V is the vocabulary padded to 128.  The
    encdec family adds ``enc_blocks`` (one encoder block per encoder layer)
    and ``enc_ln_f``; the moe family's blocks hold ``moe`` in place of
    ``mlp``."""

    def __init__(self, gen: torch.Generator, cfg: ModelConfig):
        super().__init__()
        if cfg.family not in B.PORTED:
            raise C.unported(f"the {cfg.family} family")
        dt, vp = C.dtype_of(cfg.dtype), padded_vocab_size(cfg)
        self.cfg = cfg
        self.embed = C.dense_init(gen, (vp, cfg.d_model), dt, scale=0.02)
        self.blocks = nn.ModuleList(B.init_block(gen, cfg) for _ in range(cfg.num_layers))
        self.ln_f = C.init_norm(cfg, device=gen.device)
        self.unembed = C.dense_init(gen, (cfg.d_model, vp), dt)
        if cfg.family == "encdec":
            self.enc_blocks = nn.ModuleList(B.init_block(gen, cfg, encoder=True)
                                            for _ in range(cfg.encoder_layers))
            self.enc_ln_f = C.init_norm(cfg, device=gen.device)


def init_params(key, cfg: ModelConfig, *, device=None) -> LM:
    """The model with weights drawn from ``key``: a ``torch.Generator`` (on
    the device it draws on) or an int seed for a generator on ``device``
    (the card unless ``device="cpu"``)."""
    if not isinstance(key, torch.Generator):
        key = torch.Generator(device=_device.resolve(device)).manual_seed(int(key))
    return LM(key, cfg)


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _run_blocks(params: LM, x, cfg: ModelConfig, *, positions, mode, caches=None, enc_out=None,
                kv_chunk=1024, cache_len=None, seq_positions=None, page_table=None, prior=None,
                raw_kv=False):
    """The layer loop.  ``caches`` and ``prior`` are layer-stacked; each layer
    gets its (L,)-index view, and all share one pair of RoPE tables and the
    encoder's output ``enc_out`` (encdec).  In ``train`` mode each layer
    runs under ``torch.utils.checkpoint``: only its inputs are kept, and the
    backward recomputes the layer.
    Returns (x, layer-stacked new caches or None, the layers' summed aux)."""
    rope = C.rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta) if cfg.use_rope else None
    new = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, bp in enumerate(params.blocks):
        kw = dict(positions=positions, mode=mode, enc_out=enc_out,
                  cache=None if caches is None else _tree_map(lambda t: t[i], caches),
                  kv_chunk=kv_chunk, cache_len=cache_len, seq_positions=seq_positions,
                  page_table=page_table,
                  prior=None if prior is None else _tree_map(lambda t: t[i], prior),
                  raw_kv=raw_kv, rope=rope)
        if mode == "train":
            x, nc, a = checkpoint(B.apply_block, bp, x, cfg, use_reentrant=False,
                                  preserve_rng_state=False, **kw)
        else:
            x, nc, a = B.apply_block(bp, x, cfg, **kw)
        aux = aux + a
        new.append(nc)
    if mode == "decode":
        return x, caches, aux  # updated in place, layer by layer
    if new[0] is None:
        return x, None, aux
    return x, _tree_map(lambda *ts: torch.stack(ts), *new), aux


def _tokens(params: LM, tokens) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params.embed.device).long()


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Whisper's fixed position embedding, fp32 (N, d): [sin, cos] of
    ``positions * 10000^(-2i/d)``."""
    inv = 1.0 / (10000 ** (torch.arange(0, d, 2, dtype=torch.float32, device=positions.device) / d))
    ang = positions[:, None].to(torch.float32) * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def stub_frames(batch: int, enc_len: int, cfg: ModelConfig, seed: int = 0, *, device=None):
    """The encdec family's audio frontend stub: (batch, enc_len, d) frame
    embeddings, standard normal in fp32 from a ``torch.Generator`` seeded by
    ``seed`` on ``device`` (the card unless ``device="cpu"``), cast to the
    config's dtype.  The serving engine draws them with seed 0 for every
    prompt, the trainer with its config's seed for every batch.  The
    reference draws the same law from JAX's ``PRNGKey(seed)``, so the
    values differ (ROADMAP §C)."""
    dev = _device.resolve(device)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    f = torch.randn((batch, enc_len, cfg.d_model), generator=g, device=dev, dtype=torch.float32)
    return f.to(C.dtype_of(cfg.dtype))


def _encode(params, frames, cfg: ModelConfig, *, train: bool = False) -> torch.Tensor:
    """The encoder's output (B, Se, d) over ``frames`` (B, Se, d): the frames
    plus the sinusoid at their positions, the encoder layers (each under
    ``torch.utils.checkpoint`` in training), then ``enc_ln_f``."""
    frames = torch.as_tensor(frames, device=params.embed.device)
    fpos = torch.arange(frames.shape[1], dtype=torch.int32, device=frames.device)
    h = frames + _sinusoid(fpos, cfg.d_model)[None].to(frames.dtype)
    for bp in params.enc_blocks:
        if train:
            h = checkpoint(B.apply_encoder_block, bp, h, cfg, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = B.apply_encoder_block(bp, h, cfg)
    return C.apply_norm(params.enc_ln_f, h, cfg.norm)


def _embed(params, batch, cfg: ModelConfig, *, train: bool = False):
    """The decoder's input: (tokens (B, S), their embeddings x, the encoder's
    output or None).  The encdec family runs the encoder over
    ``batch["frames"]`` and adds the sinusoid at the plain positions 0..S-1
    to x."""
    tokens = _tokens(params, batch["tokens"])
    x = F.embedding(tokens, params.embed)  # its backward sums a row's terms in one order on the CPU
    enc_out = None
    if cfg.family == "encdec":
        enc_out = _encode(params, batch["frames"], cfg, train=train)
        tpos = torch.arange(tokens.shape[1], dtype=torch.int32, device=x.device)
        x = x + _sinusoid(tpos, cfg.d_model)[None].to(x.dtype)
    return tokens, x, enc_out


@torch.no_grad()
def prefill(params: LM, batch, cfg: ModelConfig, *, cache_len=None, kv_chunk=1024, last=None,
            prior=None, raw_kv=False):
    """Full-sequence forward building the decode cache; returns (caches,
    logits (B, 1, V) fp32 at the last token).

    ``last`` (B,) picks each row's true last token (right-padded bucketed
    prompts).  ``prior`` = layer-stacked {"k","v": (L, B, Sp, KV, Dh)} is a
    cached prompt prefix of Sp tokens: the rows of ``batch`` are the prompt
    suffix at positions Sp, Sp+1, ...  ``raw_kv=True`` returns each layer's
    fresh K/V ({"attn": {"k","v"}}) instead of dense cache rows.  The encdec
    family's ``batch`` also holds ``frames`` (B, Se, d), and its caches the
    projected ``cross_k`` / ``cross_v`` (L, B, Se, KV, Dh)."""
    tokens, x, enc_out = _embed(params, batch, cfg)
    b, s = tokens.shape
    seq_pos = torch.arange(s, dtype=torch.int32, device=x.device)
    if prior is not None:
        seq_pos = seq_pos + prior["k"].shape[2]
    positions = seq_pos[None].expand(b, s)
    x, caches, _ = _run_blocks(params, x, cfg, positions=positions, mode="prefill",
                               enc_out=enc_out, kv_chunk=kv_chunk, cache_len=cache_len,
                               seq_positions=seq_pos, prior=prior, raw_kv=raw_kv)
    x = C.apply_norm(params.ln_f, x, cfg.norm)
    if last is None:
        sel = x[:, -1:]
    else:
        sel = x[torch.arange(b, device=x.device), _tokens(params, last)][:, None]
    return caches, C.matmul_f32(sel, params.unembed)


@torch.no_grad()
def decode_step(params: LM, caches, tokens, pos, cfg: ModelConfig, *, page_table=None):
    """One decode step.  tokens (B, 1); pos a scalar (every row at the same
    depth) or (B,) per-row positions; ``caches`` from :func:`prefill` /
    :func:`init_caches`, or :func:`init_paged_caches` with ``page_table``
    (B, NP) int32.  Updates ``caches`` in place and returns (caches, logits
    (B, 1, V) fp32).  The encdec family adds the sinusoid at ``pos`` and
    reads the cached cross K/V."""
    tokens = _tokens(params, tokens)
    x = params.embed[tokens]
    b = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device).expand(b)
    if cfg.family == "encdec":
        x = x + _sinusoid(pos, cfg.d_model)[:, None, :].to(x.dtype)
    x, caches, _ = _run_blocks(params, x, cfg, positions=pos[:, None], mode="decode",
                               caches=caches, seq_positions=pos, page_table=page_table)
    x = C.apply_norm(params.ln_f, x, cfg.norm)
    return caches, C.matmul_f32(x, params.unembed)


def init_caches(cfg: ModelConfig, batch: int, seq_len: int, *, enc_len: int = 0, dtype=None,
                device=None) -> dict:
    """Layer-stacked dense cache {"attn": {"k","v": (L, B, S, KV, Dh), "pos":
    (L, B, S)}}, all zeros (``pos`` too, as the reference's), on the card
    unless ``device="cpu"``; the encdec family adds ``cross_k`` / ``cross_v``
    (L, B, enc_len, KV, Dh)."""
    dtype = dtype or C.dtype_of(cfg.dtype)
    one = B.init_block_cache(cfg, batch, seq_len, dtype, enc_len=enc_len,
                             device=_device.resolve(device))
    return _tree_map(lambda a: a.new_zeros((cfg.num_layers,) + a.shape), one)


def init_paged_caches(cfg: ModelConfig, batch: int, num_pages: int, page_size: int, *,
                      enc_len: int = 0, dtype=None, device=None) -> dict:
    """Layer-stacked cache whose attention K/V is a shared page pool
    {"attn": {"k_pages","v_pages": (L, num_pages, page_size, KV, Dh)}}.  The
    parts that do not grow with the sequence (encdec's ``cross_k`` /
    ``cross_v``, (L, B, enc_len, KV, Dh)) stay per slot, dense."""
    if cfg.sliding_window is not None:
        raise ValueError("paged KV cache does not support sliding-window archs")
    dtype = dtype or C.dtype_of(cfg.dtype)
    caches = init_caches(cfg, batch, 0, enc_len=enc_len, dtype=dtype, device=device)
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads, cfg.resolved_head_dim)
    dev = _device.resolve(device)
    caches["attn"] = {"k_pages": torch.zeros(shape, dtype=dtype, device=dev),
                      "v_pages": torch.zeros(shape, dtype=dtype, device=dev)}
    return caches


# ---------------------------------------------------------------------------
# training: the reference's stacked leaves, the loss
# ---------------------------------------------------------------------------
def _leaf_order(name: str):
    return name.split(".")  # ``convert.named_leaves`` order: keys sorted at every level


def train_params(model: LM) -> dict:
    """The trainer's parameters, copied from ``model``: the reference's
    parameter tree as named leaves (``embed``, ``ln_f.scale``, ``unembed``,
    ``blocks.<path>``; the encdec family's ``enc_blocks.<path>`` and
    ``enc_ln_f.scale`` too) in the order ``jax.tree`` flattens it, each
    block leaf one ``nn.Parameter`` stacked over its stack's layers,
    (L, ...).  The optimizers decay, precondition and order these leaves as
    the reference's optimizers do theirs."""
    singles = [("embed", model.embed), ("ln_f.scale", model.ln_f.scale), ("unembed", model.unembed)]
    stacks = [("blocks", model.blocks)]
    if model.cfg.family == "encdec":
        singles.append(("enc_ln_f.scale", model.enc_ln_f.scale))
        stacks.append(("enc_blocks", model.enc_blocks))
    flat = {k: p.detach().clone() for k, p in singles}
    for prefix, blocks in stacks:
        layers = [dict(b.named_parameters()) for b in blocks]
        for name in layers[0]:
            flat[f"{prefix}.{name}"] = torch.stack([layer[name].detach() for layer in layers])
    return {k: nn.Parameter(flat[k]) for k in sorted(flat, key=_leaf_order)}


def _train_shapes(cfg: ModelConfig) -> dict:
    """``{name: (shape, dtype)}`` of :func:`train_params` for ``cfg``, in its
    order, without drawing a model."""
    if cfg.family not in B.PORTED:
        raise C.unported(f"the {cfg.family} family")
    dt, vp, d = C.dtype_of(cfg.dtype), padded_vocab_size(cfg), cfg.d_model
    hd, kvd = cfg.num_heads * cfg.resolved_head_dim, cfg.num_kv_heads * cfg.resolved_head_dim
    f32 = torch.float32
    attn = {"wq": ((d, hd), dt), "wk": ((d, kvd), dt), "wv": ((d, kvd), dt), "wo": ((hd, d), dt)}
    block = {**{f"attn.{k}": v for k, v in attn.items()}, "ln_attn.scale": ((d,), f32),
             "ln_mlp.scale": ((d,), f32), "mlp.wu": ((d, cfg.d_ff), dt),
             "mlp.wd": ((cfg.d_ff, d), dt)}
    if cfg.mlp_gated:
        block["mlp.wg"] = ((d, cfg.d_ff), dt)
    shapes = {"embed": ((vp, d), dt), "ln_f.scale": ((d,), f32), "unembed": ((d, vp), dt)}
    stacks = [("blocks", cfg.num_layers, block)]
    if cfg.family == "moe":  # the router fp32 (d, E), the experts (E, d, d_ff) and (E, d_ff, d)
        e, f = cfg.num_experts, cfg.d_ff
        experts = {"moe.router": ((d, e), f32), "moe.wu": ((e, d, f), dt), "moe.wd": ((e, f, d), dt)}
        if cfg.mlp_gated:
            experts["moe.wg"] = ((e, d, f), dt)
        stacks = [("blocks", cfg.num_layers,
                   {**{k: v for k, v in block.items() if not k.startswith("mlp.")}, **experts})]
    if cfg.family == "encdec":
        decoder = {**block, **{f"cross.{k}": v for k, v in attn.items()}, "ln_cross.scale": ((d,), f32)}
        stacks = [("blocks", cfg.num_layers, decoder), ("enc_blocks", cfg.encoder_layers, block)]
        shapes["enc_ln_f.scale"] = ((d,), f32)
    for prefix, layers, leaves in stacks:
        for k, (s, t) in leaves.items():
            shapes[f"{prefix}.{k}"] = ((layers,) + s, t)
    return {k: shapes[k] for k in sorted(shapes, key=_leaf_order)}


def _nested(flat: dict) -> dict:
    """``{"a.b": x, ...}`` → ``{"a": {"b": x}, ...}``: named leaves as a tree."""
    tree: dict = {}
    for name, t in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = t
    return tree


def _namespace(tree):
    if not isinstance(tree, dict):
        return tree
    return SimpleNamespace(**{k: _namespace(v) for k, v in tree.items()})


def _layer_view(params, cfg: ModelConfig):
    """An :class:`LM`, or the trainer's stacked leaves unbound into per-layer
    weights (one ``unbind`` a leaf) under the attribute names of ``LM``."""
    if isinstance(params, LM):
        return params

    def layers(prefix, n):
        stacked = {k[len(prefix):]: v.unbind(0) for k, v in params.items() if k.startswith(prefix)}
        return [_namespace(_nested({k: v[i] for k, v in stacked.items()})) for i in range(n)]

    view = SimpleNamespace(embed=params["embed"], ln_f=SimpleNamespace(scale=params["ln_f.scale"]),
                           unembed=params["unembed"], blocks=layers("blocks.", cfg.num_layers))
    if cfg.family == "encdec":
        view.enc_blocks = layers("enc_blocks.", cfg.encoder_layers)
        view.enc_ln_f = SimpleNamespace(scale=params["enc_ln_f.scale"])
    return view


def _final_hidden(params, batch, cfg: ModelConfig, *, kv_chunk=1024):
    """The training forward up to the final norm: (x (B, S, d), loss mask
    (B, S), aux, tokens, the layer view)."""
    if cfg.family not in B.PORTED:
        raise C.unported(f"training the {cfg.family} family", "A6")
    view = _layer_view(params, cfg)
    tokens, x, enc_out = _embed(view, batch, cfg, train=True)
    b, s = tokens.shape
    seq_pos = torch.arange(s, dtype=torch.int32, device=x.device)
    x, _, aux = _run_blocks(view, x, cfg, positions=seq_pos[None].expand(b, s), mode="train",
                            enc_out=enc_out, kv_chunk=kv_chunk, seq_positions=seq_pos)
    x = C.apply_norm(view.ln_f, x, cfg.norm)
    return x, torch.ones((b, s), dtype=torch.bool, device=x.device), aux, tokens, view


def _ce_chunk(x, w, labels, mask):
    logits = C.matmul_f32(x, w)  # (B, chunk, V) fp32
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[..., None])[..., 0]
    return ((lse - ll) * mask).sum()


def _chunked_ce(x, w, labels, mask, *, seq_chunk=512):
    """Next-token CE without (B, S, V) fp32 logits: fp32 log-softmax over
    ``seq_chunk`` slices of the sequence, each slice's logits recomputed in
    the backward (``torch.utils.checkpoint``), so one slice's live at once."""
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, x.shape[1], seq_chunk):
        part = (x[:, c:c + seq_chunk], w, labels[:, c:c + seq_chunk], mask[:, c:c + seq_chunk])
        if torch.is_grad_enabled():
            tot = tot + checkpoint(_ce_chunk, *part, use_reentrant=False, preserve_rng_state=False)
        else:
            tot = tot + _ce_chunk(*part)
    return tot / torch.clamp(mask.sum(dtype=torch.float32), min=1.0)


def train_loss(params, batch, cfg: ModelConfig, *, kv_chunk=1024, aux_weight=0.01):
    """(loss, {"ce", "aux"}) of ``batch`` = {"tokens": (B, S)} (the encdec
    family's also {"frames": (B, Se, d)}): the mean next-token CE plus
    ``aux_weight`` times the blocks' aux (the moe family's load-balance
    loss summed over the layers; 0 for the other families).
    ``params``: the trainer's stacked leaves (:func:`train_params`) or an
    :class:`LM`."""
    x, mask, aux, tokens, view = _final_hidden(params, batch, cfg, kv_chunk=kv_chunk)
    ce = _chunked_ce(x[:, :-1], view.unembed, tokens[:, 1:], mask[:, 1:].to(torch.float32))
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}
