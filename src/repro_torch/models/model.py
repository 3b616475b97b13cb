"""Model zoo dispatcher (``repro.models.model``): init / forward /
prefill / decode for the decoder-only transformer families.

Families ported:
  dense | moe | vlm  -> decoder-only transformer (MoE swaps the FFN;
                        VLM prepends stub patch embeddings)

``ssm`` (RWKV6), ``hybrid`` (Zamba2) and ``audio`` (encoder-decoder)
raise ``NotImplementedError``: they wait for ROADMAP queue 1, item 1.

Layout: the parameters are the reference's tree, leaf for leaf --
``embed``, ``head``, ``ln_f`` and the *stacked* ``blocks.*`` leaves of
shape (L, ...) -- so a JAX parameter tree crosses with
``interop.from_numpy_tree``, checkpoints share keys, and Mode A
aggregates the same leaves with the same launches.  ``Model`` is the
``nn.Module`` that holds them as parameters under the reference's
names (``blocks.attn.wq``, ...); the functions take either a ``Model``
or the plain tree.  Each layer works on its slice of the stacked leaves
(one ``unbind`` per leaf and forward, so backward writes each leaf's
gradient once); ``remat`` recomputes each block in backward
(``torch.utils.checkpoint``), and every block routes its parameters
through ``layer_hook`` -- identity here, the robust FSDP gather in the
collectives' slice.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import devices, pytree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE

Hook = Callable[[Any], Any]


def _id_hook(p):
    return p


PORTED_ARCH_TYPES = ("dense", "moe", "vlm")
_WAITING = ("ssm", "hybrid", "audio")


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.arch_type in _WAITING:
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r} ({cfg.name}) is not ported yet: "
            "the RWKV6/Mamba2 (ssm, hybrid) and encoder-decoder (audio) "
            "families are ROADMAP queue 1, item 1")
    if cfg.arch_type not in PORTED_ARCH_TYPES:
        raise ValueError(f"unknown arch_type {cfg.arch_type!r}")


def act_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.act_dtype)


def attn_dims(cfg: ModelConfig, *, causal: bool = True,
              window=None) -> L.AttnDims:
    return L.AttnDims(
        d_model=cfg.d_model, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        qk_norm=cfg.qk_norm, qkv_bias=cfg.qkv_bias,
        rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps,
        sliding_window=cfg.sliding_window if window is None else window,
        causal=causal, q_chunk=cfg.q_chunk,
    )


# ===========================================================================
# init and the module
# ===========================================================================

def _init_dense_block(generator, cfg: ModelConfig, device) -> dict:
    blk = {
        "ln1": torch.ones((cfg.d_model,), device=device),
        "attn": L.init_attention(generator, attn_dims(cfg), device),
        "ln2": torch.ones((cfg.d_model,), device=device),
    }
    if cfg.num_experts:
        blk["moe"] = MOE.init_moe(generator, cfg.d_model, cfg.d_ff,
                                  cfg.num_experts, cfg.mlp_gated, device)
    else:
        blk["mlp"] = L.init_mlp(generator, cfg.d_model, cfg.d_ff,
                                cfg.mlp_gated, device)
    return blk


def _stack_init(fn, generator, n: int, cfg: ModelConfig, device) -> dict:
    """n layers drawn one after another, stacked leaf by leaf."""
    layer_trees = [fn(generator, cfg, device) for _ in range(n)]
    flat = [pytree.flatten(t) for t in layer_trees]
    treedef = flat[0][1]
    return pytree.unflatten(treedef, [
        torch.stack([leaves[i] for leaves, _ in flat])
        for i in range(len(flat[0][0]))])


class _Node(nn.Module):
    """One dict level of the parameter tree."""

    def __init__(self, tree: dict):
        super().__init__()
        for name in sorted(tree):
            sub = tree[name]
            if isinstance(sub, dict):
                self.add_module(name, _Node(sub))
            else:
                t = sub.detach()
                self.register_parameter(name, nn.Parameter(
                    t, requires_grad=t.is_floating_point()))

    def tree(self) -> dict:
        out = {name: p for name, p in self.named_parameters(recurse=False)}
        out.update({name: m.tree() for name, m in self.named_children()})
        return out


class Model(_Node):
    """The decoder transformer as an ``nn.Module``: its parameters are the
    reference's leaves under the reference's names (``embed``, ``head``,
    ``ln_f``, ``blocks.ln1``, ``blocks.attn.wq`` of shape (L, ...), ...).
    ``tree()`` gives them as the nested dict the functions take."""

    def __init__(self, cfg: ModelConfig, params: dict):
        _check_ported(cfg)
        super().__init__(params)
        self.cfg = cfg

    def forward(self, batch: dict, *, remat: bool = True):
        return forward(self, self.cfg, batch, remat=remat)


def init_model(cfg: ModelConfig, *, seed: int = 0, generator=None,
               device="cuda") -> Model:
    """A randomly initialised ``Model`` on ``device``: the reference's
    parameter tree, f32, drawn from ``generator`` (or a fresh one
    seeded with ``seed``)."""
    _check_ported(cfg)
    dev = devices.resolve(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    d, v = cfg.d_model, cfg.padded_vocab
    params: dict = {
        "embed": L.dense_init(generator, (v, d), scale=0.02, device=dev),
        "ln_f": torch.ones((d,), device=dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = L.dense_init(generator, (d, v), device=dev)
    params["blocks"] = _stack_init(_init_dense_block, generator,
                                   cfg.num_layers, cfg, dev)
    return Model(cfg, params)


def param_tree(params) -> dict:
    """The nested dict of a ``Model`` or of a tree given as one."""
    return params.tree() if isinstance(params, Model) else params


def _layers(blocks: dict, n: int) -> list:
    """Per-layer views of the stacked block leaves: layer i's tree."""
    leaves, treedef = pytree.flatten(blocks)
    per_leaf = [leaf.unbind(0) for leaf in leaves]
    return [pytree.unflatten(treedef, [u[i] for u in per_leaf])
            for i in range(n)]


# ===========================================================================
# forward (train / prefill)
# ===========================================================================

def _embed(params: dict, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.embedding(tokens, params["embed"]).to(
        act_dtype(cfg))


def _lm_head(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    x = L.rms_norm(x, params["ln_f"].to(dt), cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    logits = x @ w.to(dt)
    if cfg.padded_vocab != cfg.vocab_size:   # mask pad classes
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        # the reference's jnp.where against finfo(f32).min, a float32
        # scalar, promotes bf16 logits to f32: so do the masked ones here
        logits = torch.where(pad, L.F32_MIN, logits.float())
    return logits


def _dense_body(cfg: ModelConfig, hook: Hook, dims: L.AttnDims):
    def body(x, positions, blk):
        blk = hook(blk)
        dt = x.dtype
        h, _ = L.attention_fwd(blk["attn"], L.rms_norm(x, blk["ln1"].to(dt),
                                                       cfg.norm_eps),
                               dims, positions)
        x = x + h
        if cfg.num_experts:
            h, aux = MOE.moe_fwd(blk["moe"], L.rms_norm(x, blk["ln2"].to(dt),
                                                        cfg.norm_eps),
                                 num_experts=cfg.num_experts,
                                 top_k=cfg.experts_per_tok, gated=cfg.mlp_gated)
        else:
            h = L.mlp_fwd(blk["mlp"], L.rms_norm(x, blk["ln2"].to(dt),
                                                 cfg.norm_eps), cfg.mlp_gated)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x + h, aux
    return body


def forward(params, cfg: ModelConfig, batch: dict, *,
            layer_hook: Hook = _id_hook,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits, aux_loss).

    batch: {"tokens": (B, S)} (+ "prefix" (B, P, D) for vlm).
    """
    _check_ported(cfg)
    params = param_tree(params)
    tokens = batch["tokens"]
    x = _embed(params, cfg, tokens)
    b = tokens.shape[0]
    vlm_prefix = cfg.arch_type == "vlm" and "prefix" in batch

    if vlm_prefix:
        x = torch.cat([batch["prefix"].to(x.dtype), x], dim=1)
    s = x.shape[1]
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device).expand(b, s)

    body = _dense_body(cfg, layer_hook, attn_dims(cfg))
    auxs = []
    for blk in _layers(params["blocks"], cfg.num_layers):
        if remat:
            x, aux = checkpoint(body, x, positions, blk, use_reentrant=False)
        else:
            x, aux = body(x, positions, blk)
        auxs.append(aux)
    aux = torch.sum(torch.stack(auxs))

    if vlm_prefix:
        x = x[:, batch["prefix"].shape[1]:]
    return _lm_head(params, cfg, x), aux


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, *, aux=0.0,
            aux_weight: float = 0.0) -> torch.Tensor:
    """Mean token cross-entropy in f32; labels < 0 are masked."""
    mask = (labels >= 0).float()
    lab = torch.clamp(labels, min=0).long()
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, lab[..., None])[..., 0]
    nll = (lse - gold) * mask
    loss = torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)
    return loss + aux_weight * aux


def loss_fn(params, cfg: ModelConfig, batch: dict, *,
            layer_hook: Hook = _id_hook, remat: bool = True) -> torch.Tensor:
    tokens = batch["tokens"]
    inp = dict(batch)
    inp["tokens"] = tokens[:, :-1]
    logits, aux = forward(params, cfg, inp, layer_hook=layer_hook, remat=remat)
    return lm_loss(logits, tokens[:, 1:], aux=aux, aux_weight=cfg.moe_aux_loss)


# ===========================================================================
# KV caches + prefill + decode
# ===========================================================================

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """Zero cache for one-token decode at positions [0, max_len): the
    per-layer KV caches stacked (L, ...), in the activation dtype."""
    _check_ported(cfg)
    dev = devices.resolve(device)
    one = L.init_kv_cache(batch, attn_dims(cfg), max_len, act_dtype(cfg), dev)
    return {"blocks": {name: t.expand((cfg.num_layers,) + t.shape).clone()
                       for name, t in one.items()}}


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, cache: dict, *,
                layer_hook: Hook = _id_hook):
    """One-token decode.  tokens: (B, 1) int.  Returns (logits, cache);
    the cache passed in is left as it was."""
    _check_ported(cfg)
    params = param_tree(params)
    x = _embed(params, cfg, tokens)
    dims = attn_dims(cfg)
    cached = cache["blocks"]
    new = {name: [] for name in cached}
    for i, blk in enumerate(_layers(params["blocks"], cfg.num_layers)):
        blk = layer_hook(blk)
        ch = {name: t[i] for name, t in cached.items()}
        dt = x.dtype
        h, ch_new = L.attention_decode(
            blk["attn"], L.rms_norm(x, blk["ln1"].to(dt), cfg.norm_eps),
            dims, ch)
        x = x + h
        if cfg.num_experts:
            h, _ = MOE.moe_fwd(blk["moe"],
                               L.rms_norm(x, blk["ln2"].to(dt), cfg.norm_eps),
                               num_experts=cfg.num_experts,
                               top_k=cfg.experts_per_tok, gated=cfg.mlp_gated,
                               group_size=1,
                               capacity_factor=float(cfg.experts_per_tok))
        else:
            h = L.mlp_fwd(blk["mlp"],
                          L.rms_norm(x, blk["ln2"].to(dt), cfg.norm_eps),
                          cfg.mlp_gated)
        x = x + h
        for name, t in ch_new.items():
            new[name].append(t)
    cache = {"blocks": {name: torch.stack(ts) for name, ts in new.items()}}
    return _lm_head(params, cfg, x), cache


def prefill(params, cfg: ModelConfig, batch: dict, *,
            layer_hook: Hook = _id_hook, remat: bool = True) -> torch.Tensor:
    """Prefill forward: returns last-position logits (B, 1, V).

    As in the reference, the cache for a later decode is built by the
    decode steps themselves (teacher-forcing the prompt), not here."""
    logits, _ = forward(params, cfg, batch, layer_hook=layer_hook, remat=remat)
    return logits[:, -1:]
