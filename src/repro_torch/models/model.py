"""Model zoo dispatcher (``repro.models.model``): init / forward /
prefill / decode for every architecture family.

Families:
  dense | moe | vlm  -> decoder-only transformer (MoE swaps the FFN;
                        VLM prepends stub patch embeddings)
  ssm                -> RWKV6 (timemix + channelmix)
  hybrid             -> zamba2: Mamba2 groups + ONE shared
                        attention/MLP block applied after each group
  audio              -> encoder-decoder: non-causal encoder over stub
                        frame embeddings, causal decoder w/ cross-attn

Layout: the parameters are the reference's tree, leaf for leaf --
``embed``, ``head``, ``ln_f`` and the *stacked* layer leaves of shape
(L, ...) (``blocks.*``, ``enc_blocks.*``; hybrid's ``mamba_groups.*``
are (G, attn_every, ...) and its ``shared`` block is not stacked) --
so a JAX parameter tree crosses with
``interop.from_numpy_tree``, checkpoints share keys, and Mode A
aggregates the same leaves with the same launches.  ``Model`` is the
``nn.Module`` that holds them as parameters under the reference's
names (``blocks.attn.wq``, ...); the functions take either a ``Model``
or the plain tree.  Each layer works on its slice of the stacked leaves
(one ``unbind`` per leaf and forward -- two for the hybrid's groups --
so backward writes each leaf's gradient once); ``remat`` recomputes
each block in backward (``torch.utils.checkpoint``; a hybrid group as
a whole, shared attention included, around its checkpointed Mamba2
layers), and every stacked block routes its parameters through
``layer_hook`` -- identity here, the robust FSDP gather in the
collectives' slice.  As in the reference, the hybrid's ``shared`` block
does not go through the hook: the FSDP slice has to gather it apart.
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
from repro_torch.models import ssm as S

Hook = Callable[[Any], Any]


def _id_hook(p):
    return p


ARCH_TYPES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


def _check_arch(cfg: ModelConfig) -> None:
    if cfg.arch_type not in ARCH_TYPES:
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


def _init_rwkv_block(generator, cfg: ModelConfig, device) -> dict:
    return {
        "ln1": torch.ones((cfg.d_model,), device=device),
        "tm": S.init_rwkv6_timemix(generator, cfg.d_model, cfg.ssm_head_dim,
                                   device=device),
        "ln2": torch.ones((cfg.d_model,), device=device),
        "cm": S.init_rwkv6_channelmix(generator, cfg.d_model, cfg.d_ff,
                                      device=device),
    }


def _init_mamba_block(generator, cfg: ModelConfig, device) -> dict:
    return {
        "ln": torch.ones((cfg.d_model,), device=device),
        "mamba": S.init_mamba2(generator, cfg.d_model, expand=cfg.ssm_expand,
                               head_dim=cfg.ssm_head_dim,
                               d_state=cfg.ssm_state, d_conv=cfg.ssm_conv,
                               device=device),
    }


def _init_attn_mlp_block(generator, cfg: ModelConfig, device, *,
                         causal: bool = True) -> dict:
    """ln1, attention, ln2, MLP: the hybrid's shared block and an
    encoder layer (non-causal)."""
    return {
        "ln1": torch.ones((cfg.d_model,), device=device),
        "attn": L.init_attention(generator, attn_dims(cfg, causal=causal),
                                 device),
        "ln2": torch.ones((cfg.d_model,), device=device),
        "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp_gated,
                          device),
    }


def _init_enc_block(generator, cfg: ModelConfig, device) -> dict:
    return _init_attn_mlp_block(generator, cfg, device, causal=False)


def _init_encdec_dec_block(generator, cfg: ModelConfig, device) -> dict:
    return {
        "ln1": torch.ones((cfg.d_model,), device=device),
        "attn": L.init_attention(generator, attn_dims(cfg), device),
        "ln_x": torch.ones((cfg.d_model,), device=device),
        "xattn": L.init_attention(generator, attn_dims(cfg, causal=False),
                                  device),
        "ln2": torch.ones((cfg.d_model,), device=device),
        "mlp": L.init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp_gated,
                          device),
    }


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
    """A model of any family as an ``nn.Module``: its parameters are the
    reference's leaves under the reference's names (``embed``, ``head``,
    ``ln_f``, ``blocks.ln1``, ``blocks.attn.wq`` of shape (L, ...), ...).
    ``tree()`` gives them as the nested dict the functions take."""

    def __init__(self, cfg: ModelConfig, params: dict):
        _check_arch(cfg)
        super().__init__(params)
        self.cfg = cfg

    def forward(self, batch: dict, *, remat: bool = True):
        return forward(self, self.cfg, batch, remat=remat)


def init_model(cfg: ModelConfig, *, seed: int = 0, generator=None,
               device="cuda") -> Model:
    """A randomly initialised ``Model`` on ``device``: the reference's
    parameter tree, f32, drawn from ``generator`` (or a fresh one
    seeded with ``seed``)."""
    _check_arch(cfg)
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

    at = cfg.arch_type
    if at in ("dense", "moe", "vlm"):
        params["blocks"] = _stack_init(_init_dense_block, generator,
                                       cfg.num_layers, cfg, dev)
    elif at == "ssm":
        params["ln0"] = torch.ones((d,), device=dev)
        params["blocks"] = _stack_init(_init_rwkv_block, generator,
                                       cfg.num_layers, cfg, dev)
    elif at == "hybrid":
        g = cfg.attn_every
        if not g or cfg.num_layers % g:
            raise ValueError("hybrid needs num_layers % attn_every == 0")
        flat = _stack_init(_init_mamba_block, generator, cfg.num_layers,
                           cfg, dev)
        params["mamba_groups"] = pytree.tree_map(
            lambda x: x.reshape((cfg.num_layers // g, g) + x.shape[1:]), flat)
        params["shared"] = _init_attn_mlp_block(generator, cfg, dev)
    else:  # audio
        params["enc_blocks"] = _stack_init(_init_enc_block, generator,
                                           cfg.encoder_layers, cfg, dev)
        params["enc_ln_f"] = torch.ones((d,), device=dev)
        params["blocks"] = _stack_init(_init_encdec_dec_block, generator,
                                       cfg.num_layers, cfg, dev)
    return Model(cfg, params)


def param_tree(params) -> dict:
    """The nested dict of a ``Model`` or of a tree given as one."""
    return params.tree() if isinstance(params, Model) else params


def _layers(blocks: dict, n: int) -> list:
    """Per-layer views of the stacked leaves: layer i's tree.  On the
    hybrid's (G, attn_every, ...) groups it gives group i's tree, whose
    leaves are stacked (attn_every, ...) again."""
    leaves, treedef = pytree.flatten(blocks)
    per_leaf = [leaf.unbind(0) for leaf in leaves]
    return [pytree.unflatten(treedef, [u[i] for u in per_leaf])
            for i in range(n)]


def _at(tree: dict, i: int) -> dict:
    """Layer i's slice of a stacked cache (one level of dicts)."""
    return {name: t[i] for name, t in tree.items()}


def _stack_dicts(trees: list) -> dict:
    """The inverse of ``_at`` over every layer."""
    return {name: torch.stack([t[name] for t in trees]) for name in trees[0]}


def _call(fn, remat: bool, *args):
    """fn(*args), recomputed in backward where ``remat``."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


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


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, dtype=torch.int32, device=device).expand(b, s)


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


def _rwkv_body(cfg: ModelConfig, hook: Hook):
    """(x, blk, state or None) -> (x, the layer's new state)."""
    def body(x, blk, st):
        blk = hook(blk)
        dt = x.dtype
        h, (last_tm, new_state) = S.rwkv6_timemix(
            blk["tm"], L.rms_norm(x, blk["ln1"].to(dt), cfg.norm_eps),
            cfg.ssm_head_dim, cfg.chunk_size,
            None if st is None else st["last_tm"],
            None if st is None else st["state"])
        x = x + h
        h, last_cm = S.rwkv6_channelmix(
            blk["cm"], L.rms_norm(x, blk["ln2"].to(dt), cfg.norm_eps),
            None if st is None else st["last_cm"])
        return x + h, {"state": new_state, "last_tm": last_tm,
                       "last_cm": last_cm}
    return body


def _hybrid_group_body(cfg: ModelConfig, hook: Hook, shared: dict,
                       dims: L.AttnDims, remat: bool):
    """(x, positions, group, states, attn_cache) -> x for the forward
    (states and cache None), else (x, new states, new cache): the
    group's attn_every Mamba2 layers, then the shared attention and MLP.
    ``shared`` does not go through ``hook`` (the reference's rule)."""
    def mamba_body(x, blk, st):
        blk = hook(blk)
        h, (conv, ssm_state) = S.mamba2_fwd(
            blk["mamba"], L.rms_norm(x, blk["ln"].to(x.dtype), cfg.norm_eps),
            cfg, None if st is None else st["conv"],
            None if st is None else st["ssm"])
        return x + h, {"conv": conv, "ssm": ssm_state}

    def group_body(x, positions, grp, states=None, attn_cache=None):
        new_states = []
        for j, blk in enumerate(_layers(grp, cfg.attn_every)):
            st = None if states is None else _at(states, j)
            x, new_st = _call(mamba_body, remat, x, blk, st)
            new_states.append(new_st)
        dt = x.dtype
        xn = L.rms_norm(x, shared["ln1"].to(dt), cfg.norm_eps)
        if attn_cache is None:
            h, _ = L.attention_fwd(shared["attn"], xn, dims, positions)
        else:
            h, new_cache = L.attention_decode(shared["attn"], xn, dims,
                                              attn_cache)
        x = x + h
        x = x + L.mlp_fwd(shared["mlp"], L.rms_norm(x, shared["ln2"].to(dt),
                                                    cfg.norm_eps),
                          cfg.mlp_gated)
        if attn_cache is None:
            return x
        return x, _stack_dicts(new_states), new_cache
    return group_body


def _encdec_encode(params: dict, cfg: ModelConfig, frames: torch.Tensor,
                   hook: Hook, remat: bool) -> torch.Tensor:
    """frames: (B, F, D) stub embeddings -> encoder output (B, F, D)."""
    dims = attn_dims(cfg, causal=False)
    x = frames.to(act_dtype(cfg))
    b, f, _ = x.shape

    def body(x, positions, blk):
        blk = hook(blk)
        dt = x.dtype
        h, _ = L.attention_fwd(blk["attn"], L.rms_norm(x, blk["ln1"].to(dt),
                                                       cfg.norm_eps),
                               dims, positions)
        x = x + h
        return x + L.mlp_fwd(blk["mlp"], L.rms_norm(x, blk["ln2"].to(dt),
                                                    cfg.norm_eps),
                             cfg.mlp_gated)

    positions = _positions(b, f, x.device)
    for blk in _layers(params["enc_blocks"], cfg.encoder_layers):
        x = _call(body, remat, x, positions, blk)
    return L.rms_norm(x, params["enc_ln_f"].to(x.dtype), cfg.norm_eps)


def _encdec_dec_body(cfg: ModelConfig, hook: Hook, dims: L.AttnDims,
                     xdims: L.AttnDims):
    def body(x, positions, enc_out, blk):
        blk = hook(blk)
        dt = x.dtype
        h, _ = L.attention_fwd(blk["attn"], L.rms_norm(x, blk["ln1"].to(dt),
                                                       cfg.norm_eps),
                               dims, positions)
        x = x + h
        ek, ev = L.project_enc_kv(blk["xattn"], enc_out, xdims)
        x = x + L.cross_attention_fwd(
            blk["xattn"], L.rms_norm(x, blk["ln_x"].to(dt), cfg.norm_eps),
            ek, ev, xdims, positions)
        return x + L.mlp_fwd(blk["mlp"], L.rms_norm(x, blk["ln2"].to(dt),
                                                    cfg.norm_eps),
                             cfg.mlp_gated)
    return body


def forward(params, cfg: ModelConfig, batch: dict, *,
            layer_hook: Hook = _id_hook,
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits, aux_loss).

    batch: {"tokens": (B, S)} (+ "prefix" (B, P, D) for vlm,
           + "frames" (B, F, D) for audio).
    """
    _check_arch(cfg)
    params = param_tree(params)
    tokens = batch["tokens"]
    x = _embed(params, cfg, tokens)
    b = tokens.shape[0]
    at = cfg.arch_type
    vlm_prefix = at == "vlm" and "prefix" in batch

    if vlm_prefix:
        x = torch.cat([batch["prefix"].to(x.dtype), x], dim=1)
    positions = _positions(b, x.shape[1], x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    if at in ("dense", "moe", "vlm"):
        body = _dense_body(cfg, layer_hook, attn_dims(cfg))
        auxs = []
        for blk in _layers(params["blocks"], cfg.num_layers):
            x, a = _call(body, remat, x, positions, blk)
            auxs.append(a)
        aux = torch.sum(torch.stack(auxs))
    elif at == "ssm":
        x = L.rms_norm(x, params["ln0"].to(x.dtype), cfg.norm_eps)
        body = _rwkv_body(cfg, layer_hook)
        for blk in _layers(params["blocks"], cfg.num_layers):
            x, _ = _call(body, remat, x, blk, None)
    elif at == "hybrid":
        body = _hybrid_group_body(cfg, layer_hook, params["shared"],
                                  attn_dims(cfg), remat)
        for grp in _layers(params["mamba_groups"],
                           cfg.num_layers // cfg.attn_every):
            x = _call(body, remat, x, positions, grp)
    else:  # audio
        enc_out = _encdec_encode(params, cfg, batch["frames"], layer_hook,
                                 remat)
        body = _encdec_dec_body(cfg, layer_hook, attn_dims(cfg),
                                attn_dims(cfg, causal=False))
        for blk in _layers(params["blocks"], cfg.num_layers):
            x = _call(body, remat, x, positions, enc_out, blk)

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
# KV / state caches + prefill + decode
# ===========================================================================

def _stacked(tree: dict, lead: tuple) -> dict:
    """Each cache tensor repeated along new leading dimensions ``lead``."""
    return {name: t.expand(lead + t.shape).clone() for name, t in tree.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """Zero cache for one-token decode at positions [0, max_len), the
    reference's layout: per-layer KV caches (dense, moe, vlm; audio's
    self-attention, with a zero cross cache of the encoder's length)
    and recurrent states (ssm; hybrid's Mamba2 states (G, attn_every,
    ...) with one KV cache per group for the shared attention), stacked
    by layer.  Attention caches and token shifts are in the activation
    dtype, recurrent states in f32."""
    _check_arch(cfg)
    dev = devices.resolve(device)
    dt = act_dtype(cfg)
    at = cfg.arch_type
    n = cfg.num_layers
    if at == "ssm":
        h, hd = S.rwkv6_heads(cfg.d_model, cfg.ssm_head_dim), cfg.ssm_head_dim
        return {"blocks": {
            "state": torch.zeros((n, batch, h, hd, hd), dtype=torch.float32,
                                 device=dev),
            "last_tm": torch.zeros((n, batch, 1, cfg.d_model), dtype=dt,
                                   device=dev),
            "last_cm": torch.zeros((n, batch, 1, cfg.d_model), dtype=dt,
                                   device=dev),
        }}
    one = L.init_kv_cache(batch, attn_dims(cfg), max_len, dt, dev)
    if at == "hybrid":
        n_groups = n // cfg.attn_every
        conv, ssm_state = S.init_mamba2_state(batch, cfg, dt, dev)
        return {"mamba": _stacked({"conv": conv, "ssm": ssm_state},
                                  (n_groups, cfg.attn_every)),
                "attn": _stacked(one, (n_groups,))}
    cache = {"blocks": _stacked(one, (n,))}
    if at == "audio":
        shape = (n, batch, cfg.num_prefix_tokens, cfg.num_kv_heads,
                 cfg.head_dim)
        cache["cross"] = {"k": torch.zeros(shape, dtype=dt, device=dev),
                          "v": torch.zeros(shape, dtype=dt, device=dev)}
    return cache


def _decoder_block_decode(cfg: ModelConfig, blk: dict, x: torch.Tensor,
                          ch: dict, cross=None):
    """One decoder layer of the attention families at one token:
    (x, its new KV cache).  ``cross`` (the encoder's k, v) adds the
    encoder-decoder's cross-attention."""
    dt = x.dtype
    dims = attn_dims(cfg)
    h, ch_new = L.attention_decode(
        blk["attn"], L.rms_norm(x, blk["ln1"].to(dt), cfg.norm_eps), dims, ch)
    x = x + h
    if cross is not None:
        x = x + L.cross_attention_fwd(
            blk["xattn"], L.rms_norm(x, blk["ln_x"].to(dt), cfg.norm_eps),
            cross["k"], cross["v"], attn_dims(cfg, causal=False),
            ch["pos"][:, None])
    xn = L.rms_norm(x, blk["ln2"].to(dt), cfg.norm_eps)
    if cfg.num_experts:
        h, _ = MOE.moe_fwd(blk["moe"], xn, num_experts=cfg.num_experts,
                           top_k=cfg.experts_per_tok, gated=cfg.mlp_gated,
                           group_size=1,
                           capacity_factor=float(cfg.experts_per_tok))
    else:
        h = L.mlp_fwd(blk["mlp"], xn, cfg.mlp_gated)
    return x + h, ch_new


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, cache: dict, *,
                layer_hook: Hook = _id_hook):
    """One-token decode.  tokens: (B, 1) int.  Returns (logits, cache);
    the cache passed in is left as it was."""
    _check_arch(cfg)
    params = param_tree(params)
    x = _embed(params, cfg, tokens)
    at = cfg.arch_type
    news = []
    if at == "ssm":
        x = L.rms_norm(x, params["ln0"].to(x.dtype), cfg.norm_eps)
        body = _rwkv_body(cfg, layer_hook)
        for i, blk in enumerate(_layers(params["blocks"], cfg.num_layers)):
            x, st = body(x, blk, _at(cache["blocks"], i))
            news.append(st)
        cache = {"blocks": _stack_dicts(news)}
    elif at == "hybrid":
        n_groups = cfg.num_layers // cfg.attn_every
        positions = cache["attn"]["pos"][0][:, None]    # the same in all groups
        body = _hybrid_group_body(cfg, layer_hook, params["shared"],
                                  attn_dims(cfg), remat=False)
        attn = []
        for g, grp in enumerate(_layers(params["mamba_groups"], n_groups)):
            x, states, ch = body(x, positions, grp, _at(cache["mamba"], g),
                                 _at(cache["attn"], g))
            news.append(states)
            attn.append(ch)
        cache = {"mamba": _stack_dicts(news), "attn": _stack_dicts(attn)}
    else:
        for i, blk in enumerate(_layers(params["blocks"], cfg.num_layers)):
            cross = _at(cache["cross"], i) if at == "audio" else None
            x, ch = _decoder_block_decode(cfg, layer_hook(blk), x,
                                          _at(cache["blocks"], i), cross)
            news.append(ch)
        cache = dict(cache, blocks=_stack_dicts(news))
    return _lm_head(params, cfg, x), cache


def prefill(params, cfg: ModelConfig, batch: dict, *,
            layer_hook: Hook = _id_hook, remat: bool = True) -> torch.Tensor:
    """Prefill forward: returns last-position logits (B, 1, V).

    As in the reference, the cache for a later decode is built by the
    decode steps themselves (teacher-forcing the prompt), not here; the
    encoder-decoder's cross cache is filled by its caller."""
    logits, _ = forward(params, cfg, batch, layer_hook=layer_hook, remat=remat)
    return logits[:, -1:]
