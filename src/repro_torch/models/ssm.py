"""Attention-free sequence mixers (``repro.models.ssm``): Mamba2 (SSD)
and RWKV6 (Finch).

Both run in *chunked* form: a Python loop over chunks carries the
recurrent state, and within a chunk the contribution is dense einsums
over cumulative log-decay differences.  Decode is the forward at one
token (Mamba2 through ``chunk_size=1``, RWKV6 at s = 1), as in the
reference: there is no separate recurrence.

Every cast is the reference's: ``dt`` through softplus, the log-decays
and their cumulative sums in f32; each chunk's einsums on f32 copies,
cast back to the activation dtype per chunk; RWKV's per-head norm's
``rsqrt`` cast to the activation dtype before it multiplies.

One deliberate divergence: the reference forms every pairwise decay
``exp(cum_t - cum_s)`` of a chunk and masks the pairs s > t afterwards.
Their exponents are positive; once one overflows to ``inf`` the forward
stays finite (the mask picks 0) but backward computes ``0 * inf = NaN``.
Here the mask is applied to the exponent, ``exp(where(mask, d, -inf))``:
the same values wherever the reference is finite (masked pairs are 0 in
both), and finite gradients where the reference's are NaN.

The reference's simplifications carry over: RWKV6 keeps the
data-dependent per-channel decay but static (RWKV5-style) token-shift
interpolation; Mamba2 uses a single B/C group.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, rms_norm


def _chunk_len(chunk_size: int, s: int) -> int:
    """The reference's rule: the largest length <= chunk_size that
    divides s."""
    lc = min(chunk_size, s)
    while s % lc:
        lc -= 1
    return lc


def _masked_exp(diff: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """exp(diff) where ``mask``, else 0, with the mask applied to the
    exponent so that no masked entry overflows (see the module's note)."""
    return torch.exp(torch.where(mask, diff, -math.inf))


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================

def mamba2_dims(d_model: int, expand: int, head_dim: int, d_state: int):
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    return d_inner, n_heads


def init_mamba2(generator: torch.Generator, d_model: int, *, expand: int,
                head_dim: int, d_state: int, d_conv: int,
                device="cpu") -> dict:
    d_inner, n_heads = mamba2_dims(d_model, expand, head_dim, d_state)
    proj_out = 2 * d_inner + 2 * d_state + n_heads  # z, x, B, C, dt
    conv_ch = d_inner + 2 * d_state
    return {
        "in_proj": dense_init(generator, (d_model, proj_out), device=device),
        "conv_w": 0.1 * torch.randn((d_conv, conv_ch), generator=generator,
                                    device=device),
        "conv_b": torch.zeros((conv_ch,), device=device),
        "a_log": torch.log(torch.linspace(1.0, float(n_heads), n_heads,
                                          device=device)),
        "dt_bias": torch.zeros((n_heads,), device=device),
        "d_skip": torch.ones((n_heads,), device=device),
        "out_norm": torch.ones((d_inner,), device=device),
        "out_proj": dense_init(generator, (d_inner, d_model), device=device),
    }


def _mamba2_split(p: dict, x: torch.Tensor, cfg):
    d_inner, n_heads = mamba2_dims(cfg.d_model, cfg.ssm_expand,
                                   cfg.ssm_head_dim, cfg.ssm_state)
    n = cfg.ssm_state
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:d_inner + d_inner + 2 * n]
    dt = zxbcdt[..., -n_heads:]
    return z, xbc, dt, d_inner, n_heads, n


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state=None):
    """Depthwise causal conv along time.  xbc: (B, S, C), w: (W, C).
    Returns (out, the last W - 1 inputs: the next call's state)."""
    width = w.shape[0]
    s = xbc.shape[1]
    if conv_state is None:
        pad = torch.zeros(xbc.shape[:1] + (width - 1,) + xbc.shape[2:],
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    out = xp[:, 0:s] * w[0][None, None]
    for i in range(1, width):
        out = out + xp[:, i:i + s] * w[i][None, None]
    new_state = xp[:, -(width - 1):] if width > 1 else pad[:, :0]
    return out + b[None, None], new_state


def mamba2_fwd(p: dict, x: torch.Tensor, cfg, conv_state=None,
               ssm_state=None):
    """Full-sequence SSD.  x: (B, S, D) -> (y, (conv_state, ssm_state))."""
    b, s, _ = x.shape
    dt_ = x.dtype
    z, xbc, dt, d_inner, n_heads, n = _mamba2_split(p, x, cfg)
    hd = cfg.ssm_head_dim

    xbc, conv_out = _causal_conv(xbc, p["conv_w"].to(dt_),
                                 p["conv_b"].to(dt_), conv_state)
    xbc = F.silu(xbc)
    xs = xbc[..., :d_inner].reshape(b, s, n_heads, hd)
    bs = xbc[..., d_inner:d_inner + n]                     # (B, S, N)
    cs = xbc[..., d_inner + n:]                            # (B, S, N)

    dt = F.softplus(dt.float() + p["dt_bias"][None, None])
    a = -torch.exp(p["a_log"].float())                     # (H,)
    log_decay = dt * a[None, None]                         # (B, S, H) <= 0
    xbar = xs * dt.to(dt_)[..., None]                      # (B, S, H, hd)

    lc = _chunk_len(cfg.chunk_size, s)
    if ssm_state is None:
        ssm_state = torch.zeros((b, n_heads, hd, n), dtype=torch.float32,
                                device=x.device)
    mask = torch.tril(torch.ones((lc, lc), dtype=torch.bool,
                                 device=x.device))[None, :, :, None]
    state, ys = ssm_state, []
    for lo in range(0, s, lc):
        xb = xbar[:, lo:lo + lc].float()
        bb = bs[:, lo:lo + lc].float()
        cc = cs[:, lo:lo + lc].float()
        cum = torch.cumsum(log_decay[:, lo:lo + lc], dim=1)   # (B, L, H)
        total = cum[:, -1]                                    # (B, H)
        # inter-chunk: y_t += exp(cum_t) * C_t . S_in
        y_in = torch.einsum("bln,bhpn->blhp", cc, state) \
            * torch.exp(cum)[..., None]
        # intra-chunk: G(t,s) = C_t.B_s * exp(cum_t - cum_s), s <= t
        cb = torch.einsum("bln,bmn->blm", cc, bb)             # (B, L, L)
        dec = _masked_exp(cum[:, :, None] - cum[:, None, :], mask)
        g = cb[..., None] * dec                               # (B, L, L, H)
        y_intra = torch.einsum("blmh,bmhp->blhp", g, xb)
        # S_out = exp(total) S_in + sum_s exp(total - cum_s) B_s xb_s
        w_s = torch.exp(total[:, None] - cum)                 # (B, L, H)
        ds = torch.einsum("blhp,bln->bhpn", xb * w_s[..., None], bb)
        state = torch.exp(total)[:, :, None, None] * state + ds
        ys.append((y_in + y_intra).to(dt_))
    y = torch.cat(ys, dim=1)
    y = y + xs * p["d_skip"].to(dt_)[None, None, :, None]
    y = y.reshape(b, s, d_inner)
    y = rms_norm(y, p["out_norm"].to(dt_), 1e-5) * F.silu(z)
    return y @ p["out_proj"].to(dt_), (conv_out, state)


def mamba2_decode(p: dict, x: torch.Tensor, cfg, conv_state, ssm_state):
    """One-token step.  x: (B, 1, D): the forward at chunk length 1."""
    return mamba2_fwd(p, x, dataclasses.replace(cfg, chunk_size=1),
                      conv_state, ssm_state)


def init_mamba2_state(batch: int, cfg, dtype, device="cpu"):
    d_inner, n_heads = mamba2_dims(cfg.d_model, cfg.ssm_expand,
                                   cfg.ssm_head_dim, cfg.ssm_state)
    conv = torch.zeros((batch, cfg.ssm_conv - 1, d_inner + 2 * cfg.ssm_state),
                       dtype=dtype, device=device)
    ssm = torch.zeros((batch, n_heads, cfg.ssm_head_dim, cfg.ssm_state),
                      dtype=torch.float32, device=device)
    return conv, ssm


# ===========================================================================
# RWKV6 (Finch)
# ===========================================================================

def rwkv6_heads(d_model: int, head_dim: int) -> int:
    return d_model // head_dim


def init_rwkv6_timemix(generator: torch.Generator, d_model: int,
                       head_dim: int, decay_lora: int = 64,
                       device="cpu") -> dict:
    h = rwkv6_heads(d_model, head_dim)
    p = {f"mu_{c}": 0.5 * torch.ones((d_model,), device=device)
         for c in "rkvgw"}
    for name in ("wr", "wk", "wv", "wg", "wo"):
        p[name] = dense_init(generator, (d_model, d_model), device=device)
    return dict(
        p,
        # data-dependent decay (Finch): w = exp(-exp(w0 + tanh(x A) B))
        w0=-6.0 * torch.ones((d_model,), device=device) + 0.5,
        w_a=dense_init(generator, (d_model, decay_lora), scale=1e-2,
                       device=device),
        w_b=dense_init(generator, (decay_lora, d_model), scale=1e-2,
                       device=device),
        bonus=torch.zeros((h, head_dim), device=device),
        ln_w=torch.ones((d_model,), device=device),
    )


def _token_shift(x: torch.Tensor, mu: torch.Tensor,
                 last: torch.Tensor) -> torch.Tensor:
    """lerp(x_t, x_{t-1}, mu); ``last`` (B, 1, D) is the token before x[0]."""
    prev = torch.cat([last, x[:, :-1]], dim=1)
    return x + (prev - x) * mu[None, None].to(x.dtype)


def rwkv6_timemix(p: dict, x: torch.Tensor, head_dim: int, chunk_size: int,
                  last_x=None, state=None):
    """x: (B, S, D) -> (out, (last_x, state)).  state: (B, H, hd, hd) f32
    with layout state[i, j] accumulating k_i * v_j."""
    b, s, d = x.shape
    h = rwkv6_heads(d, head_dim)
    hd = head_dim
    dt_ = x.dtype
    if last_x is None:
        last_x = torch.zeros((b, 1, d), dtype=dt_, device=x.device)

    xr = _token_shift(x, p["mu_r"], last_x)
    xk = _token_shift(x, p["mu_k"], last_x)
    xv = _token_shift(x, p["mu_v"], last_x)
    xg = _token_shift(x, p["mu_g"], last_x)
    xw = _token_shift(x, p["mu_w"], last_x)

    r = (xr @ p["wr"].to(dt_)).reshape(b, s, h, hd)
    k = (xk @ p["wk"].to(dt_)).reshape(b, s, h, hd)
    v = (xv @ p["wv"].to(dt_)).reshape(b, s, h, hd)
    g = F.silu(xg @ p["wg"].to(dt_))

    # Finch decay, per channel and per step: log w in (-inf, 0)
    dec = p["w0"][None, None] + torch.tanh(
        xw.float() @ p["w_a"].float()) @ p["w_b"].float()
    log_w = (-torch.exp(dec)).reshape(b, s, h, hd)         # (B, S, H, hd) f32

    lc = _chunk_len(chunk_size, s)
    if state is None:
        state = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                            device=x.device)
    u = p["bonus"].float()                                 # (H, hd)
    # strictly past pairs (s < t)
    mask = torch.tril(torch.ones((lc, lc), dtype=torch.bool, device=x.device),
                      diagonal=-1)[None, :, :, None, None]
    st, ys = state, []
    for lo in range(0, s, lc):
        rr = r[:, lo:lo + lc].float()
        kk = k[:, lo:lo + lc].float()
        vv = v[:, lo:lo + lc].float()
        lw = log_w[:, lo:lo + lc]
        cum = torch.cumsum(lw, dim=1)                      # inclusive
        cum_ex = cum - lw                                  # exclusive
        # carry-in: out_t += sum_i r_t,i exp(cum_ex_t,i) S[i, :]
        y_in = torch.einsum("blhi,bhij->blhj", rr * torch.exp(cum_ex), st)
        # intra (strictly past): factor(t,s,i) = exp(cum_ex_t,i - cum_s,i)
        fac = _masked_exp(cum_ex[:, :, None] - cum[:, None, :], mask)
        a_ts = torch.sum(rr[:, :, None] * kk[:, None] * fac, dim=-1)
        y_intra = torch.einsum("blmh,bmhj->blhj", a_ts, vv)
        # bonus (current token)
        y_bonus = torch.sum(rr * kk * u[None, None], dim=-1,
                            keepdim=True) * vv
        # state update
        total = cum[:, -1]                                 # (B, H, hd)
        w_s = torch.exp(total[:, None] - cum)              # (B, L, H, hd)
        ds = torch.einsum("blhi,blhj->bhij", kk * w_s, vv)
        st = torch.exp(total)[..., None] * st + ds
        ys.append((y_in + y_intra + y_bonus).to(dt_))
    y = torch.cat(ys, dim=1)
    # per-head group norm (approximated by rms over head dim), then gate
    y = y * torch.rsqrt(torch.mean(torch.square(y.float()), dim=-1,
                                   keepdim=True) + 1e-5).to(dt_)
    y = y.reshape(b, s, d) * p["ln_w"].to(dt_) * g
    out = y @ p["wo"].to(dt_)
    return out, (x[:, -1:], st)


def init_rwkv6_channelmix(generator: torch.Generator, d_model: int,
                          d_ff: int, device="cpu") -> dict:
    return {
        "mu_k": 0.5 * torch.ones((d_model,), device=device),
        "mu_r": 0.5 * torch.ones((d_model,), device=device),
        "wk": dense_init(generator, (d_model, d_ff), device=device),
        "wv": dense_init(generator, (d_ff, d_model), device=device),
        "wr": dense_init(generator, (d_model, d_model), device=device),
    }


def rwkv6_channelmix(p: dict, x: torch.Tensor, last_x=None):
    b, _, d = x.shape
    dt_ = x.dtype
    if last_x is None:
        last_x = torch.zeros((b, 1, d), dtype=dt_, device=x.device)
    xk = _token_shift(x, p["mu_k"], last_x)
    xr = _token_shift(x, p["mu_r"], last_x)
    k = torch.square(torch.relu(xk @ p["wk"].to(dt_)))
    out = torch.sigmoid(xr @ p["wr"].to(dt_)) * (k @ p["wv"].to(dt_))
    return out, x[:, -1:]
