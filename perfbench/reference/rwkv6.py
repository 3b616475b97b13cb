"""The RWKV6 (Finch) language model's forward and next-token loss, in
plain PyTorch, written from the architecture as the benchmark's
configuration states it:

  x = RMSNorm_0(embed[tokens])
  per layer, time mixing on h = RMSNorm_1(x):
      shift(h, mu)_t = h_t + (h_{t-1} - h_t) mu   (h_{-1} = 0)
      r, k, v = shift(h, mu_r) Wr, shift(h, mu_k) Wk, shift(h, mu_v) Wv
      g = silu(shift(h, mu_g) Wg)
      w_t = exp(-exp(w0 + tanh(shift(h, mu_w) A) B))   per channel
      per head (``head_size`` channels), with S the (i, j) state:
          y_t = sum_{s<t} (r_t . (prod_{s<u<t} w_u) k_s) v_s
                + (r_t . (u k_t)) v_t
      y = y / rms(y) over each head (eps 1e-5), x += (y * ln_w * g) Wo
  channel mixing on h = RMSNorm_2(x):
      x += sigmoid(shift(h, mu_r) Wr) * (relu(shift(h, mu_k) Wk)^2 Wv)
  logits = RMSNorm_f(x) Whead; loss as for the decoder.

The recurrence is computed in its parallel form: with c_t the inclusive
cumulative sum of log w over time, the decay between s and t is
exp(c_{t-1} - c_s), so every pair of a head is one masked matmul of
r exp(c_{t-1}) against k exp(-c_s).  That is exact while exp(-c) stays
finite, which the forward checks.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from reference import lowp
from reference.qwen3 import rms_norm

MAX_LOG_DECAY = 80.0   # exp(80) is finite in f32


def _shift(h: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    prev = F.pad(h, (0, 0, 1, 0))[:, :-1]
    return h + (prev - h) * mu


def _wkv(r, k, v, log_w, u, hd: int, q) -> torch.Tensor:
    """r, k, v, log_w (B, S, D); u (H, hd) -> (B, S, D)."""
    b, s, d = r.shape
    nh = d // hd
    r, k, v, log_w = (t.reshape(b, s, nh, hd).transpose(1, 2)
                      for t in (r, k, v, log_w))          # (B, H, S, hd)
    cum = torch.cumsum(log_w, dim=2)
    if float(-cum.detach().min()) > MAX_LOG_DECAY:
        raise ValueError("decay too strong for the parallel form")
    cum_ex = cum - log_w
    rq = q(r * torch.exp(cum_ex))
    kq = q(k * torch.exp(-cum))
    att = rq @ kq.transpose(-1, -2)                        # (B, H, S, S)
    past = torch.ones((s, s), dtype=torch.bool, device=r.device).tril(-1)
    att = att * past
    y = q(att) @ q(v)
    y = y + torch.sum(r * u[None, :, None] * k, dim=-1, keepdim=True) * v
    return y.transpose(1, 2).reshape(b, s, d)


def _time_mix(p: dict, i: int, h: torch.Tensor, hd: int, q) -> torch.Tensor:
    pre = "blocks.tm."
    r = q(_shift(h, p[pre + "mu_r"][i])) @ q(p[pre + "wr"][i])
    k = q(_shift(h, p[pre + "mu_k"][i])) @ q(p[pre + "wk"][i])
    v = q(_shift(h, p[pre + "mu_v"][i])) @ q(p[pre + "wv"][i])
    g = F.silu(q(_shift(h, p[pre + "mu_g"][i])) @ q(p[pre + "wg"][i]))
    xw = _shift(h, p[pre + "mu_w"][i])
    log_w = -torch.exp(p[pre + "w0"][i] + torch.tanh(
        q(xw) @ q(p[pre + "w_a"][i])) @ p[pre + "w_b"][i])
    y = _wkv(r, k, v, log_w, p[pre + "bonus"][i], hd, q)
    b, s, d = y.shape
    yh = y.reshape(b, s, d // hd, hd)
    yh = yh * torch.rsqrt(torch.mean(yh * yh, dim=-1, keepdim=True) + 1e-5)
    y = yh.reshape(b, s, d) * p[pre + "ln_w"][i] * g
    return q(y) @ q(p[pre + "wo"][i])


def _channel_mix(p: dict, i: int, h: torch.Tensor, q) -> torch.Tensor:
    pre = "blocks.cm."
    kk = torch.square(torch.relu(
        q(_shift(h, p[pre + "mu_k"][i])) @ q(p[pre + "wk"][i])))
    rr = torch.sigmoid(q(_shift(h, p[pre + "mu_r"][i])) @ q(p[pre + "wr"][i]))
    return rr * (q(kk) @ q(p[pre + "wv"][i]))


def logits(p: dict, tokens: torch.Tensor, cfg: dict, q=lowp.identity):
    eps, hd = cfg["rms_norm_eps"], cfg["head_size"]
    x = rms_norm(p["embed"][tokens], p["ln0"], eps)
    for i in range(cfg["num_hidden_layers"]):
        x = x + _time_mix(p, i, rms_norm(x, p["blocks.ln1"][i], eps), hd, q)
        x = x + _channel_mix(p, i, rms_norm(x, p["blocks.ln2"][i], eps), q)
    out = q(rms_norm(x, p["ln_f"], eps)) @ q(p["head"])
    pad = torch.arange(out.shape[-1], device=out.device) >= cfg["vocab_size"]
    return out.masked_fill(pad, float("-inf"))


def loss(p: dict, tokens: torch.Tensor, cfg: dict, q=lowp.identity):
    lg = logits(p, tokens[:, :-1], cfg, q)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]).float(),
                           tokens[:, 1:].reshape(-1))
