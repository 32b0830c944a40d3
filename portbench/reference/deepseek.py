"""Plain float32 reference of DeepSeek-V2 (MLA without a q LoRA, shared
and routed experts) under FlatQuant W4A4, from the seeded raw weights of
portbench/weights and the published configuration's keys.

Each linear takes the diagonal scale and the Kronecker transform on its
input, per-token 4-bit activations (LAC) and 4-bit weights with the
transform's inverse and LWC folded in (per-channel scales); wkv_b stays
unquantized. Attention is MLA in its plain form (keys and values
projected from the normalized latents by wkv_b), with YaRN RoPE on
interleaved pairs and the softmax scale times mscale(factor,
mscale_all_dim)^2, as the published model defines them (HF's
DeepseekV2YarnRotaryEmbedding). The gate is a softmax over the routed
experts, top-K greedy, unnormalized, times routed_scaling_factor; every
token reaches all K of its experts (no capacity, no drop). The quantized
weights are worked out here, not taken from the program. Imports torch
and portbench only.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.common import (
    act_quant,
    causal_attention,
    identity,
    inv_t,
    kron,
    rms_norm,
    silu,
    weight_quant,
)
from portbench.weights import deepseek as weights


def _mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def _yarn_tables(cfg: dict, n: int, device):
    rs, dim = cfg["rope_scaling"], cfg["qk_rope_head_dim"]
    base, factor = float(cfg["rope_theta"]), float(rs["factor"])
    orig = rs["original_max_position_embeddings"]
    expo = torch.arange(0, dim, 2, dtype=torch.float64, device=device) / dim
    extra = 1.0 / base ** expo
    inter = 1.0 / (factor * base ** expo)

    def corr(rot):
        return (dim * math.log(orig / (rot * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float64, device=device) - low)
            / (high - low)).clamp(0, 1)
    inv_freq = inter * ramp + extra * (1 - ramp)
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] \
        * inv_freq[None, :]
    m = (_mscale(factor, rs["mscale"])
         / _mscale(factor, rs["mscale_all_dim"]))
    return (torch.cos(ang) * m).float(), (torch.sin(ang) * m).float()


def softmax_scale(cfg: dict) -> float:
    rs = cfg["rope_scaling"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    return qk ** -0.5 * _mscale(float(rs["factor"]), rs["mscale_all_dim"]) ** 2


def _rope(x, cos, sin):
    """Rotate the interleaved (real, imag) pairs of x [T, h, d]."""
    xr = x.reshape(x.shape[:-1] + (-1, 2))
    c, s = cos[:, None, :], sin[:, None, :]
    out = torch.stack([xr[..., 0] * c - xr[..., 1] * s,
                       xr[..., 0] * s + xr[..., 1] * c], dim=-1)
    return out.reshape(x.shape)


class _Transform:
    """x -> (x * diag) @ kron(L, R), and a weight's fold of its inverse."""

    def __init__(self, t):
        (self.left, _), (self.right, _), self.diag = t
        self.left_inv, self.right_inv = inv_t(self.left), inv_t(self.right)

    def __call__(self, x):
        return kron(x * self.diag, self.left, self.right)

    def fold(self, w):
        return kron(w / self.diag, self.left_inv, self.right_inv)


def _layer_weights(cfg, seed, i, device):
    raw = weights.make_layer(cfg, seed, i, device)
    c = raw["clip"]
    tr = {k: _Transform(v) for k, v in raw["trans"].items()}
    q = {"wq": "qkv_trans", "wkv_a": "qkv_trans", "wo": "wo_trans",
         "w1": "up_gate_trans", "w3": "up_gate_trans", "w2": "down_trans",
         "s_w1": "w1_trans", "s_w3": "w1_trans", "s_w2": "w2_trans",
         "e_w1": "w1_trans", "e_w3": "w1_trans", "e_w2": "routed_w2_trans"}
    W = {k: weight_quant(tr[t].fold(raw[k]), c)
         for k, t in q.items() if k in raw}
    for k in ("wkv_b", "gate_w", "attn_norm", "ffn_norm", "kv_norm"):
        if k in raw:
            W[k] = raw[k]
    W.update(tr=tr, clip=c)
    return W


def _mla(cfg, W, h, lens, cos, sin, rnd):
    d = weights.dims(cfg)
    nh, nope, rope, v = d["nh"], d["nope"], d["rope"], d["v"]
    c, eps = W["clip"], cfg["rms_norm_eps"]
    hq = act_quant(rnd(W["tr"]["qkv_trans"](h)), c)
    q = rnd(hq @ W["wq"].T).reshape(-1, nh, nope + rope)
    kv = rnd(hq @ W["wkv_a"].T)
    latent = rnd(rms_norm(kv[:, :d["lora"]], W["kv_norm"], eps))
    kvb = (latent @ W["wkv_b"].T).reshape(-1, nh, nope + v)
    outs, at = [], 0
    for T, _ in lens:
        sl = slice(at, at + T)
        q_pe = rnd(_rope(q[sl, :, nope:], cos[:T], sin[:T]))
        k_pe = rnd(_rope(kv[sl, None, d["lora"]:], cos[:T], sin[:T]))
        qs = torch.cat([q[sl, :, :nope], q_pe], dim=-1)
        ks = torch.cat([kvb[sl, :, :nope], k_pe.expand(T, nh, rope)], dim=-1)
        outs.append(causal_attention(qs, ks, kvb[sl, :, nope:],
                                     softmax_scale(cfg)))
        at += T
    o = rnd(torch.cat(outs).reshape(-1, nh * v))
    o = act_quant(rnd(W["tr"]["wo_trans"](o)), c)
    return rnd(o @ W["wo"].T)


def _mlp(W, t, names, c, rnd):
    """SwiGLU of the transformed, quantized input t through (gate, up,
    down) weights, with the down input's transform."""
    g, u, dn, tdn = names
    act = rnd(silu(rnd(t @ W[g].T)) * rnd(t @ W[u].T))
    return rnd(act_quant(rnd(W["tr"][tdn](act)), c) @ W[dn].T)


def _moe(cfg, W, h, rnd):
    d, c = weights.dims(cfg), W["clip"]
    probs = torch.softmax(h @ W["gate_w"].T, dim=-1)
    weight, idx = torch.topk(probs, d["K"], dim=-1)
    weight = weight * float(cfg["routed_scaling_factor"])
    t = act_quant(rnd(W["tr"]["w1_trans"](h)), c)
    y = torch.zeros_like(h)
    for e in range(d["E"]):
        rows, k = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        te = t[rows]
        act = rnd(silu(rnd(te @ W["e_w1"][e].T)) * rnd(te @ W["e_w3"][e].T))
        act = act_quant(rnd(W["tr"]["routed_w2_trans"](act)), c)
        y.index_add_(0, rows, weight[rows, k, None]
                     * rnd(act @ W["e_w2"][e].T))
    z = _mlp(W, t, ("s_w1", "s_w3", "s_w2", "w2_trans"), c, rnd)
    return rnd(y) + z


def _layer(cfg, W, moe, xs, lens, cos, sin, rnd):
    eps = cfg["rms_norm_eps"]
    h = rnd(rms_norm(xs, W["attn_norm"], eps))
    xs = rnd(xs + _mla(cfg, W, h, lens, cos, sin, rnd))
    h2 = rnd(rms_norm(xs, W["ffn_norm"], eps))
    if moe:
        return rnd(xs + _moe(cfg, W, h2, rnd))
    t = act_quant(rnd(W["tr"]["up_gate_trans"](h2)), W["clip"])
    return rnd(xs + _mlp(W, t, ("w1", "w3", "w2", "down_trans"), W["clip"],
                         rnd))


@torch.no_grad()
def logits(cfg: dict, seed: int, seqs, device, rnd=identity) -> list:
    """Float32 logits [n, V] of each sequence (token ids, prompt length
    S) at its positions S - 1 .. T - 1: the logits its served tokens were
    drawn from. The layers are made one at a time from the seed."""
    d = weights.dims(cfg)
    outer = weights.make_outer(cfg, seed, device)
    toks = [torch.as_tensor(t, device=device).long() for t, _ in seqs]
    lens = [(len(t), S) for t, S in seqs]
    xs = rnd(outer["embed"][torch.cat(toks)].float())
    cos, sin = _yarn_tables(cfg, max(T for T, _ in lens), device)
    for i in range(d["L"]):
        W = _layer_weights(cfg, seed, i, device)
        xs = _layer(cfg, W, weights.is_moe(cfg, i), xs, lens, cos, sin, rnd)
        del W
    head = outer["head"].float()
    out, at = [], 0
    for T, S in lens:
        h = rnd(rms_norm(xs[at + S - 1:at + T], outer["final_norm"],
                         cfg["rms_norm_eps"]))
        out.append(rnd(h @ head.T))
        at += T
    return out
