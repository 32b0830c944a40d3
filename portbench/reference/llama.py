"""Plain float32 reference of a Llama-family model (Qwen2: qkv bias) under
FlatQuant W4A4KV4, from the seeded raw weights of portbench/weights.

Each layer: RMSNorm, the Kronecker transform of the attention input,
per-token 4-bit activations (LAC), the q, k, v linears on 4-bit weights
(the transform's inverse and LWC folded in, per-channel scales), RoPE, the
K-cache transform on k (and its inverse-transpose on q), asymmetric 4-bit
K and V per (token, head). A prompt attends its own unquantized K and V,
as a prefill does; every later token attends the quantized K and V of
all positions, as decode reads the cache. Then the o head mixing, 4-bit
activations and the o linear; the MLP likewise (SwiGLU, the down
transform before the down linear). The quantized weights, codes and
caches are worked out here, not taken from the program. Imports torch
and portbench only.
"""

from __future__ import annotations

import torch

from portbench.reference.common import (
    act_quant,
    causal_attention,
    identity,
    inv_t,
    kron,
    kv_quant,
    rms_norm,
    silu,
    weight_quant,
)
from portbench.weights import llama as weights


def _rope_tables(theta: float, hd: int, n: int, device):
    inv_freq = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                             device=device) / hd))
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] \
        * inv_freq[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang).float(), torch.sin(ang).float()


def _rope(x, cos, sin):
    """HF's half rotation of x [T, h, d]."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None, :] + rot * sin[:, None, :]


def _layer_weights(cfg, seed, i, device):
    raw = weights.make_layer(cfg, seed, i, device)
    c = raw["clip"]
    t_inv = {k: (inv_t(raw[k][0][0]), inv_t(raw[k][1][0]))
             for k in ("ln_t", "ug_t", "down_t")}
    hd = weights.dims(cfg)[4]
    eye = torch.eye(hd, device=device)
    W = {k: weight_quant(kron(raw[k], *t_inv[t]), c)
         for k, t in (("wq", "ln_t"), ("wk", "ln_t"), ("wv", "ln_t"),
                      ("wup", "ug_t"), ("wgate", "ug_t"),
                      ("wdown", "down_t"))}
    W["wo"] = weight_quant(kron(raw["wo"], inv_t(raw["o_t"][0]), eye), c)
    for k in ("bq", "bk", "bv", "ln1_w", "ln2_w"):
        if k in raw:
            W[k] = raw[k]
    W.update(ln_t=(raw["ln_t"][0][0], raw["ln_t"][1][0]),
             ug_t=(raw["ug_t"][0][0], raw["ug_t"][1][0]),
             down_t=(raw["down_t"][0][0], raw["down_t"][1][0]),
             o_t=raw["o_t"][0], k_t=raw["k_t"][0],
             q_t=inv_t(raw["k_t"][0]), clip=c)
    return W


def _lin(x, w, b=None):
    y = x @ w.T
    return y if b is None else y + b


def _layer(cfg, W, xs, lens, cos, sin, rnd):
    """One layer over every sequence at once: xs [sum T, H], lens the
    (T, prompt length) of each."""
    H, I, nh, nkv, hd, _, _ = weights.dims(cfg)
    eps, c = cfg["rms_norm_eps"], W["clip"]
    h = rnd(rms_norm(xs, W["ln1_w"], eps))
    h = act_quant(rnd(kron(h, *W["ln_t"])), c)
    q = rnd(_lin(h, W["wq"], W.get("bq"))).reshape(-1, nh, hd)
    k = rnd(_lin(h, W["wk"], W.get("bk"))).reshape(-1, nkv, hd)
    v = rnd(_lin(h, W["wv"], W.get("bv"))).reshape(-1, nkv, hd)
    outs, at = [], 0
    rep = nh // nkv
    for T, S in lens:
        sl = slice(at, at + T)
        qs = rnd(_rope(q[sl], cos[:T], sin[:T]))
        ks = rnd(_rope(k[sl], cos[:T], sin[:T]))
        qs, ks, vs = rnd(qs @ W["q_t"]), rnd(ks @ W["k_t"]), v[sl]
        kq, vq = kv_quant(ks, c), kv_quant(vs, c)
        kr = lambda t: t.repeat_interleave(rep, dim=1)  # noqa: E731
        scale = hd ** -0.5
        pre = causal_attention(qs[:S], kr(ks[:S]), kr(vs[:S]), scale)
        dec = causal_attention(qs[S:], kr(kq), kr(vq), scale,
                               torch.arange(S, T, device=xs.device))
        outs.append(rnd(torch.cat([pre, dec])))
        at += T
    att = torch.einsum("ji,tjd->tid", W["o_t"], torch.cat(outs))
    att = act_quant(rnd(att.reshape(-1, nh * hd)), c)
    xs = rnd(xs + rnd(_lin(att, W["wo"])))
    h2 = rnd(rms_norm(xs, W["ln2_w"], eps))
    h2 = act_quant(rnd(kron(h2, *W["ug_t"])), c)
    act = rnd(silu(rnd(_lin(h2, W["wgate"]))) * rnd(_lin(h2, W["wup"])))
    act = act_quant(rnd(kron(act, *W["down_t"])), c)
    return rnd(xs + rnd(_lin(act, W["wdown"])))


@torch.no_grad()
def logits(cfg: dict, seed: int, seqs, device, rnd=identity) -> list:
    """Float32 logits [n, V] of each sequence (token ids, prompt length
    S) at its positions S - 1 .. T - 1: the logits its served tokens were
    drawn from. The layers are made one at a time from the seed."""
    _, _, _, _, hd, L, _ = weights.dims(cfg)
    outer = weights.make_outer(cfg, seed, device)
    toks = [torch.as_tensor(t, device=device).long() for t, _ in seqs]
    lens = [(len(t), S) for t, S in seqs]
    xs = rnd(outer["embed"][torch.cat(toks)].float())
    cos, sin = _rope_tables(float(cfg["rope_theta"]), hd,
                            max(T for T, _ in lens), device)
    for i in range(L):
        W = _layer_weights(cfg, seed, i, device)
        xs = _layer(cfg, W, xs, lens, cos, sin, rnd)
        del W
    head = outer["head"].float()
    out, at = [], 0
    for T, S in lens:
        h = rnd(rms_norm(xs[at + S - 1:at + T], outer["final_norm"],
                         cfg["rms_norm_eps"]))
        out.append(rnd(h @ head.T))
        at += T
    return out
