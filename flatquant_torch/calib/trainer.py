"""Layer-wise FlatQuant calibration engine (port of
flatquant_tpu/calib/trainer.py).

Parity target: flatquant/train_utils.py:14-171 —
  - capture layer-0 inputs once (the embedding lookup; the reference's
    Catcher)
  - per layer: record the fp teacher outputs and the running activation
    absmax, sq-style diag init from them, then epochs x (nsamples /
    cali_bsz) AdamW steps on {transforms, diag, weight clips, act clips}
    with per-group learning rates (clips at 10x, train_utils.py:117-127),
    cosine annealing to flat_lr * 1e-3, an optional 16-step linear warmup
    and the loss MSE / detach(MSE) (train_utils.py:147)
  - the fp teacher outputs become the next layer's inputs (ping-pong
    buffers)

The FlatQuant state is a tree of tensors (quantize/state.py for Llama,
nested dicts for DeepSeek); a parallel tree of group labels (`build_labels`)
sorts its leaves into the four groups. The master state is float32; the
layer computes in the inputs' dtype (bf16, or float32 with deactive_amp).
Activations stay on the device that holds them (JAX pages them through
the host).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.models.llama import causal_mask, llama_layer, rope_tables
from flatquant_torch.quantize.linear import LinearQuantState
from flatquant_torch.quantize.spec import FQConfig
from flatquant_torch.quantize.state import (
    AttnFQ,
    CacheQuantState,
    LayerFQ,
    MlpFQ,
)
from flatquant_torch.utils.tree import tree_map

GROUPS = ("trans", "diag", "clip_w", "clip_a")


# ---------------------------------------------------------------------------
# trainable-parameter labeling (param groups)
# ---------------------------------------------------------------------------


def _label_factor(f):
    return tree_map(lambda _: "trans", f)


def _label_decompose(t):
    if t is None:
        return None
    return dataclasses.replace(
        t, left=_label_factor(t.left), right=_label_factor(t.right),
        diag_scale=None if t.diag_scale is None else "diag")


def _label_single(t):
    if t is None:
        return None
    return dataclasses.replace(t, factor=_label_factor(t.factor))


def _label_linear(lin: LinearQuantState) -> LinearQuantState:
    return LinearQuantState(
        clip_w_max=None if lin.clip_w_max is None else "clip_w",
        clip_w_min=None if lin.clip_w_min is None else "clip_w",
        clip_a_max=None if lin.clip_a_max is None else "clip_a",
        clip_a_min=None if lin.clip_a_min is None else "clip_a")


def _label_cache(c: CacheQuantState) -> CacheQuantState:
    return CacheQuantState(
        clip_a_max=None if c.clip_a_max is None else "clip_a",
        clip_a_min=None if c.clip_a_min is None else "clip_a")


def build_labels(fq: LayerFQ) -> LayerFQ:
    """Label tree matching one LayerFQ: trans | diag | clip_w | clip_a."""
    a, m = fq.attn, fq.mlp
    return LayerFQ(
        attn=AttnFQ(
            ln_trans=_label_decompose(a.ln_trans),
            o_trans=_label_single(a.o_trans),
            kcache_trans=_label_single(a.kcache_trans),
            vcache_trans=_label_single(a.vcache_trans),
            q_lin=_label_linear(a.q_lin), k_lin=_label_linear(a.k_lin),
            v_lin=_label_linear(a.v_lin), o_lin=_label_linear(a.o_lin),
            q_cache=_label_cache(a.q_cache), k_cache=_label_cache(a.k_cache),
            v_cache=_label_cache(a.v_cache)),
        mlp=MlpFQ(
            up_gate_trans=_label_decompose(m.up_gate_trans),
            down_trans=_label_decompose(m.down_trans),
            up_lin=_label_linear(m.up_lin),
            gate_lin=_label_linear(m.gate_lin),
            down_lin=_label_linear(m.down_lin)))


def labeled_leaves(tree, labels):
    """(tensor, label) for every leaf of `tree`, in tree order."""
    out = []
    tree_map(lambda t, lab: out.append((t, lab)), tree, labels)
    return out


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def group_enabled(fq_cfg: FQConfig) -> dict:
    return {"trans": fq_cfg.cali_trans, "diag": fq_cfg.add_diag,
            "clip_w": fq_cfg.lwc, "clip_a": fq_cfg.lac}


def group_base_lr(fq_cfg: FQConfig, group: str) -> float:
    return fq_cfg.flat_lr * (10.0 if group.startswith("clip") else 1.0)


def lr_at(fq_cfg: FQConfig, base_lr: float, total_steps: int,
          step: int) -> float:
    """The rate of update `step` (0 first): optax's
    cosine_decay_schedule(base_lr, total_steps, alpha=eta_min / base_lr)
    with eta_min = flat_lr * 1e-3, times (0.01 + 0.99 min(step, 16) / 16)
    with warmup. In float32, in the order XLA folds JAX's jitted schedule
    (pi / total and 0.5 * (1 - alpha) as constants): near the end of the
    decay 1 + cos cancels, and only float32 there follows JAX. The cosine
    is correctly rounded (XLA's is within an ulp of it)."""
    f32 = np.float32
    alpha = fq_cfg.flat_lr * 1e-3 / base_lr
    x = f32(min(step, total_steps)) * (f32(np.pi)
                                       * (f32(1) / f32(total_steps)))
    cos = f32(math.cos(float(x)))
    lr = ((cos + f32(1)) * (f32(0.5) * f32(1 - alpha)) + f32(alpha)) \
        * f32(base_lr)
    if fq_cfg.warmup:
        lr = lr * (f32(0.01) + f32(0.99) * f32(min(step, 16)) / f32(16))
    return float(lr)


class GroupAdamW:
    """torch.optim.AdamW (betas (0.9, 0.999), eps 1e-8, weight decay 0.01,
    torch's defaults) over the enabled groups of one layer's state, each
    at its scheduled rate; a disabled group's leaves are frozen
    (requires_grad False, outside the optimizer, no weight decay: optax's
    set_to_zero)."""

    def __init__(self, fq_cfg: FQConfig, state, labels, total_steps: int):
        on = group_enabled(fq_cfg)
        by_group = {g: [] for g in GROUPS}
        for t, lab in labeled_leaves(state, labels):
            t.requires_grad_(bool(on[lab]))
            if on[lab]:
                by_group[lab].append(t)
        self.fq_cfg, self.total_steps, self.step_count = (
            fq_cfg, total_steps, 0)
        groups = [dict(params=ts, group=g, base_lr=group_base_lr(fq_cfg, g),
                       lr=group_base_lr(fq_cfg, g))
                  for g, ts in by_group.items() if ts]
        self.opt = (torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=0.01) if groups else None)

    def lrs(self) -> dict:
        """The rates the next update takes, by group."""
        if self.opt is None:
            return {}
        return {g["group"]: lr_at(self.fq_cfg, g["base_lr"],
                                  self.total_steps, self.step_count)
                for g in self.opt.param_groups}

    def step(self) -> None:
        if self.opt is not None:
            rates = self.lrs()
            for g in self.opt.param_groups:
                g["lr"] = rates[g["group"]]
            self.opt.step()
            self.opt.zero_grad(set_to_none=True)
        self.step_count += 1


def make_optimizer(fq_cfg: FQConfig, state, labels,
                   total_steps: int) -> GroupAdamW:
    """AdamW with per-group cosine rates (clips at 10x), frozen groups
    left out."""
    return GroupAdamW(fq_cfg, state, labels, total_steps)


# ---------------------------------------------------------------------------
# diag init
# ---------------------------------------------------------------------------


def _get_init_scale(w_smax, x_smax, alpha):
    """(w^{1-a} / x^a).clamp(1e-5) — function_utils.py:7-8."""
    v = w_smax ** (1.0 - alpha) / torch.clamp_min(x_smax, 1e-5) ** alpha
    return torch.clamp_min(v, 1e-5)


def _absmax_cols(ws):
    return torch.cat([w.to(torch.float32) for w in ws], 0).abs().amax(0)


def sq_init_diag(lp: dict, fq_l: LayerFQ, stats: dict,
                 alpha: float) -> LayerFQ:
    """SmoothQuant-style diag init from weight / activation absmax
    (llama_utils.py init_diag_scale, :95-104, 308-315)."""
    a, m = fq_l.attn, fq_l.mlp

    def upd(t, ws, key):
        if t is None or t.diag_scale is None:
            return t
        return dataclasses.replace(t, diag_scale=_get_init_scale(
            _absmax_cols(ws), stats[key].to(torch.float32), alpha))

    a = dataclasses.replace(
        a, ln_trans=upd(a.ln_trans, [lp["wq"], lp["wk"], lp["wv"]], "ln"))
    m = dataclasses.replace(
        m, up_gate_trans=upd(m.up_gate_trans, [lp["wup"], lp["wgate"]], "up"),
        down_trans=upd(m.down_trans, [lp["wdown"]], "down"))
    return LayerFQ(attn=a, mlp=m)


# ---------------------------------------------------------------------------
# calibration driver
# ---------------------------------------------------------------------------


@torch.no_grad()
def capture_embeddings(cfg, params, tokens, compute_dtype, bsz: int = 8):
    """Layer-0 inputs of every calibration sample -> [N, S, H] in
    compute_dtype, on the device that holds params."""
    embed = params["embed"]
    tok = torch.as_tensor(np.asarray(tokens), device=embed.device).long()
    return torch.cat([embed[tok[i:i + bsz]].to(compute_dtype)
                      for i in range(0, tok.shape[0], bsz)], 0)


def _master(tree):
    """Float32 leaf copies (the trained state), detached from any graph."""
    return tree_map(lambda t: t.detach().to(torch.float32).clone(), tree)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def calibrate_layers(fq_cfg: FQConfig, layers_params, fq_state, inps,
                     fp_fn, calib_fn, labels, num_layers: int,
                     diag_init_fn=None,
                     log: Callable[[str], None] = print,
                     save_cb: Optional[Callable[[int, object], None]] = None,
                     epochs: Optional[int] = None, layer_params_fn=None,
                     history: Optional[list] = None):
    """Model-agnostic layer-wise calibration core.

    fp_fn(lp, x) -> (teacher_out, stats); calib_fn(fq_l, lp, x) -> out;
    labels: the group-label tree of one layer's state; diag_init_fn(lp,
    fq_l, stats) -> fq_l (run when diag_init is "sq_style").
    layers_params / fq_state: per-layer lists; layer_params_fn(i)
    overrides layers_params[i]. inps [N, S, H] is not written. Returns
    the new state list. history, when given, gets one dict per layer:
    teacher seconds, seconds and MSE of every step, MSE of every epoch.
    """
    nsamples = inps.shape[0]
    bsz = fq_cfg.cali_bsz
    n_epochs = fq_cfg.epochs if epochs is None else epochs
    steps_per_epoch = max(1, nsamples // bsz)
    total_steps = max(1, n_epochs * steps_per_epoch)
    fq_state = list(fq_state)
    dev = inps.device

    for i in range(num_layers):
        lp = layer_params_fn(i) if layer_params_fn is not None \
            else layers_params[i]
        fq_l = fq_state[i]

        # fp teacher outputs + running activation absmax
        t0 = time.time()
        outs = torch.empty_like(inps)
        run_stats = None
        with torch.no_grad():
            for j in range(0, nsamples, bsz):
                o, st = fp_fn(lp, inps[j:j + bsz])
                outs[j:j + bsz] = o
                run_stats = st if run_stats is None else {
                    k: torch.maximum(run_stats[k], st[k]) for k in st}
        _sync(dev)
        teacher_s = time.time() - t0

        if diag_init_fn is not None and fq_cfg.diag_init == "sq_style":
            with torch.no_grad():
                fq_l = diag_init_fn(lp, fq_l, run_stats)

        state = _master(fq_l)
        opt = make_optimizer(fq_cfg, state, labels, total_steps)
        rec = dict(layer=i, teacher_s=teacher_s, step_s=[], step_mse=[],
                   epoch_mse=[])
        for epoch in range(n_epochs):
            mse_sum = 0.0
            tick = time.time()
            for j in range(steps_per_epoch):
                ts = time.time()
                lo = j * bsz
                out = calib_fn(state, lp, inps[lo:lo + bsz])
                diff = out.to(torch.float32) - outs[lo:lo + bsz].to(
                    torch.float32)
                mse = torch.mean(diff * diff)
                (mse / mse.detach()).backward()
                opt.step()
                m = float(mse.detach())
                mse_sum += m
                rec["step_mse"].append(m)
                rec["step_s"].append(time.time() - ts)
            rec["epoch_mse"].append(mse_sum)
            log(f"layer {i} epoch {epoch} mse {mse_sum:.8f} "
                f"time {time.time() - tick:.2f}s")

        fq_state[i] = tree_map(lambda t: t.detach(), state)
        inps, outs = outs, inps  # fp outputs feed the next layer
        log(f"layer {i} done in {time.time() - t0:.1f}s")
        if history is not None:
            history.append(rec)
        if save_cb is not None:
            save_cb(i, fq_state)
    return fq_state


def calibrate(cfg: LlamaConfig, fq_cfg: FQConfig, params: dict, fq_state,
              train_tokens: np.ndarray, compute_dtype=None,
              log: Callable[[str], None] = print,
              save_cb: Optional[Callable[[int, object], None]] = None,
              epochs: Optional[int] = None,
              history: Optional[list] = None):
    """Llama-family layer-wise calibration (calibrate_layers over
    llama_layer), on the device that holds params. train_tokens [nsamples,
    seqlen] int; save_cb(i, fq_state) after each layer (the incremental
    resume artifact, train_utils.py:157-159). Returns the trained list of
    LayerFQ."""
    if compute_dtype is None:
        compute_dtype = torch.float32 if fq_cfg.deactive_amp \
            else torch.bfloat16
    dev = params["embed"].device
    seqlen = np.asarray(train_tokens).shape[1]
    cos, sin = rope_tables(cfg, torch.arange(seqlen, device=dev))
    mask = causal_mask(seqlen, dev)
    inps = capture_embeddings(cfg, params, train_tokens, compute_dtype)

    def fp_fn(lp, x):
        return llama_layer(cfg, None, "fp", lp, None, x, cos, sin, mask,
                           with_stats=True)

    def calib_fn(fq_l, lp, x):
        return llama_layer(cfg, fq_cfg, "calib", lp, fq_l, x, cos, sin, mask)

    return calibrate_layers(
        fq_cfg, params["layers"], fq_state, inps, fp_fn, calib_fn,
        build_labels(fq_state[0]), num_layers=cfg.num_layers,
        diag_init_fn=lambda lp, fq_l, stats: sq_init_diag(
            lp, fq_l, stats, fq_cfg.diag_alpha),
        log=log, save_cb=save_cb, epochs=epochs, history=history)
