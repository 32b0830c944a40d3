"""Prefill attention (port of flatquant_tpu/kernels/prefill_attention.py).

Causal GQA self-attention over a whole prompt, in three forms, routed by
`prefill_attention` with JAX's thresholds:

  dense_causal_attention  the O(S^2)-memory path of short prompts
                          (S < 1024 or S % 128 != 0): plain tensor math,
                          as in JAX
  flash_prefill_ref       JAX's blockwise oracle (float32 softmax over
                          q blocks of 256), the long-prompt path of
                          use_kernel=False
  flash kernels           the long-prompt path of use_kernel=True, one
                          CUDA kernel (csrc/flash_prefill.cu) behind two
                          entry points with JAX's public layouts:
      flash_prefill_attention     q [B,S,nh,hd], k/v [B,S,nkv,hd]
      flash_prefill_attention_kt  q [B,S,nh,hd], kt [B,nkv,hd,S],
                                  v [B,S,nkv,hd]

Query head h reads kv head h // (nh // nkv); K/V are never repeated.

The plain versions of the flash entry points (`*_ref`) mirror the Pallas
body's rounding, not flash_prefill_ref's: q is scaled by sm_scale *
log2(e) in float32 and cast back to its dtype; scores are float32 and the
softmax runs in the exp2 domain with an online max and sum over JAX's
blocks (Q_BLK 256, K_BLK 512, shrunk to divisors of S; full blocks
unmasked, diagonal blocks masked with -inf, upper blocks skipped); p is
cast to the input dtype before the PV product; the float32 accumulator is
divided by max(l, 1e-30) and cast to q's dtype. The kernel keeps those
rounding points but walks the keys in tiles of FLASH_KEY_TILE (128), so
its running max, and with it the rounding of p, differs from the plain
version's (kernels/tolerance.py, mode "flash").

`flash_prefill_attention_kt_i8` (csrc/flash_prefill_i8.cu) is the JAX
package's int8 variant of the kt entry point, a measured baseline there:
K and V get one symmetric int8 scale per (batch, kv head) over the whole
prompt, q one per row after the sm_scale * log2(e) fold, and QK^T runs in
int8 with int32 sums; with pv_i8 (the default) p is rounded to int8 codes,
round(p * 127), and PV runs in int8 too, else in bf16. Its plain version,
`flash_prefill_attention_kt_i8_ref`, follows the Pallas body
(prefill_attention.py:265-371) op for op. p is rounded against the running
max of its key block, so the function depends on blk_k (JAX's 512, shrunk
to a divisor of S); the kernel keeps JAX's key blocks and takes each
block's row maxima before it forms p, so kernel and plain version compute
the same p, codes and int32 sums wherever their exp2 agree, and differ
only in the order of the float32 sums of l (and, without pv_i8, of p.V):
kernels/tolerance.py, mode "flash" (compare_flash_i8 against the JAX
package's on the CPU, whose exp2 differs). (Rows are independent of JAX's
blk_q: a key block above a row's diagonal leaves it unchanged.) The float32
products of the plain version are exact: int8 codes multiply to at most
127^2, and the sums over head_dim 128 and over a key block of up to 1024
stay below 2^24.

Each flash wrapper launches its kernel for CUDA tensors (bf16, head_dim
128, S % 128 == 0) or raises, and runs its plain version for CPU tensors.
"""

from __future__ import annotations

import math

import torch

from flatquant_torch.core.quant import true_div
from flatquant_torch.kernels import common

_LIB = "flash_prefill"
_NAME = "flash_prefill_attention"
_NAME_KT = "flash_prefill_attention_kt"
_LIB_I8 = "flash_prefill_i8"
_NAME_I8 = "flash_prefill_attention_kt_i8"
_LOG2E = 1.4426950408889634
FLASH_THRESHOLD = 1024
Q_BLK = 256  # JAX's q block, shrunk to a divisor of S
K_BLK = 512  # JAX's k block, shrunk to a divisor of S
HD = 128
FLASH_KEY_TILE = 128  # the kernel's key tile (csrc/flash_prefill.cu FW_BK)


def is_flash(S: int, flash_threshold: int = FLASH_THRESHOLD) -> bool:
    """JAX's long-prompt test: a prompt of S tokens takes flash attention
    (kernel or blockwise oracle) instead of dense."""
    return S >= flash_threshold and S % 128 == 0


def _shrink_to_divisor(b: int, S: int) -> int:
    """Largest power-of-two reduction of b that divides S (S is a multiple
    of 128 here, so 128 always terminates the loop)."""
    while S % b:
        b //= 2
    return b


def _heads_first(t, n_rep):
    """[B, S, n, hd] -> [B, n * n_rep, S, hd]: kv head j serves query
    heads j * n_rep ... (j + 1) * n_rep - 1 (a view plus one copy)."""
    B, S, n, hd = t.shape
    t = t.permute(0, 2, 1, 3)
    if n_rep > 1:
        t = t[:, :, None].expand(B, n, n_rep, S, hd).reshape(B, n * n_rep,
                                                              S, hd)
    return t


def _flash_body_ref(q, k, v, sm_scale: float):
    """The Pallas flash body in plain PyTorch. q [B, S, nh, hd]; k, v
    [B, S, nkv, hd] (any strides) -> [B, S, nh, hd] in q.dtype."""
    B, S, nh, hd = q.shape
    n_rep = nh // k.shape[2]
    dt = q.dtype
    bq = _shrink_to_divisor(min(Q_BLK, S), S)
    bk = _shrink_to_divisor(min(K_BLK, S), S)
    scale = torch.full((), sm_scale * _LOG2E, dtype=torch.float32,
                       device=q.device)
    qs = (q.to(torch.float32) * scale).to(dt).to(torch.float32)
    qs = qs.permute(0, 2, 1, 3)  # [B, nh, S, hd]
    kf = _heads_first(k.to(dt), n_rep).to(torch.float32)
    vf = _heads_first(v.to(dt), n_rep).to(torch.float32)
    out = torch.empty((B, nh, S, hd), dtype=dt, device=q.device)
    col = torch.arange(bk, device=q.device)
    for i in range(S // bq):
        q_start = i * bq
        qi = qs[:, :, q_start:q_start + bq]
        row = q_start + torch.arange(bq, device=q.device)[:, None]
        n_full = q_start // bk
        n_kblk = (q_start + bq + bk - 1) // bk
        m = torch.full((B, nh, bq, 1), -math.inf, device=q.device)
        l = torch.zeros((B, nh, bq, 1), device=q.device)
        acc = torch.zeros((B, nh, bq, hd), device=q.device)
        for j in range(n_kblk):
            k_start = j * bk
            s = qi @ kf[:, :, k_start:k_start + bk].transpose(-1, -2)
            if j >= n_full:
                s = torch.where(row >= k_start + col, s, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp2(s - m_new)
            corr = torch.exp2(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            pv = p.to(dt).to(torch.float32) @ vf[:, :, k_start:k_start + bk]
            acc = acc * corr + pv
            m = m_new
        out[:, :, q_start:q_start + bq] = (
            acc / torch.clamp_min(l, 1e-30)).to(dt)
    return out.permute(0, 2, 1, 3)


def flash_prefill_attention_ref(q, k, v, sm_scale: float):
    """Plain version of flash_prefill_attention (the Pallas body's rounding
    and blocking)."""
    return _flash_body_ref(q, k, v, sm_scale)


def flash_prefill_attention_kt_ref(q, kt, v, sm_scale: float):
    """Plain version of flash_prefill_attention_kt: K arrives as
    [B, nkv, hd, S]."""
    return _flash_body_ref(q, kt.permute(0, 3, 1, 2), v, sm_scale)


def _flash_args(name, q, k_bhs, v):
    """The flash kernels' argument checks. k_bhs: K as [B, nkv, S, hd]
    (any batch/head/token strides). Returns q, k_bhs, v with head-dim
    stride 1 (copied where it is not) and their nine strides."""
    _same_cuda(name, q, k_bhs, v)
    return _flash_layout(name, q, k_bhs, v)


def _same_cuda(name, q, k, v):
    common.require(all(t.is_cuda and t.device == q.device for t in (k, v)),
                   name, "q, k and v must be on the same CUDA device")


def _flash_layout(name, q, k_bhs, v):
    """_flash_args' checks of dtype, shape and strides (any device)."""
    B, S, nh, hd = q.shape
    nkv = v.shape[2]
    req = common.require
    req(q.dtype == k_bhs.dtype == v.dtype == torch.bfloat16, name,
        f"dtypes {q.dtype}, {k_bhs.dtype}, {v.dtype}: the kernel takes "
        "bfloat16")
    req(hd == HD and S % 128 == 0 and S > 0, name,
        f"head_dim {hd} must be 128 and S {S} a multiple of 128")
    req(nkv > 0 and nh % nkv == 0 and tuple(v.shape) == (B, S, nkv, hd)
        and tuple(k_bhs.shape) == (B, nkv, S, hd), name,
        f"shapes q {tuple(q.shape)}, k {tuple(k_bhs.shape)} (as "
        f"[B, nkv, S, hd]), v {tuple(v.shape)}")
    if q.stride(3) != 1:
        q = q.contiguous()
    if v.stride(3) != 1:
        v = v.contiguous()
    if k_bhs.stride(3) != 1:  # e.g. JAX's [B, nkv, hd, S]: token-major copy
        k_bhs = k_bhs.contiguous()
    strides = [q.stride(0), q.stride(1), q.stride(2),
               k_bhs.stride(0), k_bhs.stride(1), k_bhs.stride(2),
               v.stride(0), v.stride(1), v.stride(2)]
    req(all(s % 8 == 0 for s in strides)
        and all(t.data_ptr() % 16 == 0 for t in (q, k_bhs, v)), name,
        "16-byte aligned rows needed (strides a multiple of 8 elements)")
    return q, k_bhs, v, strides


def _launch(name, q, k_bhs, v, sm_scale):
    """Launch csrc/flash_prefill.cu. k_bhs: K as [B, nkv, S, hd]."""
    _same_cuda(name, q, k_bhs, v)
    return launch_flash(name, q, k_bhs, v, sm_scale)


def launch_flash(name, q, k_bhs, v, sm_scale):
    """Launch csrc/flash_prefill.cu on tensors of one device (layout
    checked and copied as _flash_args does): K and V reach the kernel as
    [B, nkv, S, 128] through their strides, from which it encodes their
    tensor maps; raise if the launch fails. Counted under
    LAUNCHES[name]."""
    B, S, nh, hd = q.shape
    q, k_bhs, v, strides = _flash_layout(name, q, k_bhs, v)
    out = torch.empty((B, S, nh, hd), dtype=q.dtype, device=q.device)
    rc = common.lib(_LIB).fq_flash_prefill(
        q.data_ptr(), k_bhs.data_ptr(), v.data_ptr(), out.data_ptr(),
        *strides, B, S, nh, v.shape[2], sm_scale * _LOG2E,
        common.stream_ptr(q))
    common.check(_LIB, name, rc)
    common.LAUNCHES[name] += 1
    return out


def flash_prefill_attention(q, k, v, sm_scale: float):
    """Causal GQA attention over a whole prompt. q [B, S, nh, hd]; k, v
    [B, S, nkv, hd] -> [B, S, nh, hd] in q.dtype. CUDA tensors launch the
    kernel (bf16, hd 128, S % 128 == 0) or raise; CPU tensors run the
    plain version."""
    if q.device.type == "cpu":
        return flash_prefill_attention_ref(q, k, v, sm_scale)
    return _launch(_NAME, q, k.permute(0, 2, 1, 3), v, sm_scale)


def flash_prefill_attention_kt(q, kt, v, sm_scale: float):
    """flash_prefill_attention with K as [B, nkv, hd, S] (the layout the
    JAX prologue emits). The port's prologue passes its token-major k_rot
    as a strided view of that shape, which the kernel reads in place; a kt
    whose head-dim stride is not 1 is copied token-major first."""
    if q.device.type == "cpu":
        return flash_prefill_attention_kt_ref(q, kt, v, sm_scale)
    return _launch(_NAME_KT, q, kt.permute(0, 1, 3, 2), v, sm_scale)


# ---------------------------------------------------------------------------
# int8 score products (flash_prefill_attention_kt_i8)
# ---------------------------------------------------------------------------


def _div(num: float, t):
    """num / t by IEEE division (torch turns a Python number divided by a
    tensor into a reciprocal times the number)."""
    return torch.full((), num, dtype=torch.float32, device=t.device) / t


def quantize_kv_i8_ref(kt, v):
    """The per-(batch, kv head) int8 quant of K and V: kt [B, nkv, hd, S],
    v [B, S, nkv, hd] -> (k8 int8 [B, nkv, S, hd], v8t int8 [B, nkv, hd,
    S], sc float32 [B, nkv, 2] = (ks / 127, vs / 127^2)), ks = max(max|K|,
    1e-30) over the head's whole prompt, codes clip(round(K * (127 / ks)),
    -127, 127) (prefill_attention.py:304-316)."""
    ktf = kt.to(torch.float32)
    vtf = v.to(torch.float32).permute(0, 2, 3, 1)  # [B, nkv, hd, S]
    ks = ktf.abs().amax(dim=(2, 3)).clamp_min(1e-30)
    vs = vtf.abs().amax(dim=(2, 3)).clamp_min(1e-30)

    def codes(t, amax):
        r = _div(127.0, amax)[..., None, None]
        return torch.clamp(torch.round(t * r), -127, 127).to(torch.int8)

    k8 = codes(ktf, ks).transpose(2, 3).contiguous()
    v8t = codes(vtf, vs).contiguous()
    return k8, v8t, torch.stack([true_div(ks, 127.0),
                                 true_div(vs, 127.0 * 127.0)], -1)


def quantize_q_i8_ref(q, sm_scale: float):
    """q [B, S, nh, hd] -> (float32 codes [B, S, nh, hd] in [-127, 127],
    q_amax [B, S, nh, 1]): qf = q * (sm_scale * log2 e) in float32, q_amax =
    max(max|qf|, 1e-30) per row, codes clip(round(qf * (127 / q_amax)),
    -127, 127) (prefill_attention.py:329-334)."""
    qf = q.to(torch.float32) * torch.full((), sm_scale * _LOG2E,
                                          dtype=torch.float32,
                                          device=q.device)
    qa = qf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.clamp(torch.round(qf * _div(127.0, qa)), -127, 127), qa


def flash_prefill_attention_kt_i8_ref(q, kt, v, sm_scale: float,
                                      pv_i8: bool = True, blk_k: int = K_BLK):
    """Plain version of flash_prefill_attention_kt_i8: the Pallas body's
    blocking and rounding over key blocks of blk_k (shrunk to a divisor of
    S), all query rows at once. q [B, S, nh, hd] bf16; kt [B, nkv, hd, S];
    v [B, S, nkv, hd] -> [B, S, nh, hd] in q.dtype."""
    B, S, nh, hd = q.shape
    n_rep = nh // kt.shape[1]
    bk = _shrink_to_divisor(min(blk_k, S), S)
    k8, v8t, sc = quantize_kv_i8_ref(kt, v)
    q8, qa = quantize_q_i8_ref(q, sm_scale)
    q8, qa = q8.permute(0, 2, 1, 3), qa.permute(0, 2, 1, 3)  # heads first

    def per_query_head(t):
        return t.repeat_interleave(n_rep, dim=1) if n_rep > 1 else t

    s_scale = qa * per_query_head(true_div(sc[..., 0], 127.0))[..., None,
                                                              None]
    kf = per_query_head(k8.to(torch.float32))  # [B, nh, S, hd]
    if pv_i8:
        vf = per_query_head(v8t.to(torch.float32))  # [B, nh, hd, S]
        pv_scale = per_query_head(sc[..., 1])[..., None, None]
    else:
        vf = _heads_first(v, n_rep).to(torch.float32)  # [B, nh, S, hd]
    row = torch.arange(S, device=q.device)[:, None]
    col = torch.arange(bk, device=q.device)
    m = torch.full((B, nh, S, 1), -math.inf, device=q.device)
    l = torch.zeros((B, nh, S, 1), device=q.device)
    acc = torch.zeros((B, nh, S, hd), device=q.device)
    for j in range(S // bk):
        k0 = j * bk
        s = (q8 @ kf[:, :, k0:k0 + bk].transpose(-1, -2)) * s_scale
        s = torch.where(row >= k0 + col, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp2(s - m_new)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        if pv_i8:
            pv = torch.round(p * 127.0) @ vf[..., k0:k0 + bk].transpose(-1,
                                                                       -2)
            acc = acc * corr + pv * pv_scale
        else:
            pv = p.to(v.dtype).to(torch.float32) @ vf[:, :, k0:k0 + bk]
            acc = acc * corr + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.to(q.dtype).permute(0, 2, 1, 3)


def v8t_key_order(v8t):
    """quantize_kv_i8_ref's v8t [..., S] in the order the kernel stores it:
    within each 32-key group, position kA holds key 16 (kA // 16) + 8
    ((kA % 4) // 2) + 2 ((kA // 4) % 4) + kA % 2, the key the PV product's
    s8 register A fragment holds at k = kA (csrc/flash_prefill_i8.cu)."""
    S = v8t.shape[-1]
    ka = torch.arange(S, device=v8t.device)
    r = ka % 32
    key = (ka - r) + 16 * (r // 16) + 8 * ((r % 4) // 2) + 2 * ((r // 4) % 4) \
        + r % 2
    return v8t[..., key]


def _i8_scratch(B, S, nkv, dev):
    """The prepass's outputs and scratch: k8, v8t, sc, the chunk extrema."""
    return (torch.empty((B, nkv, S, HD), dtype=torch.int8, device=dev),
            torch.empty((B, nkv, HD, S), dtype=torch.int8, device=dev),
            torch.empty((B, nkv, 2), dtype=torch.float32, device=dev),
            torch.empty((B, nkv, S // 128, 2), dtype=torch.float32,
                        device=dev))


def kv_quant_i8_prepass(kt, v, pv_i8=True):
    """The int8 flash kernel's prepass alone (chip_smoke.py phase 3i times
    it on its own): CUDA kt [B, nkv, hd, S], v [B, S, nkv, hd] bf16 ->
    (k8, v8t, sc), quantize_kv_i8_ref's with v8t in v8t_key_order (written
    only with pv_i8). Not counted: the entry point is
    flash_prefill_attention_kt_i8."""
    B, nkv, hd, S = kt.shape
    k_bhs = kt.permute(0, 1, 3, 2)
    common.require(kt.is_cuda and v.device == kt.device
                   and kt.dtype == v.dtype == torch.bfloat16 and hd == HD
                   and S % 128 == 0 and tuple(v.shape) == (B, S, nkv, hd)
                   and k_bhs.stride(3) == v.stride(3) == 1, _NAME_I8,
                   f"prepass inputs kt {tuple(kt.shape)}, v {tuple(v.shape)}")
    strides = [k_bhs.stride(0), k_bhs.stride(1), k_bhs.stride(2),
               v.stride(0), v.stride(1), v.stride(2)]
    k8, v8t, sc, part = _i8_scratch(B, S, nkv, v.device)
    rc = common.lib(_LIB_I8).fq_kv_quant_i8(
        k_bhs.data_ptr(), v.data_ptr(), k8.data_ptr(), v8t.data_ptr(),
        sc.data_ptr(), part.data_ptr(), *strides, B, S, nkv, int(pv_i8),
        common.stream_ptr(v))
    common.check(_LIB_I8, _NAME_I8, rc)
    return k8, v8t, sc


def _launch_i8(q, kt, v, sm_scale, pv_i8, blk_k):
    """Launch csrc/flash_prefill_i8.cu (the prepass, then the flash
    kernel). Returns the output and the prepass's scratch: k8 [B, nkv, S,
    hd], v8t [B, nkv, hd, S] (written with pv_i8, in v8t_key_order) and sc
    [B, nkv, 2], which equal quantize_kv_i8_ref's."""
    B, S, nh, hd = q.shape
    nkv = kt.shape[1]
    q, k_bhs, v, strides = _flash_args(_NAME_I8, q, kt.permute(0, 1, 3, 2),
                                       v)
    bk = _shrink_to_divisor(min(blk_k, S), S)
    common.require(1 <= nh // nkv <= 8 and bk % 128 == 0 and bk <= 512,
                   _NAME_I8, f"n_rep {nh}/{nkv} must be from 1 to 8 and the "
                   f"key block {bk} a multiple of 128 up to 512")
    dev = q.device
    k8, v8t, sc, part = _i8_scratch(B, S, nkv, dev)
    out = torch.empty((B, S, nh, hd), dtype=q.dtype, device=dev)
    rc = common.lib(_LIB_I8).fq_flash_prefill_i8(
        q.data_ptr(), k_bhs.data_ptr(), v.data_ptr(), k8.data_ptr(),
        v8t.data_ptr(), sc.data_ptr(), part.data_ptr(), out.data_ptr(),
        *strides, B, S, nh, nkv, bk, int(pv_i8), sm_scale * _LOG2E,
        common.stream_ptr(q))
    common.check(_LIB_I8, _NAME_I8, rc)
    common.LAUNCHES[_NAME_I8] += 1
    return out, k8, v8t, sc


def flash_prefill_attention_kt_i8(q, kt, v, sm_scale: float,
                                  pv_i8: bool = True, blk_k: int = K_BLK):
    """flash_prefill_attention_kt with int8 score products (JAX's
    flash_prefill_attention_kt_i8, prefill_attention.py:377): q
    [B, S, nh, hd]; kt [B, nkv, hd, S] (a strided view of token-major K is
    read in place); v [B, S, nkv, hd] -> [B, S, nh, hd]. pv_i8: PV in int8
    on p's codes (default), else in bf16. CUDA tensors launch the prepass
    and the flash kernel (bf16, hd 128, S % 128 == 0, n_rep 1-8, the key
    block a multiple of 128 up to 512) and count one launch, or raise; CPU
    tensors run flash_prefill_attention_kt_i8_ref."""
    if q.device.type == "cpu":
        return flash_prefill_attention_kt_i8_ref(q, kt, v, sm_scale, pv_i8,
                                                 blk_k)
    return _launch_i8(q, kt, v, sm_scale, pv_i8, blk_k)[0]


def flash_prefill_ref(q, k, v, sm_scale: float):
    """JAX's pure-XLA blockwise oracle: for each q block (Q_BLK), float32
    scores against keys [0, S) with an elementwise causal mask and a
    float32 softmax -> [B, S, nh, hd] in q.dtype."""
    B, S, nh, hd = q.shape
    n_rep = nh // k.shape[2]
    bq = _shrink_to_divisor(min(Q_BLK, S), S)
    kf = _heads_first(k.to(torch.float32), n_rep)  # [B, nh, S, hd]
    vf = _heads_first(v.to(torch.float32), n_rep)
    qf = q.to(torch.float32).permute(0, 2, 1, 3)
    scale = torch.full((), sm_scale, dtype=torch.float32, device=q.device)
    col = torch.arange(S, device=q.device)
    out = torch.empty((B, nh, S, hd), dtype=torch.float32, device=q.device)
    for i in range(S // bq):
        s = (qf[:, :, i * bq:(i + 1) * bq] @ kf.transpose(-1, -2)) * scale
        row = i * bq + torch.arange(bq, device=q.device)[:, None]
        s = torch.where(row >= col, s, -math.inf)
        out[:, :, i * bq:(i + 1) * bq] = torch.softmax(s, dim=-1) @ vf
    return out.permute(0, 2, 1, 3).to(q.dtype)


def dense_causal_attention(q, k, v, sm_scale: float,
                           compute_dtype=torch.bfloat16):
    """q [B, S, nh, hd]; k/v [B, S, nkv, hd] -> [B, S, nh, hd] in
    compute_dtype. Scores in float32 with a -1e9 causal bias, probs cast
    back to compute_dtype before the PV product (as in JAX)."""
    S = q.shape[1]
    n_rep = q.shape[2] // k.shape[2]
    if n_rep > 1:
        k = k.repeat_interleave(n_rep, dim=2)
        v = v.repeat_interleave(n_rep, dim=2)
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    bias = torch.where(causal, 0.0, -1e9)[None, None]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(compute_dtype),
                          k.to(compute_dtype))
    scores = scores.to(torch.float32) * sm_scale + bias
    probs = torch.softmax(scores, dim=-1).to(compute_dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.to(compute_dtype))


def prefill_attention(q, k, v, sm_scale: float, use_kernel: bool,
                      compute_dtype=torch.bfloat16,
                      flash_threshold: int = FLASH_THRESHOLD):
    """JAX's dispatch: dense for short prompts (not is_flash(S,
    flash_threshold)), else the flash kernel with use_kernel, else the
    blockwise oracle."""
    if not is_flash(q.shape[1], flash_threshold):
        return dense_causal_attention(q, k, v, sm_scale, compute_dtype)
    if use_kernel:
        return flash_prefill_attention(q, k, v, sm_scale)
    return flash_prefill_ref(q, k, v, sm_scale)
