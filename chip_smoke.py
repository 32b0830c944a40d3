#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flatquant_torch) on one NVIDIA card.

    python3 chip_smoke.py                # all phases, one card
    python3 chip_smoke.py --kernels-only # phases 1-3 only

Phases (any failure makes the script exit non-zero without the final
line):
  1. build the CUDA kernels from flatquant_torch/kernels/csrc with nvcc
     for sm_90a (into flatquant_torch/kernels/_build/)
  2. print the card's name and power limit (nvidia-smi)
  3. hold each kernel against its plain PyTorch version on the card at
     llama-2-7b widths, and time kernel, plain version, bound and, for
     the GEMM, torch._int_mm on pre-unpacked int8 weights (a yardstick:
     it reads twice the weight bytes, and the port never calls it)
  4. drive the decode-serving path at full llama-2-7b width and depth
     (32 layers, random seeded weights, rn128 Kronecker transforms baked
     into the weights): generate for 4 prompts of 48 tokens, 64 new
     tokens, then 16 per-slot decode steps at ragged positions; the
     kernels' launch counts are read around this run. The same token
     sequence then runs teacher-forced with use_kernel=False (the plain
     versions) and the logits are compared step by step.
  5. print the kernel table as one JSON line, then the result line.

Details go to chiprun_out/chip_smoke.json. Nothing here imports JAX or
the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1.979e15   # dense int8 tensor-core rate
F32_FLOPS_PER_S = 67e12     # float32 outside the tensor cores
L2_BYTES = 50e6
OUT_DIR = "chiprun_out"

# attention tolerance: the kernel folds scale/zero into its epilogues and
# sums in another order than the dequantize-then-softmax plain version;
# bf16 outputs (the main path's dtype) may then round one ulp apart
ATTN_TOL = dict(rtol=1e-2, atol=1e-2)
# main path, kernels vs plain versions, teacher-forced. The prefill runs
# no kernel but the exact GEMM, so its logits must be bit-identical. In
# decode, the attention kernel's summation order differs from the plain
# version's by a bf16 ulp now and then, and W4A4 re-rounding grows any
# such difference into quantization-noise-sized changes of every later
# layer: on this random model an equally valid rounding variant (the plain
# path with float64 attention) decorrelates from the plain path to a mean
# logits cosine of ~0.64 within a few steps. So the decode logits are a
# tripwire for gross faults only (mean cosine within COSINE_MARGIN of that
# noise floor's), and the tight check is per launch: every kernel launch
# of a full-depth run against its plain version on the same inputs.
COSINE_MARGIN = 0.25


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes, ops, ops_rate):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(torch, fn, arg_sets, iters):
    """Mean device time of one call of fn: `iters` calls cycling through
    arg_sets (several copies keep the working set above the L2 cache, as
    a decode step finds each layer's weights cold) are captured in one
    CUDA graph, and one replay is timed with CUDA events. The graph keeps
    the host's per-call Python cost out of the device time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in arg_sets[:2]:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def copies_for(nbytes):
    return max(2, math.ceil(3 * L2_BYTES / max(nbytes, 1)))


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_gemm(torch, dev, gen, results):
    from flatquant_torch.kernels.int4_matmul import (
        unpack_weight_planar, w4a4_matmul_i8, w4a8_matmul_ref)

    shapes = {"qkv": (12288, 4096), "o": (4096, 4096),
              "upgate": (22016, 4096), "down": (4096, 11008)}
    rows, worst = [], 0.0
    for m in (1, 4, 8, 192):
        for name, (n, k) in shapes.items():
            xq = torch.randint(-8, 8, (m, k), generator=gen, device=dev,
                               dtype=torch.int8)
            xs = torch.rand((m, 1), generator=gen, device=dev) * 0.1 + 1e-3
            wbytes = n * k // 2
            ws = [(torch.randint(0, 256, (n, k // 2), generator=gen,
                                 device=dev, dtype=torch.uint8),
                   torch.rand((n,), generator=gen, device=dev) * 0.01 + 1e-4)
                  for _ in range(copies_for(wbytes))]
            got = w4a4_matmul_i8(xq, xs, *ws[0])
            want = w4a8_matmul_ref(xq, xs, *ws[0])
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            worst = max(worst, err)
            if not torch.equal(got, want):
                raise AssertionError(
                    f"w4a4_matmul_i8 M={m} {name} {n}x{k}: not bit-exact "
                    f"against w4a8_matmul_ref (max abs err {err})")
            args = [(xq, xs, wp, sw) for wp, sw in ws]
            ms = cuda_ms(torch, w4a4_matmul_i8, args, 60)
            plain = cuda_ms(torch, w4a8_matmul_ref, args, 6)
            # yardstick: cuBLAS int8 GEMM on pre-unpacked weights (2x the
            # bytes); it needs more than 16 rows, so small M pads to 32
            mp = m if m > 16 else 32
            xp = torch.randint(-8, 8, (mp, k), generator=gen, device=dev,
                               dtype=torch.int8)
            w8 = [(xp, unpack_weight_planar(wp).t()) for wp, _ in ws[:2]]
            lib = cuda_ms(torch, torch._int_mm, w8, 20)
            nbytes = m * k + wbytes + 4 * m + 4 * n + 2 * m * n
            b_ms, b_by = bound_ms(nbytes, 2 * m * n * k, INT8_OPS_PER_S)
            rows.append(dict(m=m, proj=name, n=n, k=k, ms=ms, plain_ms=plain,
                             library_ms=lib, library_rows=mp, bound_ms=b_ms,
                             bound_by=b_by, max_abs_err=err))
            log(f"  w4a4_matmul_i8 M={m:3d} {name:6s} {n}x{k}: bit-exact; "
                f"kernel_ms {ms:.4f} plain_ms {plain:.4f} bound "
                f"{b_ms * 1e3:.2f} us ({b_by}) library_ms(_int_mm, M={mp}, "
                f"yardstick) {lib:.4f}")
            del ws, args, w8
    results["w4a4_matmul_i8"] = dict(rows=rows, max_abs_err=worst)


def _rand_cache(torch, dev, gen, B, nkv, S):
    kp = torch.randint(0, 256, (B, nkv, S, 64), generator=gen, device=dev,
                       dtype=torch.uint8)
    vp = torch.randint(0, 256, (B, nkv, S, 64), generator=gen, device=dev,
                       dtype=torch.uint8)
    kpar = torch.stack([torch.rand((B, nkv, S), generator=gen, device=dev)
                        * 0.2 + 0.01,
                        torch.randint(0, 16, (B, nkv, S), generator=gen,
                                      device=dev).float()], -1)
    vpar = torch.stack([torch.rand((B, nkv, S), generator=gen, device=dev)
                        * 0.2 + 0.01,
                        torch.randint(0, 16, (B, nkv, S), generator=gen,
                                      device=dev).float()], -1)
    return kp, kpar, vp, vpar


def check_attention(torch, dev, gen, results, main_valid):
    from flatquant_torch.kernels.kv_cache import (
        decode_attention_int4, decode_attention_ref)

    def plain(q, kp, kpar, vp, vpar, valid, sm):
        return decode_attention_ref(q, kp, kpar[..., :1], kpar[..., 1:], vp,
                                    vpar[..., :1], vpar[..., 1:], valid, sm)

    S, sm = 2048, 1.0 / math.sqrt(128)
    cases = [("B=1 MHA 32/32", 1, 32, 32, [S]),
             ("B=4 MHA 32/32 ragged", 4, 32, 32, [0, 700, 1500, S]),
             ("B=4 GQA 32/8 ragged", 4, 32, 8, [S, 0, 1023, 77]),
             ("B=4 MHA 32/32 main path", 4, 32, 32, main_valid)]
    rows, worst = [], 0.0
    for label, B, nh, nkv, valid_l in cases:
        valid = torch.tensor(valid_l, device=dev, dtype=torch.int32)
        full = B * nkv * S * (64 * 2 + 16)
        caches = [_rand_cache(torch, dev, gen, B, nkv, S)
                  for _ in range(copies_for(full))]
        q = torch.randn((B, nh, 128), generator=gen, device=dev).to(
            torch.bfloat16)
        got = decode_attention_int4(q, *caches[0], valid, sm)
        want = plain(q, *caches[0], valid, sm)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        worst = max(worst, err)
        torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL)
        if not bool((got[valid == 0] == 0).all()):
            raise AssertionError("valid_len 0 must give 0")
        args = [(q, *c, valid, sm) for c in caches]
        ms = cuda_ms(torch, decode_attention_int4, args, 60)
        plain_ms = cuda_ms(torch, plain, args, 6)
        tokens = sum(min(v, S) for v in valid_l)
        nbytes = (tokens * nkv * (64 * 2 + 16) + B * nh * 128 * 2 * 2
                  + 4 * B)
        flops = tokens * (nh // nkv) * nkv * 128 * 4
        b_ms, b_by = bound_ms(nbytes, flops, F32_FLOPS_PER_S)
        rows.append(dict(case=label, B=B, nh=nh, nkv=nkv, S=S,
                         valid=valid_l, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, max_abs_err=err))
        log(f"  decode_attention_int4 {label} S={S} valid={valid_l}: max abs "
            f"err {err:.3e} (tol rtol/atol {ATTN_TOL['rtol']}); kernel_ms "
            f"{ms:.4f} plain_ms {plain_ms:.4f} bound {b_ms * 1e3:.2f} us "
            f"({b_by}); library_ms none")
        del caches, args
    results["decode_attention_int4"] = dict(rows=rows, max_abs_err=worst)


def check_write(torch, dev, gen, results):
    from flatquant_torch.kernels.kv_cache import write_token, write_token_ref

    S, nkv, rows = 2048, 32, []
    for B, pos_l in ((8, [0, 5, 127, 128, 900, 2047, 2048, 64]),
                     (4, [112, 100, 53, 111])):
        pos = torch.tensor(pos_l, device=dev, dtype=torch.int32)
        cache = _rand_cache(torch, dev, gen, B, nkv, S)
        copy = [c.clone() for c in cache]
        new = [c[:, :, :1].clone() + 1 for c in _rand_cache(
            torch, dev, gen, B, nkv, 1)]
        write_token(*cache, new[0], new[1], new[2], new[3], pos)
        write_token_ref(*copy, new[0], new[1], new[2], new[3], pos)
        torch.cuda.synchronize()
        for a, b in zip(cache, copy):
            if not torch.equal(a, b):
                raise AssertionError(f"write_token B={B}: not bit-exact")
        args = [(*cache, *new, pos)]
        ms = cuda_ms(torch, write_token, args, 200)
        plain_ms = cuda_ms(torch, write_token_ref, args, 10)
        hit = sum(0 <= p < S for p in pos_l)
        nbytes = 2 * hit * nkv * (64 * 2 + 16) + 4 * B
        b_ms, b_by = bound_ms(nbytes, 0, INT8_OPS_PER_S)
        rows.append(dict(B=B, pos=pos_l, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0))
        log(f"  write_token B={B} pos={pos_l}: bit-exact; kernel_ms {ms:.4f} "
            f"plain_ms {plain_ms:.4f} (masked select streams the cache) "
            f"bound {b_ms * 1e3:.3f} us ({b_by}); library_ms none")
        del cache, copy
    results["write_token"] = dict(rows=rows, max_abs_err=0.0)


# ---------------------------------------------------------------------------
# phase 4: the decode-serving path at full llama-2-7b width and depth
# ---------------------------------------------------------------------------


def build_model(torch, dev, seed):
    """Random llama-2-7b with random orthogonal transforms, baked and
    packed one layer at a time through the port's build_serving_layer."""
    from flatquant_torch.models.config import get_config
    from flatquant_torch.models.llama import init_layer_params
    from flatquant_torch.quantize.spec import W4A4KV4
    from flatquant_torch.serving.quantized import (
        build_serving_layer, kron_transform)
    import dataclasses

    cfg = get_config("llama-2-7b")
    fq = dataclasses.replace(W4A4KV4, tpu_decompose=True)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def orth(n):
        qm, r = torch.linalg.qr(torch.randn((n, n), generator=gen,
                                            device=dev, dtype=torch.float64))
        return (qm * torch.sign(torch.diagonal(r))).float()

    H, I, nh, hd = (cfg.hidden_size, cfg.intermediate_size, cfg.num_heads,
                    cfg.head_dim)
    clip = (1.0 / (1.0 + math.exp(-4.0)),) * 2  # sigmoid(4): the LAC init
    layers = []
    for _ in range(cfg.num_layers):
        lp = init_layer_params(cfg, gen, torch.float32, dev)
        lt = {"ln_t": (orth(H // 128), orth(128)),
              "ug_t": (orth(H // 128), orth(128)),
              "down_t": (orth(I // 128), orth(128)),
              "o_t": orth(nh), "k_t": orth(hd)}
        lt["k_t_inv"] = torch.linalg.inv(lt["k_t"]).T.contiguous()
        lt["a_clip"] = {nm: clip for nm in ("qkv", "o", "upgate", "down")}
        lt["kc_clip"] = lt["vc_clip"] = clip
        eye = torch.eye(hd, device=dev)
        # bake: y = x W^T = (x T)(W T)^T for orthogonal T, so W <- W T
        for key, tr in (("wq", "ln_t"), ("wk", "ln_t"), ("wv", "ln_t"),
                        ("wup", "ug_t"), ("wgate", "ug_t"),
                        ("wdown", "down_t")):
            lp[key] = kron_transform(lp[key], lt[tr])
        lp["wo"] = kron_transform(lp["wo"], (lt["o_t"], eye))
        layers.append(build_serving_layer(cfg, fq, lp, lt,
                                          dtype=torch.bfloat16))
        del lp
    emb = (torch.randn((cfg.vocab_size, H), generator=gen, device=dev)
           * 0.02).to(torch.bfloat16)
    head = (torch.randn((cfg.vocab_size, H), generator=gen, device=dev)
            * 0.02).to(torch.bfloat16)
    sp = {"embed": emb, "lm_head": head,
          "final_norm_w": torch.ones(H, device=dev), "layers": layers}
    return cfg, fq, sp


def profile_steps(torch, step, n):
    """Device time by kernel over n decode steps (torch.profiler), against
    the host wall time of the same steps: where a step's time goes, and
    the device's idle share. Measurement only: a profiler that records
    no device time is reported as 'not measured', not as a failure."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                step(i)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / n
        kern, launches = {}, 0
        for e in prof.key_averages():
            # device-side rows only: a CPU op's row repeats the device time
            # of the kernels it launched
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            if us > 0:
                kern[e.key] = kern.get(e.key, 0.0) + us / 1e3 / n
                launches += e.count
    except Exception as exc:  # measurement only, see docstring
        log(f"  decode profile: not measured ({type(exc).__name__}: {exc})")
        return None
    if not kern:
        log("  decode profile: not measured (no device time recorded)")
        return None
    groups = {"w4a4_matmul_i8": 0.0, "decode_attention_int4": 0.0,
              "write_token": 0.0, "other kernels (torch glue)": 0.0}
    for name, ms in kern.items():
        g = next((k for k in KERNELS if k in name),
                 "other kernels (torch glue)")
        groups[g] += ms
    busy_ms = sum(kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:10]
    log(f"  decode profile, per step: host wall {wall_ms:.3f} ms, device "
        f"busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}, "
        f"{launches / n:.0f} device kernels")
    for g, ms in groups.items():
        log(f"    {g}: {ms:.3f} ms/step")
    for name, ms in top:
        log(f"    kernel {name[:90]}: {ms:.4f} ms/step")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms,
                idle_share=1 - busy_ms / wall_ms, groups=groups,
                kernels_per_step=launches / n,
                top_kernels=top)


@contextlib.contextmanager
def patched(pairs):
    """Temporarily replace module attributes [(module, name, value)]."""
    saved = [(m, n, getattr(m, n)) for m, n, _ in pairs]
    for m, n, v in pairs:
        setattr(m, n, v)
    try:
        yield
    finally:
        for m, n, v in saved:
            setattr(m, n, v)


def _attention_f64(q, kp, ks, kz, vp, vs, vz, valid_len, sm_scale):
    """decode_attention_ref's math in float64 (the noise-floor variant)."""
    import torch

    from flatquant_torch.kernels.kv_cache import unpack_dequant_kv

    n_rep = q.shape[1] // kp.shape[1]
    k = unpack_dequant_kv(kp, ks.double(), kz.double(), torch.float64)
    v = unpack_dequant_kv(vp, vs.double(), vz.double(), torch.float64)
    k = k.repeat_interleave(n_rep, dim=1)
    v = v.repeat_interleave(n_rep, dim=1)
    sc = torch.einsum("bhd,bhsd->bhs", q.double(), k) * sm_scale
    ids = torch.arange(kp.shape[2], device=q.device).reshape(1, 1, -1)
    lim = valid_len.reshape(-1, 1, 1)
    sc = torch.where(ids < lim, sc, float("-inf"))
    out = torch.einsum("bhs,bhsd->bhd", torch.softmax(sc, -1), v)
    return torch.where(lim > 0, out, 0.0).to(q.dtype)


def check_launches_on_path(torch, cfg, fq, sp, prompt, feed, slot_pos0, P,
                           NEW, kw):
    """Every kernel launch of a short kernel-path run (prefill, 4 scalar and
    4 per-slot decode steps) checked against its plain version on the same
    inputs -- the path's own activations at full depth: GEMM and write
    bit-exact, attention within ATTN_TOL."""
    from flatquant_torch.kernels import int4_matmul, kv_cache
    from flatquant_torch.serving import engine, quantized

    n = {"w4a4_matmul_i8": 0, "decode_attention_int4": 0, "write_token": 0}
    worst = [0.0]

    def gemm(xq, xs, wp, sw, out_dtype=torch.bfloat16):
        y = int4_matmul.w4a4_matmul_i8(xq, xs, wp, sw, out_dtype)
        if not torch.equal(y, int4_matmul.w4a8_matmul_ref(xq, xs, wp, sw,
                                                          out_dtype)):
            raise AssertionError("w4a4_matmul_i8 not bit-exact on the path")
        n["w4a4_matmul_i8"] += 1
        return y

    def attn(q, kp, kpar, vp, vpar, valid, sm):
        y = kv_cache.decode_attention_int4(q, kp, kpar, vp, vpar, valid, sm)
        ref = kv_cache.decode_attention_ref(
            q, kp, kpar[..., :1], kpar[..., 1:], vp, vpar[..., :1],
            vpar[..., 1:], valid, sm)
        torch.testing.assert_close(y.float(), ref.float(), **ATTN_TOL)
        worst[0] = max(worst[0], (y.float() - ref.float()).abs().max().item())
        n["decode_attention_int4"] += 1
        return y

    def write(*a):
        copies = [t.clone() for t in a[:4]]
        kv_cache.write_token(*a)
        kv_cache.write_token_ref(*copies, *a[4:])
        for x, y in zip(a[:4], copies):
            if not torch.equal(x, y):
                raise AssertionError("write_token not bit-exact on the path")
        n["write_token"] += 1
        return a[:4]

    with patched([(quantized, "w4a4_matmul_i8", gemm),
                  (engine, "decode_attention_int4", attn),
                  (engine, "write_token", write)]):
        c = engine.init_cache(cfg, prompt.shape[0], kw["max_len"],
                              device=kw["device"])
        engine.serving_prefill(cfg, fq, sp, prompt, c, **kw)
        for i in list(range(4)) + list(range(NEW, NEW + 4)):
            pos = P + i if i < NEW else slot_pos0 + (i - NEW)
            if i == NEW:  # jump the cache to the per-slot phase
                c = engine.init_cache(cfg, prompt.shape[0], kw["max_len"],
                                      device=kw["device"])
                engine.serving_prefill(cfg, fq, sp, prompt, c, **kw)
            engine.serving_decode_step(cfg, fq, sp, feed[i], c, pos, **kw)
    torch.cuda.synchronize()
    log(f"  every launch on the path vs its plain version: {n} launches "
        f"checked; GEMM and write bit-exact, attention max abs err "
        f"{worst[0]:.3e}")
    return dict(launches=n, attention_max_abs_err=worst[0])


def run_main_path(torch, dev, results, smi):
    from flatquant_torch.kernels import common
    from flatquant_torch.serving import engine
    from flatquant_torch.serving.engine import (
        generate, init_cache, serving_decode_step, serving_prefill)

    B, P, NEW, SLOT, MAX_LEN = 4, 48, 64, 16, 2048
    t0 = time.perf_counter()
    cfg, fq, sp = build_model(torch, dev, seed=0)
    torch.cuda.synchronize()
    log(f"  built llama-2-7b W4A4KV4 rn128, {cfg.num_layers} layers, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, "
        f"{time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device=dev)
    slot_pos0 = torch.tensor([P + NEW, P + NEW - 5, P + 7, P + NEW - 20],
                             device=dev, dtype=torch.int32)
    kw = dict(max_len=MAX_LEN, device=dev)

    # warm-up (allocator, cuBLAS handles), not counted
    cache = init_cache(cfg, B, MAX_LEN, device=dev)
    serving_prefill(cfg, fq, sp, prompt, cache, **kw)
    serving_decode_step(cfg, fq, sp, prompt[:, -1:], cache, P, **kw)
    del cache
    torch.cuda.synchronize()

    common.reset_launches()
    t0 = time.perf_counter()
    gen_toks = generate(cfg, fq, sp, prompt.cpu().numpy(),
                        max_new_tokens=NEW, **kw)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0

    # the same run through the step entry points, timed per step
    cache = init_cache(cfg, B, MAX_LEN, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = serving_prefill(cfg, fq, sp, prompt, cache, **kw)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    feed, kernel_logits, step_ms = [], [logits.float().cpu()], []
    tok = logits.argmax(-1, keepdim=True)
    for i in range(NEW + SLOT):
        feed.append(tok)
        pos = P + i if i < NEW else slot_pos0 + (i - NEW)
        t0 = time.perf_counter()
        logits, cache = serving_decode_step(cfg, fq, sp, tok, cache, pos,
                                            **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        kernel_logits.append(logits.float().cpu())
        tok = logits.argmax(-1, keepdim=True)
    launches = dict(common.LAUNCHES)
    busy = profile_steps(torch, lambda i: serving_decode_step(
        cfg, fq, sp, tok, cache, P + NEW + SLOT + i, **kw), 4)
    got = torch.cat(feed[:NEW], 1).cpu().numpy()
    if not (got == gen_toks).all():
        raise AssertionError("generate and the step loop disagree")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the path")
    decode_ms = sorted(step_ms[1:NEW])[len(step_ms[1:NEW]) // 2]
    slot_ms = sorted(step_ms[NEW:])[len(step_ms[NEW:]) // 2]
    log(f"  [{smi}] generate B={B} prompt={P} new={NEW}: {generate_s:.2f} s")
    log(f"  [{smi}] prefill B={B} S={P}: {prefill_ms:.1f} ms")
    log(f"  [{smi}] decode (scalar pos) median {decode_ms:.2f} ms/step "
        f"= ms/token per sequence, B={B}")
    log(f"  [{smi}] decode (per-slot pos) median {slot_ms:.2f} ms/step, B={B}")
    if busy:
        busy["idle_share_unprofiled"] = 1 - busy["busy_ms"] / decode_ms
        log(f"  device idle share against the unprofiled step: "
            f"{busy['idle_share_unprofiled']:.3f}")
    log(f"  launches on the main path: {launches}")

    def forced(use_kernel):
        """Teacher-forced run over the kernel run's tokens -> logits."""
        c = init_cache(cfg, B, MAX_LEN, device=dev)
        lg, c = serving_prefill(cfg, fq, sp, prompt, c, use_kernel=use_kernel,
                                **kw)
        out = [lg.float().cpu()]
        for i, t in enumerate(feed):
            pos = P + i if i < NEW else slot_pos0 + (i - NEW)
            lg, c = serving_decode_step(cfg, fq, sp, t, c, pos,
                                        use_kernel=use_kernel, **kw)
            out.append(lg.float().cpu())
        return out

    def compare(xs, ys):
        cos = [torch.nn.functional.cosine_similarity(a, b, dim=-1).min()
               .item() for a, b in zip(xs, ys)]
        mad = [(a - b).abs().max().item() for a, b in zip(xs, ys)]
        agree = sum(int((a.argmax(-1) == b.argmax(-1)).all())
                    for a, b in zip(xs, ys))
        return cos, mad, agree

    plain_logits = forced(False)
    for a in kernel_logits + plain_logits:
        if not (torch.isfinite(a).all() and a.shape == (B, cfg.vocab_size)):
            raise AssertionError("logits not finite or of the wrong shape")
    cos, mad, agree = compare(kernel_logits, plain_logits)
    # the noise floor: the plain path again with attention in float64, a
    # rounding-level variant like the kernel is
    with patched([(engine, "decode_attention_ref", _attention_f64)]):
        f64_logits = forced(False)
    cos64, mad64, agree64 = compare(f64_logits, plain_logits)
    mean = lambda v: sum(v) / len(v)
    log(f"  kernels vs plain, teacher-forced, {len(cos)} steps: prefill max "
        f"abs diff {mad[0]} (must be 0); decode logits cosine mean "
        f"{mean(cos[1:]):.4f} min {min(cos[1:]):.4f}, max abs diff "
        f"{max(mad):.4f}, greedy agree on {agree}/{len(cos)} steps")
    log(f"  noise floor, plain with float64 attention vs plain: cosine mean "
        f"{mean(cos64[1:]):.4f} min {min(cos64[1:]):.4f}, max abs diff "
        f"{max(mad64):.4f}, greedy agree on {agree64}/{len(cos64)} steps")
    log(f"  per-step cosine, kernels vs plain: {[round(c, 4) for c in cos]}")
    log(f"  per-step cosine, float64 vs plain: {[round(c, 4) for c in cos64]}")
    if mad[0] != 0.0:
        raise AssertionError("prefill logits must be bit-identical: its only "
                             "kernel, the GEMM, is exact")
    if mean(cos[1:]) < mean(cos64[1:]) - COSINE_MARGIN:
        raise AssertionError("kernel path drifts from the plain versions "
                             "beyond the float64-attention noise floor")
    checks = check_launches_on_path(torch, cfg, fq, sp, prompt, feed,
                                    slot_pos0, P, NEW, kw)
    results["main_path"] = dict(
        model="llama-2-7b", layers=cfg.num_layers, batch=B, prompt=P,
        new_tokens=NEW, slot_steps=SLOT, max_len=MAX_LEN,
        generate_s=generate_s, prefill_ms=prefill_ms,
        decode_ms_per_step=decode_ms, slot_decode_ms_per_step=slot_ms,
        step_ms=step_ms, launches=launches, decode_profile=busy,
        logits_cosine=cos, logits_max_abs_diff=mad, greedy_agree_steps=agree,
        noise_floor_cosine=cos64, noise_floor_max_abs_diff=mad64,
        per_launch_checks=checks)
    return launches


# ---------------------------------------------------------------------------


KERNELS = {
    "w4a4_matmul_i8": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/int4_matmul.cu",
        replaces="flatquant_tpu/kernels/int4_matmul.py:306"),
    "decode_attention_int4": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/kv_cache.cu",
        replaces="flatquant_tpu/kernels/kv_cache.py:486"),
    "write_token": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/kv_cache.cu",
        replaces="flatquant_tpu/kernels/kv_cache.py:735"),
}


def kernel_line(results, launches):
    """One entry per kernel at the main path's decode shapes: the GEMM as
    one layer's four projections at M=4, attention at B=4 MHA over the
    valid lengths of the last generate step, the write at B=4."""
    out = []
    for name, meta in KERNELS.items():
        r = results[name]
        if name == "w4a4_matmul_i8":
            rows = [x for x in r["rows"] if x["m"] == 4]
            at = "M=4 (B=4 decode), sum of qkv+o+upgate+down of one layer"
        elif name == "decode_attention_int4":
            rows = [x for x in r["rows"] if x["case"].endswith("main path")]
            at = "B=4 MHA 32/32 S=2048, valid lengths of the last step"
        else:
            rows = [x for x in r["rows"] if x["B"] == 4]
            at = "B=4 nkv=32 S=2048"
        lib = ([x["library_ms"] for x in rows]
               if all("library_ms" in x for x in rows) else None)
        bounds = [x["bound_ms"] for x in rows]
        by = {x["bound_by"] for x in rows}
        out.append(dict(
            name=name, **meta, launches=launches.get(name, 0),
            max_abs_err=r["max_abs_err"],
            ms=sum(x["ms"] for x in rows),
            plain_ms=sum(x["plain_ms"] for x in rows),
            bound_ms=sum(bounds), bound_by=by.pop() if len(by) == 1 else
            "bytes", library_ms=None if lib is None else sum(lib), at=at))
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (phases 1-3)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing to run", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "flatquant_torch")):
        print("chip_smoke: run from a checkout of the repo (flatquant_torch/ "
              "is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from flatquant_torch.kernels import common

    torch.backends.cuda.matmul.allow_tf32 = False  # exact f32 plain GEMM
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    failed, results, launches = [], {}, {}

    def phase(name, fn, *a):
        log(f"== {name}")
        try:
            return fn(*a)
        except Exception:  # reported, and the run fails at the end
            traceback.print_exc()
            sys.stdout.flush()
            failed.append(name)
            return None

    secs = phase("phase 1: build kernels (nvcc, sm_90a)", common.build, True)
    if secs is not None:
        log(f"  build seconds: {secs:.1f} "
            f"(0 = already built in {common.BUILD_DIR})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    smi = smi[0].strip() if smi else "nvidia-smi gave nothing"
    log("== phase 2: card")
    print(smi, flush=True)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    gen = torch.Generator(device=dev).manual_seed(0)
    # valid lengths of the main path's last generate step (prompt 48 + 64)
    main_valid = [48 + 64] * 4
    if not failed:
        phase("phase 3a: w4a4_matmul_i8 vs w4a8_matmul_ref", check_gemm,
              torch, dev, gen, results)
        phase("phase 3b: decode_attention_int4 vs decode_attention_ref",
              check_attention, torch, dev, gen, results, main_valid)
        phase("phase 3c: write_token vs the masked select", check_write,
              torch, dev, gen, results)
    if not args.kernels_only and not failed:
        launches = phase("phase 4: llama-2-7b decode-serving path",
                         run_main_path, torch, dev, results, smi) or {}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi, torch=torch.__version__,
                       failed=failed, results=results), f, indent=1)
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    if not args.kernels_only:
        print(json.dumps(kernel_line(results, launches)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
