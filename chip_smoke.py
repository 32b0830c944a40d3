#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (flatquant_torch) on one NVIDIA card.

    python3 chip_smoke.py                # all phases, one card
    python3 chip_smoke.py --phases 3     # phases 1-3 only (3a-3j)
    python3 chip_smoke.py --phases 3h,10 # phases 1-2, 3h and 10
    python3 chip_smoke.py --phases 3i,11 # phases 1-2, 3i and 11
    python3 chip_smoke.py --phases 3j,12 # phases 1-2, 3j and 12
    python3 chip_smoke.py --phases 13    # phases 1-2 and 13
    python3 chip_smoke.py --phases 14    # phases 1-2 and 14

Phases (any failure makes the script exit non-zero without the final
line):
  1. build the CUDA kernels from flatquant_torch/kernels/csrc with nvcc
     for sm_90a (into flatquant_torch/kernels/_build/)
  2. print the card's name and power limit (nvidia-smi)
  3. hold each kernel against its plain PyTorch version on the card at
     llama-2-7b widths, and time kernel, plain version, bound and, for
     the GEMM, torch._int_mm on pre-unpacked int8 weights (a yardstick:
     it reads twice the weight bytes, and the port never calls it)
     3a: w4a4_matmul_i8's two bodies (the dp4a stream, the wgmma tile),
     each bit for bit and timed at M = 1 to 2048 on the four linears,
     the crossover they give against the route's TILE_MIN_M (the phase
     fails if the route picks the tile where the stream was faster), and
     edge shapes (ragged M and N, K % 64 == 32, DeepSeek's K) on both;
     then w4a4_matmul_i8_fusedq's two bodies (the dp4a body, the tile on
     its quantized workspace) at M = 1 to 2048 on the same linears, bit
     for bit against quant_acts_i8 + w4a4_matmul_i8 and timed beside that
     composed route, failing where another body beat the routed one by
     more than ROUTE_MARGIN
     3c: write_token bit for bit at B = 4 and 8 (positions S and -1),
     B = 1 with 4 kv heads and 36-byte code rows, timed beside a
     one-element in-place add under the same graph harness (the floor of
     a graph-launched kernel)
     3d: the four prefill kernels (rmsnorm_right_flat, left_quant_i8_flat,
     w4a4_matmul_i8_swiglu_right, attn_prologue) at the 4 x 512 prefill's
     shapes (the swiglu GEMM also at M = 32 to 1024; rmsnorm_right_flat
     also at T = 1 and with float32 x at H = 4096 and 8192), each with identity
     and with random orthogonal transform factors (tolerances in
     flatquant_torch/kernels/tolerance.py), timed like the others
     3e: both flash prefill entry points (flash_prefill_attention,
     flash_prefill_attention_kt) at llama-2-7b's 1 x 2048, llama-3-8b's
     GQA heads and S=1152, within the "flash" tolerance, timed beside the
     causal scaled_dot_product_attention call (a yardstick only)
     3b: decode_attention_int4 at B=1 and B=4, MHA, GQA 32/8 and 28/4,
     and at the decode body's span edges beside valid_len 0
     3f: chunk_attention_int4 (Sq=256 at pos 0, 768, 1792 over S=2048),
     paged_decode_attention_int4 (B=4, valid 1..2048, and the span edges
     beside 0; block 256, shuffled tables) and paged_chunk_attention_int4
     (chunks straddling a block edge), MHA 32/32, GQA 32/8 and
     Qwen-2.5-7B's 28/4 (n_rep 7; 3b has it too), each paged kernel also
     bit for bit against its slot twin on the gathered cache; the chunk
     kernels' bound at the tensor cores' bf16 rate
     3g: quant_acts_i8 at [2048, 18944] (clips, q_max 7) and [256, 8192]
     (q_max 127, a zero row), codes and scales bit for bit;
     w4a4_matmul_i8_swiglu at Qwen-2.5-7B's MLP (M = 32 to 2048, K=3584,
     NH=18944); w4a8_matmul's bodies (the weight stream, the wgmma tile)
     each at M = 1 to 2048 on llama-2-7b's
     four linears (the stream up to M = 64), the phase failing where
     another body beat the routed one by more than ROUTE_MARGIN, and at
     edge shapes (ragged M and N, K % 128 == 64); timed beside their
     bounds and library yardsticks (torch._int_mm, torch.matmul on bf16
     weights)
     3h: fp8_matmul (row 16), each of its three wgmma bodies, on all 254
     non-NaN e4m3 codes in both decodes, bit for bit, and at
     DeepSeek-V2-Lite's fp8 linears (wq and wo at M = 1, 4, 64, 2048,
     the shared experts, the 64 routed experts batched in one launch at
     decode and at the gather capacity) and DeepSeek-V3's wkv_a (N = 576
     unpadded), timed beside torch.matmul on pre-dequantized bf16
     weights, failing where another body beat the routed one by more
     than ROUTE_MARGIN;
     w4a4_matmul_i8 at K = 10944 and 2816 and N = 576, both bodies bit
     for bit
     3i: rows 17-21, the JAX package's measured kernel baselines:
     w4a4_matmul_i8_fusedq (one layer's four linears at M=4, the merged
     qkv at M=2048) bit for bit against quant_acts_i8 + w4a4_matmul_i8;
     flash_prefill_attention_kt_i8 in both pv_i8 modes (3e's shapes)
     within the "flash" tolerance, its prepass bit for bit (V8^T in the
     kernel's key order) and timed on its own, its rel-RMS against the
     float32 oracle; decode_attention_int4_v1, _wide and _v3
     at row 2's and Qwen-2.5-7B's shapes and the span edges within
     ATTN_TOL; each timed beside its bound and yardstick
     3j: rows 22-27, the grouped layout [G, T, 128], at llama-2-7b's
     1 x 2048 shapes (rmsnorm_right_grouped, left_quant_i8_grouped at G=32
     and 86, w4a4_swiglu_grouped and _gx at N=2x11008 and M = 32 to 2048,
     w4a4_matmul_i8_grouped at qkv and down, quant_acts_i8_grouped at
     [86, 2048, 128]) and edge shapes (M=300, no clips, f32 input): each
     held to its plain version and bit for bit to its flat twin (rows 4,
     5, 6, 1, 12; row 25 in both of row 1's bodies); timed beside its
     bound and, for the GEMMs, torch._int_mm; w4a4_matmul_i8 itself
     timed at M = 4 and 2048
  4. build one random llama-2-7b (32 layers, random seeded weights, rn128
     Kronecker transforms baked into the weights; shared by phases 4 to
     6) and drive the decode-serving path at full width and depth:
     generate for 4 prompts of 48 tokens, 64 new tokens, then 16 per-slot
     decode steps at ragged positions; the kernels' launch counts are read
     around this run. The same token sequence then runs teacher-forced
     with use_kernel=False (the plain versions) and the logits are
     compared step by step.
  5. drive the fused prompt prefill: serving_prefill at B=4, S=512 (2048
     rows: every fused route and the attention prologue) over the int4
     cache, 16 greedy decode steps over the cache the prologue wrote, and
     a 4 x 128 prefill (fused input and MLP routes, composed attention);
     launch counts read around the runs, a profile of one prefill, every
     launch of a full-depth prefill checked against its plain version,
     and the logits compared with the same routes run on the plain
     versions (a tripwire: random W4A4 logits are chaotic).
  6. long prompts with tools/fulldepth_bench.py's protocol (1 x 2048,
     max_len 2304): (a) serving_prefill over the int4 cache (prologue and
     flash kt) and 32 decode steps, the prefill with w4a4_matmul_i8
     forced to its stream body against the route (tile) in 3 interleaved
     rounds with bit-identical logits, a profile of one prefill and every
     launch of one prefill checked; (b) serving_all_logits through the
     bf16-cache engine (flash on the [B, S, nkv, hd] layout), every flash
     launch checked, its last logits against (a)'s; (c) the bf16
     comparator (serving/baseline.py) on a random bf16 llama-2-7b:
     prefill and 32 decode steps timed, its flash launches checked, then
     freed.
  7. the continuous batcher (serving/batcher.py) over the phase-4 model,
     rebuilt from its seed (use_kernel=True, bf16 compute, 4 slots,
     max_len 2048): (a) the int4 slot cache with chunked prefill of 256
     on eight requests (prompts of 40 to 1500 tokens, 16 to 32 new
     tokens each), (b) the same over the paged pool (block 256, the
     default half-capacity pool: admission defers), (c)/(d) int4 and
     paged with prefill buckets of 128 on the first four, (e) the bf16
     cache, chunked, on two. One line per run (wall s, tokens, tokens/s,
     median decode step and chunk, launches); (a) and (b) again with
     every launch of rows 9-11 held to its plain version; (b) = (a) and
     (d) = (c) token for token; every pool block returned.
  8. Qwen-2.5-7B at full width and depth (28 layers, 28/4 heads, qkv
     bias), W4A4KV4 in JAX's default configuration (no tpu_decompose: the
     balanced Kronecker split, flatquant_torch/core/kron.py), over the
     int4 cache: serving_prefill 1 x 2048 (rows 12 and 13 in every layer)
     and 32 greedy decode steps at B=1; the prefill's stream and tile
     routes of w4a4_matmul_i8 in 3 interleaved rounds, as in 6a; a
     profile of one prefill; every
     launch of one prefill and every decode attention launch of two steps
     checked against its plain version.
  9. llama-2-7b weight-only W4A16 (bf16 cache) at full width and depth,
     with phase 6c's protocol (1 x 2048 prefill, 32 decode steps): every
     linear through w4a8_matmul (row 14), every launch of a prefill and
     two decode steps checked; a profile of one decode step.
  10. DeepSeek-V2-Lite at full width and depth (27 layers, 64 routed
     experts), random seeded weights, serve mode, bf16: (a) native FP8,
     deepseek_generate of a 1 x 2048 prompt (gather MoE) and 32 decode
     steps (dense-masked MoE), a profile of one prefill and one step
     (row 16's share of it), fp8_matmul's launches by body, every
     fp8_matmul launch of a prefill and two steps checked, the
     plain-route calls of fp8_linear (wkv_a and the dense FFN in
     64-blocks) counted; (b) the continuous batcher with the DeepSeek
     hooks on six requests (chunks of 256), a tripwire against
     single-request generation; (c) packed W4A4 (init_ds_fq's state,
     baked and packed layer by layer), a 1 x 2048 prefill and 32 decode
     steps, every w4a4_matmul_i8 launch of a prefill checked.
  11. rows 17-21 each in place of its twin on phase 7's llama-2-7b (the
     phase-4 model rebuilt from its seed): (a) phase 4's generate protocol
     with every A4 linear below 256 rows through w4a4_matmul_i8_fusedq,
     tokens and logits bit-identical to the composed run, its launches
     by body as the route gives them, and the 4 x 48 prefill timed
     against the composed route's in interleaved rounds; (b) the same
     decode with rows 19, 20, 21 in turn at decode_attention_int4's call
     site, every launch of two steps checked; the decode step of (a) and
     (b) timed against the composed run's in interleaved rounds; (c) the
     1 x 2048 prefill with flash_prefill_attention_kt_i8 (pv_i8 on, off)
     at flash_prefill_attention_kt's, every launch checked, wall times
     interleaved with row 8's.
  12. rows 22-27 at their flat twins' call sites in phase 6a's 1 x 2048
     prefill on phase 7's llama-2-7b: (a) the fused attention input (rows
     26 -> 23 -> 25) and MLP (26 -> 23 -> 27 -> 23 -> 25) on the grouped
     layout, every launch checked against its plain version and bit for
     bit against its flat twin, the logits bit-identical to the flat
     routes'; (b) the MLP's round-2 tail (rows 4 -> 5 -> 22 -> a bf16
     torch.matmul of the left factor -> 24 -> 25), every launch checked,
     the logits a tripwire; the flat, (a) and (b) prefills timed in 3
     interleaved rounds.
  13. llama-2-7b (32 layers, full width, W4A4KV4 + tpu_decompose) built by
     the port's own chain on the card, bench.py's recipe: seeded fp
     weights, init_model_fq(seed=0) -> bake_model ->
     build_serving_params(merge_projections=True); the build's seconds,
     peak memory and the packed model's size. (a) layer 0 packed again on
     the CPU from the same fp weights and the transforms frozen on the
     card, every nibble and scale compared (the tie rule: at most 1e-5 of
     the nibbles differ, each by one code, scales within 2^-22), and from
     the raw FQ state (the Cayley solves on the CPU; reported only);
     (b) the merged model: 1 x 2048 prefill + 32 decode steps over the
     int4 cache, timed, every launch of a prefill and of 8 decode steps
     checked; (c) JAX's default unmerged layout and (d) the perm layout
     at 2 layers: 1 x 2048 prefill + 8 decode steps each, every launch
     checked, launches printed by row, prefill logits against (b)'s model
     cut to 2 layers (bf16 on the kernels, a tripwire; float32 on the
     plain versions, floor 0.99).
  14. the calibrate -> eval pipeline (main.py's path): (a) the port's CLI
     in process on qwen-2.5-0.5b (24 layers, full width): W4A4KV4 with
     every learnable group, 1 epoch of 16 x 2048 synthetic tokens, GPTQ,
     PPL, the three exports and a 16-token demo on the kernels, every
     w4a4_matmul_i8 launch of the run checked bit for bit; each export
     reloaded equal, the reloaded safetensors serving the same
     tokens; (b) llama-2-7b width, 2 layers, rn128: calibrate, bake,
     gptq_model, build_serving_params (merged), a 1 x 2048 prefill and 8
     decode steps timed and every launch checked; the MSE of each step
     finite and falling within its layer; (c) DeepSeek-V2-Lite width, 1
     dense + 1 MoE layer with 64 experts: calibrate_deepseek on 2 x 512,
     bake_ds_fq, build_ds_serving_params, a 1 x 512 prefill and 8 decode
     steps timed and every w4a4_matmul_i8 launch checked bit for bit.
     Seconds per calibration step, teacher pass and GPTQ layer, and peak
     memory, printed.
  Each model is freed before the next is built. Then the kernel table as
  one JSON line, then the result line.

Details go to chiprun_out/chip_smoke.json. Nothing here imports JAX or
the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import subprocess
import sys
import time
import traceback

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
INT8_OPS_PER_S = 1.979e15   # dense int8 tensor-core rate
BF16_FLOPS_PER_S = 989e12   # dense bf16 tensor-core rate
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


def sweep_ms(torch, fn, arg_sets, budget_ms=15.0):
    """cuda_ms with the launch count fitted to the call: 3 calls time it
    roughly, then as many as fill about budget_ms (3 to 60), so a sweep
    over bodies that differ 100-fold spends about the same on each."""
    probe = cuda_ms(torch, fn, arg_sets, 3)
    return cuda_ms(torch, fn, arg_sets,
                   max(3, min(60, int(budget_ms / max(probe, 1e-3)))))


def route_faults(rows, bodies):
    """(M, shape, routed body, faster body) wherever another body beat the
    routed one by more than ROUTE_MARGIN of the routed body's time (two
    bodies within it are a tie: repeated calls of one body spread ~1%)."""
    out = []
    for r in rows:
        best = min(bodies, key=lambda b: r[f"{b}_ms"])
        if r[f"{best}_ms"] * (1 + ROUTE_MARGIN) < r[f"{r['body']}_ms"]:
            out.append((r["m"], r["proj"], r["body"], best))
    return out


def crossover(rows, xs, key, fast, slow):
    """The smallest x of xs from which `fast` beat `slow` in every row at
    every larger x (rows keyed by r[key]), or None."""
    won = {x: all(r[f"{fast}_ms"] < r[f"{slow}_ms"] for r in rows
                  if r[key] == x) for x in xs}
    return next((x for i, x in enumerate(xs)
                 if all(won[y] for y in xs[i:])), None)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


# phase 3a's sweep of row 1's two bodies; the edge shapes (M, N, K) both
# bodies are held to the plain version at, in both output types: ragged
# M and N (an odd N, DeepSeek-V2-Lite's wkv_a N = 576), K = 96 (one
# stage), K % 64 == 32 (2816 + 32), DeepSeek's K = 10944 and 2816, and
# each side of the crossover
SWEEP_M = (1, 4, 8, 16, 32, 64, 128, 192, 256, 512, 2048)
BODIES = ("stream", "tile")
# phase 3a's sweep of row 17's two bodies; the weight widths (K = 4096)
# at which both are also timed at M = FUSEDQ_WIDE_MIN_M, around
# FUSEDQ_WIDE_N; and the margin by which another body must beat the
# routed one for the route checks of rows 17 and 16 to fail
# phase 3g's sweep of row 14's bodies (the stream only up to
# W4A8_STREAM_SWEEP_MAX_M rows: it re-reads the weight per 4 rows) and
# its edge shapes: ragged M and N, K % 128 == 64 (a last tile stage of 32
# packed bytes), each side of the route's edge
W4A8_SWEEP_M = (1, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)
W4A8_STREAM_SWEEP_MAX_M = 64
W4A8_EDGES = ((8, 999, 2880), (9, 4096, 4096), (33, 576, 11008),
              (300, 1000, 2880))
# the M at which phases 3d, 3g and 3j time the swiglu GEMMs (rows 6, 13,
# 22, 27); the paths' prefills give them 2048 rows
SWIGLU_SWEEP_M = (32, 64, 128, 256, 512, 1024, 2048)
FUSEDQ_SWEEP_M = (1, 4, 16, 32, 64, 192, 2048)
FUSEDQ_WIDE_SWEEP_N = (5120, 6144, 7168, 8192, 10240)
ROUTE_MARGIN = 0.03
# phase 3e's flash sweep (S, nh, nkv), B=1, the main path's shape first
# (llama-2-7b's 1 x 2048); S = 1152 gives 9 query tiles, an odd count the
# grid's two warpgroups and longest-first order meet nowhere else.
# Phase 3d's prologue bodies
FLASH_SWEEP = ((2048, 32, 32), (2048, 32, 8), (2048, 28, 4), (1024, 32, 32),
               (1024, 32, 8), (1024, 28, 4), (4096, 32, 32), (4096, 32, 8),
               (4096, 28, 4), (1152, 32, 32))
PROLOGUE_BODIES = ("mma", "simt")
# phase 3d's prologue shapes (B, S): phase 5's 4 x 512 (the kernel line's)
# and the 1 x 2048 of phases 6, 8 and 12
PROLOGUE_SHAPES = ((4, 512), (1, 2048))


def gemm_edges(tile_min_m):
    return ((1, 576, 2048), (4, 999, 160), (tile_min_m - 1, 12288, 2816),
            (tile_min_m, 4096, 11008), (130, 576, 96), (300, 2048, 10944),
            (300, 999, 2848), (2047, 4096, 2816))


def forced_body(body, route="w4a4_body"):
    """Route every w4a4_matmul_i8 / w4a4_matmul_i8_grouped launch (route
    "fusedq_body": every w4a4_matmul_i8_fusedq launch) to `body` ("stream"
    or "tile") while the context is open."""
    from flatquant_torch.kernels import int4_matmul as im

    return patched([(im, route, lambda m, n, k: body)])


def forced_fp8(body):
    """Route every fp8_matmul launch to `body` ("n8", "n64", "n128")."""
    from flatquant_torch.kernels import fp8_matmul as f8

    return patched([(f8, "fp8_body", lambda m: body)])


def _codes_scales(torch, dev, gen, m, k):
    xq = torch.randint(-8, 8, (m, k), generator=gen, device=dev,
                       dtype=torch.int8)
    return xq, torch.rand((m, 1), generator=gen, device=dev) * 0.1 + 1e-3


def check_gemm(torch, dev, gen, results):
    """Row 1's two bodies at every M of SWEEP_M on llama-2-7b's four
    shapes: each held bit for bit to w4a8_matmul_ref and timed beside its
    bound, the plain version and torch._int_mm on pre-unpacked int8
    weights (a yardstick the port never calls). The sweep gives the
    crossover, the smallest M from which the tile body is faster at all
    four shapes, and the phase fails if the route (TILE_MIN_M) picks the
    tile where it was slower. Then gemm_edges' shapes, both bodies, both
    output types, checked and not timed."""
    from flatquant_torch.kernels import int4_matmul as im

    shapes = {"qkv": (12288, 4096), "o": (4096, 4096),
              "upgate": (22016, 4096), "down": (4096, 11008)}
    rows = []
    for m in SWEEP_M:
        for name, (n, k) in shapes.items():
            xq, xs = _codes_scales(torch, dev, gen, m, k)
            ws = _rand_weights(torch, dev, gen, n, k)
            want = im.w4a8_matmul_ref(xq, xs, *ws[0])
            args = [(xq, xs, wp, sw) for wp, sw in ws]
            iters = 60 if m <= 256 else 20
            ms = {}
            for body in BODIES:
                with forced_body(body):
                    got = im.w4a4_matmul_i8(xq, xs, *ws[0])
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        err = (got.float() - want.float()).abs().max().item()
                        raise AssertionError(
                            f"w4a4_matmul_i8 {body} M={m} {name} {n}x{k}: "
                            f"not bit-exact against w4a8_matmul_ref (max abs "
                            f"err {err})")
                    ms[body] = cuda_ms(torch, im.w4a4_matmul_i8, args, iters)
            routed = im.w4a4_body(m, n, k)
            plain = cuda_ms(torch, im.w4a8_matmul_ref, args,
                            6 if m <= 256 else 3)
            # yardstick: cuBLAS int8 GEMM on pre-unpacked weights (2x the
            # bytes); it needs more than 16 rows, so small M pads to 32
            mp = m if m > 16 else 32
            xp = torch.randint(-8, 8, (mp, k), generator=gen, device=dev,
                               dtype=torch.int8)
            w8 = [(xp, im.unpack_weight_planar(wp).t()) for wp, _ in ws[:2]]
            lib = cuda_ms(torch, torch._int_mm, w8, 20)
            nbytes = m * k + n * k // 2 + 4 * m + 4 * n + 2 * m * n
            b_ms, b_by = bound_ms(nbytes, 2 * m * n * k, INT8_OPS_PER_S)
            rows.append(dict(m=m, proj=name, n=n, k=k, body=routed,
                             ms=ms[routed], plain_ms=plain, library_ms=lib,
                             library_rows=mp, bound_ms=b_ms, bound_by=b_by,
                             max_abs_err=0.0,
                             **{f"{b}_ms": ms[b] for b in BODIES}))
            log(f"  w4a4_matmul_i8 M={m:4d} {name:6s} {n}x{k}: both bodies "
                f"bit-exact; " + " ".join(f"{b}_ms {ms[b]:.4f}"
                                          for b in BODIES)
                + f" (route: {routed}) plain_ms {plain:.4f} bound "
                f"{b_ms * 1e3:.2f} us ({b_by}) library_ms(_int_mm, M={mp}, "
                f"yardstick) {lib:.4f}")
            del ws, args, w8
    cross = crossover(rows, SWEEP_M, "m", "tile", "stream")
    wrong = [(r["m"], r["proj"]) for r in rows
             if r["body"] == "tile" and r["tile_ms"] >= r["stream_ms"]]
    log(f"  crossover: the tile body is faster at all four shapes from M="
        f"{cross} on (sweep {SWEEP_M}); the route's TILE_MIN_M = "
        f"{im.TILE_MIN_M}")
    if wrong:
        raise AssertionError(f"the route picks the tile body where the "
                             f"stream body was faster: {wrong}")
    for m, n, k in gemm_edges(im.TILE_MIN_M):
        xq, xs = _codes_scales(torch, dev, gen, m, k)
        wp, sw = _rand_weights(torch, dev, gen, n, k, 1)[0]
        for out in (torch.bfloat16, torch.float32):
            want = im.w4a8_matmul_ref(xq, xs, wp, sw, out)
            for body in BODIES:
                with forced_body(body):
                    got = im.w4a4_matmul_i8(xq, xs, wp, sw, out)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"w4a4_matmul_i8 {body} M={m} N={n} K={k} {out}: "
                        "not bit-exact against w4a8_matmul_ref")
        log(f"  w4a4_matmul_i8 M={m} N={n} K={k}: both bodies bit-exact in "
            f"bf16 and f32")
    results["w4a4_matmul_i8"] = dict(rows=rows, max_abs_err=0.0,
                                     crossover_m=cross,
                                     tile_min_m=im.TILE_MIN_M)


def _fusedq_case(torch, dev, gen, im, clip, m, n, k):
    """Random weights (enough copies to pass L2), bf16 activations [m, k]
    with a zero row (scale 1, codes 0) and row 17's plain output on them,
    which the composed route (rows 12 + 1) must equal bit for bit."""
    ws = _rand_weights(torch, dev, gen, n, k)
    x = (torch.randn((m, k), generator=gen, device=dev) * 2).to(
        torch.bfloat16)
    x[m // 2] = 0
    plain = im.w4a4_matmul_i8_fusedq_ref(x, *ws[0], clip)
    composed = im.w4a4_matmul_i8(*im.quant_acts_i8(x, clip, 7), *ws[0])
    if not torch.equal(composed, plain):
        raise AssertionError(f"quant_acts_i8 + w4a4_matmul_i8 M={m} {n}x{k}: "
                             "not bit-exact against "
                             "w4a4_matmul_i8_fusedq_ref")
    return ws, x, plain


def _fusedq_timed(torch, im, x, ws, clip, plain, body):
    """Row 17 forced to `body`: held bit for bit to its plain output, then
    timed."""
    def fn(wp, sw):
        return im.w4a4_matmul_i8_fusedq(x, wp, sw, clip)

    with forced_body(body, "fusedq_body"):
        got = fn(*ws[0])
        torch.cuda.synchronize()
        if not torch.equal(got, plain):
            err = (got.float() - plain.float()).abs().max().item()
            raise AssertionError(
                f"w4a4_matmul_i8_fusedq {body} M={x.shape[0]} "
                f"{plain.shape[1]}x{x.shape[1]}: not bit-exact against "
                f"w4a4_matmul_i8_fusedq_ref (max abs err {err})")
        return sweep_ms(torch, fn, ws)


def check_fusedq(torch, dev, gen, results):
    """Row 17's two bodies (w4a4_matmul_i8_fusedq: the dp4a body, the
    tile body on its quantized workspace) at every M of FUSEDQ_SWEEP_M on
    llama-2-7b's four linears and at M = FUSEDQ_WIDE_MIN_M on the widths
    of FUSEDQ_WIDE_SWEEP_N, bf16 activations with LAC clips and a zero
    row: each bit for bit against the plain version, as is the composed
    route (quant_acts_i8, then w4a4_matmul_i8 on its route), and timed
    beside that route (rows 12 + 1), the bound and, at M = 4 and 2048, the
    plain version and torch._int_mm on pre-unpacked int8 weights (a
    yardstick the port never calls); the bodies in ROUTE_ROUNDS
    interleaved rounds, each body's best kept. The crossovers are the
    smallest M
    (or N at M = FUSEDQ_WIDE_MIN_M) from which the tile body is faster at
    every measured shape; the phase fails where another body beat the
    routed one by more than ROUTE_MARGIN."""
    from flatquant_torch.kernels import int4_matmul as im

    shapes = {"qkv": (12288, 4096), "o": (4096, 4096),
              "upgate": (22016, 4096), "down": (4096, 11008)}
    clip = _lac_clip(torch, dev)
    cases = [(m, name, n, k) for m in FUSEDQ_SWEEP_M
             for name, (n, k) in shapes.items()]
    cases += [(im.FUSEDQ_WIDE_MIN_M, f"n{n}", n, 4096)
              for n in FUSEDQ_WIDE_SWEEP_N]
    rows = []
    for m, name, n, k in cases:
        ws, x, plain_out = _fusedq_case(torch, dev, gen, im, clip, m, n, k)
        # the bodies in interleaved rounds, each body's best kept: two
        # bodies that tie (at M = 4 on the qkv weight one round reads
        # 0.0330-0.0353 ms for the tile and 0.0338-0.0343 for the stream
        # on an H100 at 700 W) flip past ROUTE_MARGIN on one round's noise
        times = {b: [] for b in BODIES}
        for _ in range(ROUTE_ROUNDS):
            for b in BODIES:
                times[b].append(_fusedq_timed(torch, im, x, ws, clip,
                                              plain_out, b))
        ms = {b: min(t) for b, t in times.items()}
        composed = sweep_ms(torch, lambda wp, sw: im.w4a4_matmul_i8(
            *im.quant_acts_i8(x, clip, 7), wp, sw), ws)
        routed = im.fusedq_body(m, n, k)
        plain = lib = None
        if m in (4, 2048):
            plain = cuda_ms(torch, lambda wp, sw: (
                im.w4a4_matmul_i8_fusedq_ref(x, wp, sw, clip)), ws, 3)
            mp = m if m > 16 else 32
            xp = torch.randint(-8, 8, (mp, k), generator=gen, device=dev,
                               dtype=torch.int8)
            w8 = [(xp, im.unpack_weight_planar(wp).t()) for wp, _ in ws[:2]]
            lib = cuda_ms(torch, torch._int_mm, w8, 20)
            del w8
        nbytes = 2 * m * k + n * k // 2 + 4 * n + 2 * m * n + 8
        b_ms, b_by = bound_ms(nbytes, 2 * m * n * k, INT8_OPS_PER_S)
        rows.append(dict(m=m, proj=name, n=n, k=k, body=routed,
                         ms=ms[routed], plain_ms=plain, library_ms=lib,
                         composed_ms=composed, bound_ms=b_ms, bound_by=b_by,
                         max_abs_err=0.0,
                         **{f"{b}_ms": ms[b] for b in BODIES}))
        lib_s = "" if lib is None else (f" plain_ms {plain:.4f} "
                                        f"library_ms(_int_mm) {lib:.4f}")
        log(f"  w4a4_matmul_i8_fusedq M={m:4d} {name:6s} {n}x{k}: both "
            f"bodies and the composed route bit-exact against the plain "
            f"version; " + " ".join(f"{b}_ms {ms[b]:.4f}" for b in BODIES)
            + f" (route: {routed}) composed_ms {composed:.4f} "
            f"(x{ms[routed] / composed:.3f}) bound {b_ms * 1e3:.2f} us "
            f"({b_by})" + lib_s)
        del ws, x
    llama = [r for r in rows if r["proj"] in shapes]
    cross = crossover(llama, FUSEDQ_SWEEP_M, "m", "tile", "stream")
    at_wide = [r for r in rows if r["m"] == im.FUSEDQ_WIDE_MIN_M]
    cross_n = crossover(at_wide, sorted({r["n"] for r in at_wide}), "n",
                        "tile", "stream")
    log(f"  crossover: row 17's tile body is faster at all four shapes "
        f"from M={cross} on (sweep {FUSEDQ_SWEEP_M}), and at M="
        f"{im.FUSEDQ_WIDE_MIN_M} at every measured N from N={cross_n} on; "
        f"its route takes the tile from M={im.TILE_MIN_M}, from M="
        f"{im.FUSEDQ_WIDE_MIN_M} for N >= {im.FUSEDQ_WIDE_N}, and from M="
        f"{im.FUSEDQ_WAVE_MIN_M} for N in {im.FUSEDQ_WAVE_N}")
    wrong = route_faults(rows, BODIES)
    if wrong:
        raise AssertionError(f"row 17's route picks a body that another beat "
                             f"by more than {ROUTE_MARGIN:.0%}: {wrong}")
    r = results.setdefault("w4a4_matmul_i8_fusedq",
                           dict(rows=[], max_abs_err=0.0))
    r["rows"] += rows
    r.update(crossover_m=cross, wide_crossover_n=cross_n)


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


def span_edges():
    """Valid lengths at the decode body's span edges (one span, two, and
    the tile edge inside the first)."""
    from flatquant_torch.kernels.kv_cache import DECODE_SPAN as span

    return sorted({127, 128, 129, span - 1, span, span + 1, 2 * span + 1})


def check_attention(torch, dev, gen, results, main_valid):
    from flatquant_torch.kernels.kv_cache import (
        decode_attention_int4, decode_attention_ref)

    def plain(q, kp, kpar, vp, vpar, valid, sm):
        return decode_attention_ref(q, kp, kpar[..., :1], kpar[..., 1:], vp,
                                    vpar[..., :1], vpar[..., 1:], valid, sm)

    S, sm = 2048, 1.0 / math.sqrt(128)
    edges = span_edges()
    cases = [("B=1 MHA 32/32", 1, 32, 32, [S]),
             ("B=4 MHA 32/32 ragged", 4, 32, 32, [0, 700, 1500, S]),
             ("B=4 GQA 32/8 ragged", 4, 32, 8, [S, 0, 1023, 77]),
             ("B=4 MHA 32/32 main path", 4, 32, 32, main_valid),
             # Qwen-2.5-7B: 7 query heads per kv head
             ("B=1 GQA 28/4 (n_rep 7)", 1, 28, 4, [S]),
             ("B=4 GQA 28/4 (n_rep 7) ragged", 4, 28, 4, [S, 0, 1023, 77]),
             # the split's edges, and a slot of valid_len 0 beside them
             (f"B={len(edges) + 1} MHA 32/32 span edges", len(edges) + 1,
              32, 32, [0] + edges),
             (f"B={len(edges) + 1} GQA 28/4 (n_rep 7) span edges",
              len(edges) + 1, 28, 4, edges + [0])]
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
    """write_token bit for bit against its plain version (the masked
    select) at the decode's B = 4 and at B = 8 with positions S and -1,
    Qwen's B = 1 with 4 kv heads, and code rows of 36 bytes (the byte-wise
    path); the first three timed beside the plain version, the bound and
    the launch floor: a one-element in-place add under the same graph
    harness, which no kernel launched from a graph can beat."""
    from flatquant_torch.kernels.kv_cache import write_token, write_token_ref

    S, rows = 2048, []
    one = torch.zeros(1, device=dev)
    floor_ms = cuda_ms(torch, lambda t: t.add_(1), [(one,)], 200)
    log(f"  launch floor: one-element in-place torch add {floor_ms:.4f} ms "
        f"a launch (CUDA graph of 200)")
    for B, nkv, hdh, pos_l in (
            (8, 32, 64, [0, 5, 127, 128, 900, 2047, 2048, -1]),
            (4, 32, 64, [112, 100, 53, 111]), (1, 4, 64, [1500]),
            (3, 2, 36, [0, S - 1, S])):
        pos = torch.tensor(pos_l, device=dev, dtype=torch.int32)
        cache = [c[..., :hdh].contiguous() if c.dtype == torch.uint8 else c
                 for c in _rand_cache(torch, dev, gen, B, nkv, S)]
        copy = [c.clone() for c in cache]
        new = [(c[:, :, :1, :hdh] if c.dtype == torch.uint8
                else c[:, :, :1]).clone() + 1
               for c in _rand_cache(torch, dev, gen, B, nkv, 1)]
        write_token(*cache, new[0], new[1], new[2], new[3], pos)
        write_token_ref(*copy, new[0], new[1], new[2], new[3], pos)
        torch.cuda.synchronize()
        for a, b in zip(cache, copy):
            if not torch.equal(a, b):
                raise AssertionError(f"write_token B={B} nkv={nkv} "
                                     f"hdh={hdh}: not bit-exact")
        if hdh % 16:
            log(f"  write_token B={B} nkv={nkv} {hdh}-byte code rows (the "
                f"byte-wise path) pos={pos_l}: bit-exact")
            continue
        args = [(*cache, *new, pos)]
        ms = cuda_ms(torch, write_token, args, 200)
        plain_ms = cuda_ms(torch, write_token_ref, args, 10)
        hit = sum(0 <= p < S for p in pos_l)
        nbytes = 2 * hit * nkv * (hdh * 2 + 16) + 4 * B
        b_ms, b_by = bound_ms(nbytes, 0, INT8_OPS_PER_S)
        rows.append(dict(B=B, nkv=nkv, pos=pos_l, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, floor_ms=floor_ms,
                         max_abs_err=0.0))
        log(f"  write_token B={B} nkv={nkv} pos={pos_l}: bit-exact; "
            f"kernel_ms {ms:.4f} ({ms / floor_ms:.2f}x the launch floor) "
            f"plain_ms {plain_ms:.4f} (masked select streams the cache) "
            f"bound {b_ms * 1e3:.3f} us ({b_by}); library_ms none")
        del cache, copy
    results["write_token"] = dict(rows=rows, max_abs_err=0.0,
                                  floor_ms=floor_ms)


# ---------------------------------------------------------------------------
# phase 3d: the prefill kernels against their plain versions
# ---------------------------------------------------------------------------


def _factor(torch, dev, gen, n, mode):
    """Identity, or a random orthogonal [n, n] float32 factor."""
    if mode == "identity":
        return torch.eye(n, device=dev)
    qm, r = torch.linalg.qr(torch.randn((n, n), generator=gen, device=dev,
                                        dtype=torch.float64))
    return (qm * torch.sign(torch.diagonal(r))).float()


def _lac_clip(torch, dev):
    c = torch.tensor(1.0 / (1.0 + math.exp(-4.0)), device=dev)  # sigmoid(4)
    return (c, c)


def check_prefill_kernels(torch, dev, gen, results):
    """The four kernels of the fused prefill at the slice's shapes (B=4,
    S=512: T=2048 rows, llama-2-7b widths; the swiglu GEMM at every M of
    SWIGLU_SWEEP_M, T last), each held to its plain version
    with identity and with random orthogonal factors (tolerances in
    flatquant_torch/kernels/tolerance.py), then timed (orthogonal factors)
    beside its plain version, its bound and, where one PyTorch call
    computes the same function, that call."""
    from flatquant_torch.kernels import attn_prologue as ap
    from flatquant_torch.kernels import flat_pipeline as fp
    from flatquant_torch.kernels.int4_matmul import unpack_weight_planar
    from flatquant_torch.kernels.tolerance import (
        compare_bf16, compare_codes, compare_kv, compare_scales)
    from flatquant_torch.models.config import get_config
    from flatquant_torch.models.llama import rope_tables

    cfg = get_config("llama-2-7b")
    B, S, L = 4, 512, 1024
    T, H, I = B * S, cfg.hidden_size, cfg.intermediate_size
    nh, nkv = cfg.num_heads, cfg.num_kv_heads
    clip = _lac_clip(torch, dev)

    def timed(*a, **kw):
        _kernel_row(torch, results, *a, **kw)

    # rmsnorm_right_flat: x [T, H] bf16 (the slab in shared memory, two
    # blocks an SM); checked, not timed: T = 1, float32 x at T = 300 (the
    # slab, one block an SM) and at H = 8192 (x and w from device memory)
    for t, h, dt in ((1, H, torch.bfloat16), (300, H, torch.float32),
                     (40, 2 * H, torch.float32)):
        xe = (torch.randn((t, h), generator=gen, device=dev) * 2).to(dt)
        we = torch.rand((h,), generator=gen, device=dev) + 0.5
        for mode in ("identity", "orthogonal"):
            right = _factor(torch, dev, gen, 128, mode)
            compare_bf16(fp.rmsnorm_right_flat(xe, we, right, 1e-5),
                         fp.rmsnorm_right_flat_ref(xe, we, right, 1e-5),
                         mode, f"rmsnorm_right_flat T={t} H={h} {dt} "
                         f"({mode})")
        log(f"  rmsnorm_right_flat T={t} H={h} {dt}: identity and "
            f"orthogonal factors within tolerance")
    xs = [(torch.randn((T, H), generator=gen, device=dev) * 2).to(
        torch.bfloat16) for _ in range(copies_for(4 * T * H))]
    w = torch.rand((H,), generator=gen, device=dev) + 0.5
    for mode in ("identity", "orthogonal"):
        right = _factor(torch, dev, gen, 128, mode)
        err = compare_bf16(fp.rmsnorm_right_flat(xs[0], w, right, 1e-5),
                           fp.rmsnorm_right_flat_ref(xs[0], w, right, 1e-5),
                           mode, f"rmsnorm_right_flat ({mode})")
        log(f"  rmsnorm_right_flat T={T} H={H}, {mode} factors: within "
            f"tolerance, max abs err {err:.3e}")
    rb = right.to(torch.bfloat16)  # the factor as the bf16 model holds it
    timed("rmsnorm_right_flat", f"T={T} H={H}",
          lambda x: fp.rmsnorm_right_flat(x, w, rb, 1e-5),
          lambda x: fp.rmsnorm_right_flat_ref(x, w, rb, 1e-5),
          [(x,) for x in xs], 4 * T * H + 4 * H + 2 * 128 * 128,
          2 * T * H * 128, BF16_FLOPS_PER_S, err)
    del xs

    # left_quant_i8_flat: ln1/ln2/o at K=4096 (G=32), down at K=11008 (G=86)
    for k in (H, I):
        g = k // 128
        xs = [(torch.randn((T, k), generator=gen, device=dev) * 3).to(
            torch.bfloat16) for _ in range(copies_for(3 * T * k))]
        for mode in ("identity", "orthogonal"):
            lt = _factor(torch, dev, gen, g, mode)
            q, s = fp.left_quant_i8_flat(lt, xs[0], clip)
            q_ref, s_ref = fp.left_quant_i8_flat_ref(lt, xs[0], clip)
            compare_codes(q, q_ref, mode, f"left_quant_i8_flat K={k} codes")
            err = compare_scales(s, s_ref, mode,
                                 f"left_quant_i8_flat K={k} scales")
            log(f"  left_quant_i8_flat T={T} K={k} (G={g}), {mode} factors: "
                f"codes and scales within tolerance"
                f"{' (bit-exact)' if mode == 'identity' else ''}")
        timed("left_quant_i8_flat", f"T={T} K={k} (G={g})",
              lambda x: fp.left_quant_i8_flat(lt, x, clip),
              lambda x: fp.left_quant_i8_flat_ref(lt, x, clip),
              [(x,) for x in xs], 3 * T * k + 4 * T + 2 * g * g + 8,
              2 * T * k * g, BF16_FLOPS_PER_S, err)
        del xs

    # w4a4_matmul_i8_swiglu_right: x int8 [M, H], w [2I, H/2], at every M
    # of SWIGLU_SWEEP_M (the 4 x 512 prefill's T = 2048 last)
    ws = [(torch.randint(0, 256, (2 * I, H // 2), generator=gen, device=dev,
                         dtype=torch.uint8),
           torch.rand((2 * I,), generator=gen, device=dev) * 0.01 + 1e-4)
          for _ in range(copies_for(I * H))]
    for m in SWIGLU_SWEEP_M:
        xq = torch.randint(-8, 8, (m, H), generator=gen, device=dev,
                           dtype=torch.int8)
        sx = torch.rand((m, 1), generator=gen, device=dev) * 0.1 + 1e-3
        for mode in ("identity", "orthogonal"):
            right = _factor(torch, dev, gen, 128, mode)
            err = compare_bf16(
                fp.w4a4_matmul_i8_swiglu_right(xq, sx, *ws[0], right),
                fp.w4a4_matmul_i8_swiglu_right_ref(xq, sx, *ws[0], right),
                mode, f"w4a4_matmul_i8_swiglu_right M={m} ({mode})")
        log(f"  w4a4_matmul_i8_swiglu_right M={m} K={H} N=2x{I}: identity "
            f"and orthogonal factors within tolerance")
        # yardstick: cuBLAS int8 GEMM of the merged up||gate on
        # pre-unpacked int8 weights (twice the weight bytes, no epilogue)
        w8 = [(xq, unpack_weight_planar(wp).t()) for wp, _ in ws[:2]]
        timed("w4a4_matmul_i8_swiglu_right", f"M={m} K={H} N=2x{I}",
              lambda wp, sw: fp.w4a4_matmul_i8_swiglu_right(xq, sx, wp, sw,
                                                            right),
              lambda wp, sw: fp.w4a4_matmul_i8_swiglu_right_ref(
                  xq, sx, wp, sw, right),
              ws, m * H + I * H + 4 * m + 8 * I + 2 * 128 * 128 + 2 * m * I,
              2 * m * 2 * I * H + 2 * m * I * 128, INT8_OPS_PER_S, err,
              lib=(torch._int_mm, w8, "torch._int_mm, int8 weights, GEMM "
                   "only"), m=m)
        del w8
    del ws

    # attn_prologue at PROLOGUE_SHAPES: qkv [B, S, (nh + 2 nkv) * 128]
    # bf16, each body of PROLOGUE_BODIES (the routed one for bf16, the
    # CUDA-core one for float32 qkv); both modes; then timed
    for B, S in PROLOGUE_SHAPES:
        check_prologue(torch, dev, gen, results, cfg, B, S, nh, nkv, clip)


def check_prologue(torch, dev, gen, results, cfg, B, S, nh, nkv, clip):
    """attn_prologue in each body against its plain version at one shape,
    identity and orthogonal factors; float32 qkv on the CUDA-core body;
    timed in each body with orthogonal factors (the row's ms is the routed
    body's)."""
    from flatquant_torch.kernels import attn_prologue as ap
    from flatquant_torch.kernels.tolerance import compare_bf16, compare_kv
    from flatquant_torch.models.llama import rope_tables

    D = (nh + 2 * nkv) * 128
    label = f"B={B} S={S} {nh}/{nkv} heads"
    qkvs = [(torch.randn((B, S, D), generator=gen, device=dev) * 2).to(
        torch.bfloat16) for _ in range(copies_for(2 * B * S * D))]
    cos, sin = rope_tables(cfg, torch.arange(S, device=dev))

    def new_cache():
        return [torch.zeros((B, nkv, S, 64), dtype=torch.uint8, device=dev),
                torch.zeros((B, nkv, S, 2), device=dev),
                torch.zeros((B, nkv, S, 64), dtype=torch.uint8, device=dev),
                torch.zeros((B, nkv, S, 2), device=dev)]

    err = 0.0
    for body in PROLOGUE_BODIES:
        for mode in ("identity", "orthogonal"):
            kt = _factor(torch, dev, gen, 128, mode)
            kti = _factor(torch, dev, gen, 128, mode)
            c, c_ref = new_cache(), new_cache()
            with patched([(ap, "prologue_body", lambda dt, b=body: b)]):
                got = ap.attn_prologue(qkvs[0], cos, sin, kt, kti, clip,
                                       clip, nh=nh, nkv=nkv, cache=c)
            want = ap.attn_prologue_ref(qkvs[0], cos, sin, kt, kti, clip,
                                        clip, nh=nh, nkv=nkv, cache=c_ref)
            what = f"attn_prologue {label} ({body}, {mode})"
            e = max(compare_bf16(got[0], want[0], mode, f"{what} q_rot"),
                    compare_bf16(got[1], want[1], mode, f"{what} k_rot"))
            if mode == "identity" and not (torch.equal(got[0], want[0])
                                           and torch.equal(got[1], want[1])):
                raise AssertionError(f"{what}: q_rot / k_rot not bit-exact")
            if not torch.equal(got[2], want[2]):
                raise AssertionError(f"{what}: v must pass through")
            compare_kv(c[0], c[1], c_ref[0], c_ref[1], mode, f"{what} K")
            compare_kv(c[2], c[3], c_ref[2], c_ref[3], "identity",
                       f"{what} V")  # quantized from the raw qkv: exact
            err = max(err, e)
            log(f"  {what}: K codes/params within tolerance"
                f"{' (bit-exact)' if mode == 'identity' else ''}, V "
                f"bit-exact, q/k max abs err {e:.3e}")
    # float32 qkv takes the CUDA-core body
    q32 = qkvs[0].float()
    c, c_ref = new_cache(), new_cache()
    got = ap.attn_prologue(q32, cos, sin, kt, kti, clip, clip, nh=nh,
                           nkv=nkv, cache=c)
    want = ap.attn_prologue_ref(q32, cos, sin, kt, kti, clip, clip, nh=nh,
                                nkv=nkv, cache=c_ref)
    for i in (0, 1):  # float32 sums of 128 products in another order
        torch.testing.assert_close(got[i], want[i], rtol=1e-5, atol=1e-5)
    compare_kv(c[2], c[3], c_ref[2], c_ref[3], "identity",
               "attn_prologue float32 V")
    caches = [new_cache() for _ in qkvs]
    # qkv read; q_rot, k_rot written (v is a view); K/V codes and params;
    # cos/sin and k_t/k_t_inv in bf16; the clips
    nbytes = (2 * B * S * D + 2 * B * S * (nh + nkv) * 128
              + 2 * B * nkv * S * (64 + 8) + 4 * S * 128 + 4 * 128 * 128 + 16)
    flops = 2 * B * S * (nh + nkv) * 128 * 128
    row = dict(case=label, B=B, S=S, nh=nh, nkv=nkv,
               body=ap.prologue_body(torch.bfloat16), max_abs_err=err,
               bytes=nbytes, ops=flops, library_ms=None)
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops,
                                                BF16_FLOPS_PER_S)

    def call(fn):
        return lambda qkv, cc: fn(qkv, cos, sin, kt, kti, clip, clip, nh=nh,
                                  nkv=nkv, cache=cc)

    for body in PROLOGUE_BODIES:
        with patched([(ap, "prologue_body", lambda dt, b=body: b)]):
            row[f"{body}_ms"] = cuda_ms(torch, call(ap.attn_prologue),
                                        list(zip(qkvs, caches)), 40)
    row["ms"] = row[f"{row['body']}_ms"]
    row["plain_ms"] = cuda_ms(torch, call(ap.attn_prologue_ref),
                              list(zip(qkvs, caches)), 4)
    r = results.setdefault("attn_prologue", dict(rows=[], max_abs_err=0.0))
    r["rows"].append(row)
    r["max_abs_err"] = max(r["max_abs_err"], err)
    log(f"  attn_prologue {label}: kernel_ms "
        + " ".join(f"{b} {row[f'{b}_ms']:.4f}" for b in PROLOGUE_BODIES)
        + f" (routed: {row['body']}) plain_ms {row['plain_ms']:.4f} bound "
        f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}: "
        f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.1f} GFLOP) library_ms none")
    if min(row[f"{b}_ms"] for b in PROLOGUE_BODIES) * (1 + ROUTE_MARGIN) \
            < row["ms"]:
        raise AssertionError(f"attn_prologue {label}: prologue_body routes "
                             f"bf16 qkv to a slower body")
    del qkvs, caches


# ---------------------------------------------------------------------------
# phase 3e: flash prefill attention, both entry points
# ---------------------------------------------------------------------------


def _sdpa(torch):
    """One PyTorch call computing the flash kernels' function on the same
    tensors (the yardstick of library_ms; the port never calls it):
    causal scaled_dot_product_attention on [B, h, S, hd] views (GQA
    through enable_gqa)."""
    F = torch.nn.functional

    def call(q, k, v, sm):
        kw = {} if k.shape[2] == q.shape[2] else {"enable_gqa": True}
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, scale=sm, **kw)

    return call


def check_flash(torch, dev, gen, results):
    """flash_prefill_attention_kt and flash_prefill_attention against their
    plain versions over FLASH_SWEEP (B=1; S = 1024, 2048, 4096; llama-2-7b's
    32/32 heads, llama-3-8b's 32/8, Qwen-2.5-7B's 28/4; and S = 1152, an
    odd number of query tiles, at 32/32), within the "flash"
    tolerance of flatquant_torch/kernels/tolerance.py (the kernel's key
    tiles round p at other running maxima than the plain version's 512-key
    blocks). The kt entry point reads K through the strided [B, nkv, hd, S]
    view of a token-major tensor, as the fused route passes it; JAX's
    contiguous kt layout (copied by the wrapper) is checked at the first
    shape. Each is timed at every shape beside its plain version, the
    bound and the causal SDPA call on the same tensors."""
    from flatquant_torch.kernels import prefill_attention as pa
    from flatquant_torch.kernels.tolerance import compare_bf16

    entries = {
        "flash_prefill_attention_kt": (
            pa.flash_prefill_attention_kt, pa.flash_prefill_attention_kt_ref,
            lambda q, k, v: (q, k.permute(0, 2, 3, 1), v)),
        "flash_prefill_attention": (
            pa.flash_prefill_attention, pa.flash_prefill_attention_ref,
            lambda q, k, v: (q, k, v)),
    }
    sm = 1.0 / math.sqrt(128)
    sdpa = _sdpa(torch)
    B = 1
    for n, (S, nh, nkv) in enumerate(FLASH_SWEEP):
        label = f"B={B} S={S} {nh}/{nkv} heads"
        # q, k, v read once and o written once, bf16
        nbytes = 2 * B * S * 128 * (2 * nh + 2 * nkv)
        flops = 2 * S * (S + 1) * 128 * nh * B
        sets = [[(torch.randn((B, S, h, 128), generator=gen, device=dev)
                  ).to(torch.bfloat16) for h in (nh, nkv, nkv)]
                for _ in range(copies_for(nbytes))]
        b_ms, b_by = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
        lib_ms = cuda_ms(torch, sdpa, [(*t, sm) for t in sets], 20)
        for name, (kernel, plain, layout) in entries.items():
            args = [(*layout(*t), sm) for t in sets]
            want = plain(*args[0])
            err = compare_bf16(kernel(*args[0]), want, "flash",
                               f"{name} {label}")
            if name.endswith("_kt") and n == 0:
                q, kt, v, _ = args[0]
                compare_bf16(kernel(q, kt.contiguous(), v, sm), want,
                             "flash", f"{name} {label}, contiguous kt")
            r = results.setdefault(name, dict(rows=[], max_abs_err=0.0))
            r["max_abs_err"] = max(r["max_abs_err"], err)
            ms = cuda_ms(torch, kernel, args, 20)
            plain_ms = cuda_ms(torch, plain, args, 2)
            r["rows"].append(dict(case=label, B=B, S=S, nh=nh, nkv=nkv,
                                  ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by, library_ms=lib_ms,
                                  bytes=nbytes, ops=flops, max_abs_err=err))
            log(f"  {name} {label}: within the 'flash' tolerance, max abs "
                f"err {err:.3e}; kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
                f"bound {b_ms * 1e3:.2f} us ({b_by}: {nbytes / 1e6:.1f} MB, "
                f"{flops / 1e9:.1f} GFLOP) library_ms {lib_ms:.4f} (causal "
                f"SDPA)")
        del sets


# ---------------------------------------------------------------------------
# phase 3f: chunk attention and the paged attention kernels
# ---------------------------------------------------------------------------


def _slot_view(torch, kp, kpar, vp, vpar, tbl):
    """The pool gathered slot-major through tbl, contiguous (the slot
    kernels' input)."""
    from flatquant_torch.kernels.paged_kv import gather_kv_paged

    kc, kpr = gather_kv_paged(kp, kpar, tbl)
    vc, vpr = gather_kv_paged(vp, vpar, tbl)
    return tuple(t.contiguous() for t in (kc, kpr, vc, vpr))


def _paged_pool(torch, dev, gen, B, nkv, mb, bs):
    """A random pool of 1 + B*mb blocks with a shuffled block table, and
    the same cache gathered slot-major (the slot kernels' input)."""
    pool = _rand_cache(torch, dev, gen, 1 + B * mb, nkv, bs)
    perm = torch.randperm(B * mb, generator=gen, device=dev) + 1
    tbl = perm.reshape(B, mb).to(torch.int32)
    return pool, tbl, _slot_view(torch, *pool, tbl)


def check_chunk_paged(torch, dev, gen, results):
    """Rows 9-11 against their plain versions at llama-2-7b widths (MHA
    32/32) and llama-3-8b's GQA 32/8, bf16 queries, within ATTN_TOL, and
    each paged kernel bit for bit against its slot twin on the gathered
    cache (one body: the property that makes paged serving equal the slot
    cache's): chunk_attention_int4 at Sq=256, pos 0, 768 and 1792 over
    S=2048; paged_decode_attention_int4 at B=4 over valid lengths 1, 255,
    256, 1000 and 2048, and at B=8 over the decode body's span edges and
    0, block 256, shuffled tables;
    paged_chunk_attention_int4 with the chunk straddling a block edge.
    Each timed like phase 3b beside its plain version and its bound
    (cache bytes, or operations: the chunk kernels' at the tensor cores'
    bf16 rate, the decode kernel's at the CUDA cores' float32 rate)."""
    log(f"  (tolerance rtol/atol {ATTN_TOL['rtol']}; each paged launch also "
        f"bit-equal to its slot twin)")
    from flatquant_torch.kernels import kv_cache as kv
    from flatquant_torch.kernels import paged_kv as pk

    S, SQ, BS, sm = 2048, 256, 256, 1.0 / math.sqrt(128)
    # llama-2-7b, llama-3-8b and Qwen-2.5-7B (n_rep 7) heads
    heads = [("MHA 32/32", 32, 32), ("GQA 32/8", 32, 8),
             ("GQA 28/4", 28, 4)]

    def record(name, label, kernel, plain, args, nbytes, flops, err, **kw):
        rate = (F32_FLOPS_PER_S if name == "paged_decode_attention_int4"
                else BF16_FLOPS_PER_S)
        _kernel_row(torch, results, name, label, kernel, plain, args, nbytes,
                    flops, rate, err, **kw)

    def held(got, want):
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL)
        return (got.float() - want.float()).abs().max().item()

    def chunk_work(pos_l, nh, nkv, sq, kv_tokens):
        # q read and output written in bf16; K/V codes and params of the
        # keys the rows see; 4 flops per (row, key, dim): QK and PV
        nbytes = 2 * 2 * len(pos_l) * sq * nh * 128 + kv_tokens * nkv * 144
        pairs = sum(sq * (p + 1) + sq * (sq - 1) // 2 for p in pos_l)
        return nbytes, 4 * 128 * nh * pairs

    # chunk_attention_int4: B=1 (the batcher's chunk), S=2048
    for hlabel, nh, nkv in heads:
        for pos_v in (0, 768, 1792):
            full = nkv * S * 144
            caches = [_rand_cache(torch, dev, gen, 1, nkv, S)
                      for _ in range(copies_for(full))]
            q = torch.randn((1, SQ, nh, 128), generator=gen,
                            device=dev).to(torch.bfloat16)
            pos = torch.tensor([pos_v], device=dev, dtype=torch.int32)
            err = held(kv.chunk_attention_int4(q, *caches[0], pos, sm),
                       kv.chunk_attention_ref(q, *caches[0], pos, sm))
            nbytes, flops = chunk_work([pos_v], nh, nkv, SQ, pos_v + SQ)
            record("chunk_attention_int4",
                   f"B=1 Sq={SQ} {hlabel} pos={pos_v} S={S}",
                   kv.chunk_attention_int4, kv.chunk_attention_ref,
                   [(q, *c, pos, sm) for c in caches], nbytes, flops, err,
                   pos=pos_v, nh=nh, nkv=nkv)
            del caches

    # paged_decode_attention_int4: B=4, block 256, shuffled tables
    mb = S // BS
    edges = span_edges()
    cases = [("MHA 32/32", 32, 32, [1, 255, 256, 1000]),
             ("MHA 32/32", 32, 32, [2048, 1000, 256, 1]),
             ("GQA 32/8", 32, 8, [2048, 255, 1000, 1]),
             ("GQA 28/4", 28, 4, [2048, 255, 1000, 1]),
             # the decode body's span edges (and a slot of valid_len 0)
             ("MHA 32/32", 32, 32, [0] + edges),
             ("GQA 28/4", 28, 4, edges + [0])]
    for hlabel, nh, nkv, valid_l in cases:
        B = len(valid_l)
        full = (1 + B * mb) * nkv * BS * 144
        states = [_paged_pool(torch, dev, gen, B, nkv, mb, BS)
                  for _ in range(copies_for(full))]
        q = torch.randn((B, nh, 128), generator=gen, device=dev).to(
            torch.bfloat16)
        valid = torch.tensor(valid_l, device=dev, dtype=torch.int32)
        pool, tbl, slot = states[0]
        got = pk.paged_decode_attention_int4(q, *pool, tbl, valid, sm)
        err = held(got, pk.paged_decode_attention_ref(q, *pool, tbl, valid,
                                                      sm))
        if not torch.equal(got, kv.decode_attention_int4(q, *slot, valid,
                                                         sm)):
            raise AssertionError("paged decode differs from the slot kernel")
        if not bool((got[valid == 0] == 0).all()):
            raise AssertionError("paged decode: valid_len 0 must give 0")
        tokens = sum(valid_l)
        nbytes = tokens * nkv * 144 + 2 * 2 * B * nh * 128 + 4 * B * (mb + 1)
        record("paged_decode_attention_int4",
               f"B={B} {hlabel} valid={valid_l} block {BS}",
               pk.paged_decode_attention_int4, pk.paged_decode_attention_ref,
               [(q, *pl, t, valid, sm) for pl, t, _ in states], nbytes,
               tokens * nh * 128 * 4, err, valid=valid_l, nh=nh, nkv=nkv)
        del states

    # paged_chunk_attention_int4: B=1, the chunk straddling a block edge
    for hlabel, nh, nkv in heads:
        for pos_v in (640, 1000):
            full = (1 + mb) * nkv * BS * 144
            states = [_paged_pool(torch, dev, gen, 1, nkv, mb, BS)
                      for _ in range(copies_for(full))]
            q = torch.randn((1, SQ, nh, 128), generator=gen,
                            device=dev).to(torch.bfloat16)
            pos = torch.tensor([pos_v], device=dev, dtype=torch.int32)
            pool, tbl, slot = states[0]
            got = pk.paged_chunk_attention_int4(q, *pool, tbl, pos, sm)
            err = held(got, pk.paged_chunk_attention_ref(q, *pool, tbl, pos,
                                                         sm))
            if not torch.equal(got, kv.chunk_attention_int4(q, *slot, pos,
                                                            sm)):
                raise AssertionError("paged chunk differs from the slot "
                                     "kernel")
            nbytes, flops = chunk_work([pos_v], nh, nkv, SQ, pos_v + SQ)
            record("paged_chunk_attention_int4",
                   f"B=1 Sq={SQ} {hlabel} pos={pos_v} block {BS}",
                   pk.paged_chunk_attention_int4,
                   pk.paged_chunk_attention_ref,
                   [(q, *pl, t, pos, sm) for pl, t, _ in states], nbytes,
                   flops, err, pos=pos_v, nh=nh, nkv=nkv)
            del states


# ---------------------------------------------------------------------------
# phase 3g: rows 12-14, the balanced split's and weight-only serving's
# ---------------------------------------------------------------------------


def _kernel_row(torch, results, name, label, kernel, plain, args, nbytes,
                ops, rate, err, lib=None, iters=40, **kw):
    """Time kernel and plain version on the same argument sets (CUDA graph
    of `iters` launches, cycling through copies above the L2 size), the
    bound and, where given, the library call [fn, arg sets, label]; record
    and print one row of `name`."""
    ms = cuda_ms(torch, kernel, args, iters)
    plain_ms = cuda_ms(torch, plain, args, 4)
    lib_ms = None if lib is None else cuda_ms(torch, lib[0], lib[1], 20)
    b_ms, b_by = bound_ms(nbytes, ops, rate)
    r = results.setdefault(name, dict(rows=[], max_abs_err=0.0))
    r["rows"].append(dict(case=label, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=lib_ms, bytes=nbytes,
                          ops=ops, max_abs_err=err, **kw))
    r["max_abs_err"] = max(r["max_abs_err"], err)
    lib_s = "none" if lib_ms is None else f"{lib_ms:.4f} ({lib[2]})"
    log(f"  {name} {label}: max abs err {err:.3e}; kernel_ms {ms:.4f} "
        f"plain_ms {plain_ms:.4f} bound {b_ms * 1e3:.2f} us ({b_by}: "
        f"{nbytes / 1e6:.1f} MB, {ops / 1e9:.1f} G ops) library_ms {lib_s}")


def check_quant_mode_kernels(torch, dev, gen, results):
    """Rows 12-14 against their plain versions at the main paths' shapes,
    then timed beside the bound and a library yardstick the port never
    calls: quant_acts_i8 at Qwen-2.5-7B's down input [2048, 18944] bf16
    with LAC clips and q_max 7, and at [256, 8192] with q_max 127 and a
    zero row, codes and scales bit for bit (library: none);
    w4a4_matmul_i8_swiglu at Qwen-2.5-7B's MLP (M=2048, K=3584, NH=18944)
    within the "identity" tolerance of flatquant_torch/kernels/tolerance.py
    (exact integer sums, the float32 epilogue's exp against torch.exp;
    library: torch._int_mm of the GEMM part on pre-unpacked int8 weights);
    w4a8_matmul's bodies swept over M (check_w4a8)."""
    from flatquant_torch.kernels import int4_matmul as im
    from flatquant_torch.kernels.tolerance import compare_bf16
    from flatquant_torch.models.config import get_config

    # row 12
    clip = _lac_clip(torch, dev)
    for M, K, q_max, c in ((2048, 18944, 7, clip), (256, 8192, 127, None)):
        xs = [(torch.randn((M, K), generator=gen, device=dev) * 3).to(
            torch.bfloat16) for _ in range(copies_for(3 * M * K))]
        xs[0][1] = 0  # a zero row: scale 1, codes 0
        q, sc = im.quant_acts_i8(xs[0], c, q_max)
        q_ref, sc_ref = im.quant_acts_i8_ref(xs[0], c, q_max)
        torch.cuda.synchronize()
        if not (torch.equal(q, q_ref) and torch.equal(sc, sc_ref)):
            raise AssertionError(f"quant_acts_i8 [{M}, {K}] q_max {q_max}: "
                                 "codes or scales not bit-exact")
        _kernel_row(torch, results, "quant_acts_i8",
                    f"[{M}, {K}] bf16 q_max {q_max}"
                    f"{', LAC clips' if c else ', a zero row'}",
                    lambda x: im.quant_acts_i8(x, c, q_max),
                    lambda x: im.quant_acts_i8_ref(x, c, q_max),
                    [(x,) for x in xs], 3 * M * K + 4 * M + 8, 4 * M * K,
                    F32_FLOPS_PER_S, 0.0)
        log(f"    quant_acts_i8 [{M}, {K}]: codes and scales bit-exact")
        del xs

    # row 13, at every M of SWIGLU_SWEEP_M (Qwen's 1 x 2048 prefill last)
    qcfg = get_config("qwen-2.5-7b")
    K, NH = qcfg.hidden_size, qcfg.intermediate_size
    ws = [(torch.randint(0, 256, (2 * NH, K // 2), generator=gen, device=dev,
                         dtype=torch.uint8),
           torch.rand((2 * NH,), generator=gen, device=dev) * 0.01 + 1e-4)
          for _ in range(copies_for(NH * K))]
    for M in SWIGLU_SWEEP_M:
        xq = torch.randint(-8, 8, (M, K), generator=gen, device=dev,
                           dtype=torch.int8)
        sx = torch.rand((M, 1), generator=gen, device=dev) * 0.1 + 1e-3
        err = compare_bf16(im.w4a4_matmul_i8_swiglu(xq, sx, *ws[0]),
                           im.w4a4_matmul_i8_swiglu_ref(xq, sx, *ws[0]),
                           "identity", f"w4a4_matmul_i8_swiglu M={M}")
        w8 = [(xq, im.unpack_weight_planar(wp).t()) for wp, _ in ws[:2]]
        _kernel_row(torch, results, "w4a4_matmul_i8_swiglu",
                    f"M={M} K={K} N=2x{NH} (Qwen-2.5-7B MLP)",
                    lambda wp, sw: im.w4a4_matmul_i8_swiglu(xq, sx, wp, sw),
                    lambda wp, sw: im.w4a4_matmul_i8_swiglu_ref(xq, sx, wp,
                                                                sw),
                    ws, M * K + NH * K + 4 * M + 8 * NH + 2 * M * NH,
                    2 * M * 2 * NH * K, INT8_OPS_PER_S, err, iters=20,
                    lib=(torch._int_mm, w8, "torch._int_mm, int8 weights, "
                         "GEMM only"), m=M)
        del w8
    del ws, xq

    # row 14: its bodies swept over W4A8_SWEEP_M
    check_w4a8(torch, dev, gen, results)


def _w4a8_bodies_at(im, m):
    """The bodies of row 14 that phase 3g times at M rows: the weight
    stream up to W4A8_STREAM_SWEEP_MAX_M, the tiles everywhere."""
    return [b for b in im.W4A8_BODIES
            if b != "stream" or m <= W4A8_STREAM_SWEEP_MAX_M]


def check_w4a8(torch, dev, gen, results):
    """Row 14's bodies (w4a8_matmul: the weight stream, the wgmma tile) at
    every M of W4A8_SWEEP_M
    on llama-2-7b's four W4A16 linears, bf16 activations: each forced body
    held to w4a8_matmul_rowsum_ref within the "identity" tolerance and
    timed beside the bound, the plain version and torch.matmul on
    pre-dequantized bf16 weights (a yardstick the port never calls); the
    phase fails where another body beat the routed one by more than
    ROUTE_MARGIN. Then W4A8_EDGES, every body, both output types, checked
    and not timed."""
    from flatquant_torch.kernels import int4_matmul as im
    from flatquant_torch.kernels.tolerance import compare_bf16
    from flatquant_torch.models.config import get_config

    lcfg = get_config("llama-2-7b")
    H, I = lcfg.hidden_size, lcfg.intermediate_size
    shapes = {"qkv": (3 * H, H), "o": (H, H), "upgate": (2 * I, H),
              "down": (H, I)}
    rows, worst = [], 0.0
    for m in W4A8_SWEEP_M:
        for proj, (n, k) in shapes.items():
            wbytes = n * k // 2
            ws = _rand_weights(torch, dev, gen, n, k)
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16)
            ones = torch.ones((m, 1), device=dev)
            want = im.w4a8_matmul_rowsum_ref(x, ones, *ws[0])
            ms, err = {}, 0.0

            def fn(wp, sw):
                return im.w4a8_matmul(x, ones, wp, sw)

            for body in _w4a8_bodies_at(im, m):
                with patched([(im, "w4a8_body", lambda m_, n_: body)]):
                    err = max(err, compare_bf16(
                        fn(*ws[0]), want, "identity",
                        f"w4a8_matmul {body} M={m} {proj}"))
                    ms[body] = sweep_ms(torch, fn, ws)
            routed = im.w4a8_body(m, n)
            plain = cuda_ms(torch, lambda wp, sw: im.w4a8_matmul_rowsum_ref(
                x, ones, wp, sw), ws, 6 if m <= 256 else 3)
            wd = [(x, (im.unpack_weight_planar(wp).float() * sw[:, None])
                   .to(torch.bfloat16).t()) for wp, sw in ws[:2]]
            lib = sweep_ms(torch, torch.matmul, wd)
            nbytes = 2 * m * k + wbytes + 4 * m + 4 * n + 2 * m * n
            b_ms, b_by = bound_ms(nbytes, 2 * m * n * k, BF16_FLOPS_PER_S)
            worst = max(worst, err)
            rows.append(dict(
                case=f"M={m} {proj} {n}x{k} (llama-2-7b W4A16)", m=m,
                proj=proj, n=n, k=k, body=routed, ms=ms[routed],
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib, bytes=nbytes, ops=2 * m * n * k,
                max_abs_err=err, **{f"{b}_ms": ms[b] for b in ms}))
            log(f"  w4a8_matmul M={m:4d} {proj:6s} {n}x{k}: bodies within "
                f"'identity' (max abs err {err:.3e}); "
                + " ".join(f"{b}_ms {t:.4f}" for b, t in ms.items())
                + f" (route: {routed}) plain_ms {plain:.4f} bound "
                f"{b_ms * 1e3:.2f} us ({b_by}) library_ms(torch.matmul, "
                f"bf16 weights) {lib:.4f}")
            del ws, wd
    for m in W4A8_SWEEP_M:
        at = [r for r in rows if r["m"] == m]
        log(f"  w4a8_matmul M={m}, one layer's four linears: " + " ".join(
            f"{b}_ms {sum(r[f'{b}_ms'] for r in at):.4f}"
            for b in _w4a8_bodies_at(im, m))
            + f" bound {sum(r['bound_ms'] for r in at):.4f} library_ms "
            f"{sum(r['library_ms'] for r in at):.4f}")
    wrong = []
    for r in rows:
        timed = [b for b in im.W4A8_BODIES if f"{b}_ms" in r]
        best = min(timed, key=lambda b: r[f"{b}_ms"])
        if r[f"{best}_ms"] * (1 + ROUTE_MARGIN) < r["ms"]:
            wrong.append((r["m"], r["proj"], r["body"], best))
    for m, n, k in W4A8_EDGES:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        xs = torch.rand((m, 1), generator=gen, device=dev) + 0.5
        wp, sw = _rand_weights(torch, dev, gen, n, k, 1)[0]
        for out in (torch.bfloat16, torch.float32):
            want = im.w4a8_matmul_rowsum_ref(x, xs, wp, sw, out)
            for body in im.W4A8_BODIES:
                with patched([(im, "w4a8_body", lambda m_, n_: body)]):
                    got = im.w4a8_matmul(x, xs, wp, sw, out)
                if out == torch.bfloat16:
                    compare_bf16(got, want, "identity",
                                 f"w4a8_matmul {body} M={m} N={n} K={k}")
                else:
                    scale = want.abs().amax(dim=-1, keepdim=True)
                    if not ((got - want).abs() <= 1e-5 * scale).all():
                        raise AssertionError(
                            f"w4a8_matmul {body} M={m} N={n} K={k} f32: "
                            "beyond 1e-5 of its row's largest value")
        log(f"  w4a8_matmul M={m} N={n} K={k}: every body within tolerance "
            f"in bf16 and f32")
    results["w4a8_matmul"] = dict(rows=rows, max_abs_err=worst)
    if wrong:
        raise AssertionError(f"w4a8_matmul: another body beat the routed "
                             f"one by more than {ROUTE_MARGIN:.0%} at (M, "
                             f"shape, routed, faster) {wrong}")


# ---------------------------------------------------------------------------
# phase 3h: row 16 (fp8_matmul) and row 1 at DeepSeek-V2-Lite's shapes
# ---------------------------------------------------------------------------


def _fp8_weights(torch, dev, gen, shape, copies):
    """`copies` random e4m3 weights [..., N, K] with their expanded
    128-block scales: N(0, 0.05^2) values packed by fp8_block_quantize."""
    from flatquant_torch.kernels import fp8_matmul as f8

    out = []
    for _ in range(copies):
        w = torch.randn(shape, generator=gen, device=dev) * 0.05
        lin = f8.prep_fp8_weight(w)
        out.append((lin["w8"], lin["se"]))
        del w
    return out


def _dequant_bf16(torch, w8, se):
    """w8 * blockscale in bf16, transposed [..., K, N] (the yardstick's
    pre-dequantized weights)."""
    b = w8.shape[-1] // se.shape[-2]
    s = se.repeat_interleave(b, dim=-2)  # [..., K, N]
    return (w8.float().transpose(-1, -2) * s).to(torch.bfloat16)


def check_fp8_kernels(torch, dev, gen, results):
    """Row 16 (fp8_matmul) against fp8_matmul_ref on the card, each of its
    three bodies (n8, n64, n128) at every case: all 254 non-NaN e4m3 codes
    through an identity x in both decodes (bit for bit: exact decodes
    every code to its IEEE value, FTZ zeroes only the subnormal codes);
    DeepSeek-V2-Lite's fp8 linears, bf16 in and out, within the
    "identity" tolerance (one bf16 ulp: the float32 sums run in another
    order; kernels/tolerance.py): wq and wo at M = 1, 4, 64 and 2048, the
    shared experts at M = 1 and 2048, the expert-batched e_w1/e_w3/e_w2
    over all 64 experts at M = 1 and 4 (dense-masked decode, one x shared
    by every expert) and M = 384 (the gather capacity of a 2048-token
    prefill), and DeepSeek-V3's wkv_a (N = 576, K = 7168, 128-block
    scales) through fp8_linear, which hands the kernel N = 576 unpadded;
    each body timed beside the bound and torch.matmul on pre-dequantized
    bf16 weights (a yardstick the port never calls); the phase fails where
    another body beat the routed one by more than ROUTE_MARGIN. Then row
    1 (w4a4_matmul_i8), both bodies bit for bit,
    at the packed W4A4 form's shapes llama-2-7b lacks: the dense w2 (K =
    10944, K/2 not a multiple of 64), the shared s_w2 (K = 2816) and
    wkv_a (N = 576, 64 mod 128), at M = 1, 300 and 2048."""
    from flatquant_torch.kernels import fp8_matmul as f8
    from flatquant_torch.kernels import int4_matmul as im
    from flatquant_torch.kernels.tolerance import compare_bf16
    from flatquant_torch.models.deepseek import DEEPSEEK_V3, DeepSeekConfig

    # every code through an identity x
    codes = torch.arange(256, device=dev, dtype=torch.int32).repeat(64)
    codes = codes.reshape(128, 128).to(torch.uint8)
    codes[(codes & 0x7F) == 0x7F] = 0  # the two NaN codes
    w8 = codes.view(torch.float8_e4m3fn)
    eye = torch.eye(128, device=dev).to(torch.bfloat16)
    ones = torch.ones((1, 128), device=dev)
    ieee = w8.float().t()
    sub = ((codes & 0x7F) > 0) & ((codes & 0x7F) < 8)
    for body, exact in ((b, e) for b in f8.BODY_NAMES for e in (True, False)):
        with forced_fp8(body):
            got = f8.fp8_matmul(eye, w8, ones, torch.float32, exact)
        want = f8.fp8_matmul_ref(eye, w8, ones, torch.float32, exact)
        flush = torch.where(sub.t(), torch.zeros_like(ieee), ieee)
        if not (torch.equal(got, want)
                and torch.equal(got, ieee if exact else flush)):
            raise AssertionError(f"fp8_matmul {body} exact={exact}: the "
                                 "decode of the 254 codes is not bit-exact")
    log(f"  fp8_matmul: all 254 non-NaN codes decode bit-exact in every "
        f"body {f8.BODY_NAMES}, exact and FTZ (FTZ zeroes exactly the 14 "
        "subnormal codes)")

    cfg = DeepSeekConfig()
    D, nh = cfg.dim, cfg.n_heads
    E, mi = cfg.n_routed_experts, cfg.moe_inter_dim
    si = cfg.n_shared_experts * mi
    flat = {"wq": (nh * cfg.qk_head_dim, D), "wo": (D, nh * cfg.v_head_dim),
            "s_w1": (si, D), "s_w2": (D, si)}
    cases = [(m, p) for m in (1, 4, 64, 2048) for p in ("wq", "wo")]
    cases += [(m, p) for m in (1, 2048) for p in ("s_w1", "s_w2")]
    cases += [(m, p) for m in (1, 4, 384) for p in ("e_w1", "e_w2")]
    rows = []

    def sweep(label, m, proj, call, plain, ws, nbytes, ops, lib):
        """Every body of row 16 on `call` (w8, se) within "identity" of
        `plain`, timed; the routed body's time is the row's."""
        ms, err = {}, 0.0
        for body in f8.BODY_NAMES:
            with forced_fp8(body):
                err = max(err, compare_bf16(call(*ws[0]), plain(*ws[0]),
                                            "identity", f"fp8_matmul {body} "
                                            f"{label}"))
                ms[body] = sweep_ms(torch, call, ws)
        routed = f8.fp8_body(m)
        plain_ms = cuda_ms(torch, plain, ws, 4)
        lib_ms = cuda_ms(torch, torch.matmul, lib, 20)
        b_ms, b_by = bound_ms(nbytes, ops, BF16_FLOPS_PER_S)
        rows.append(dict(case=label, m=m, proj=proj, body=routed,
                         ms=ms[routed], plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib_ms, bytes=nbytes,
                         ops=ops, max_abs_err=err,
                         **{f"{b}_ms": ms[b] for b in f8.BODY_NAMES}))
        log(f"  fp8_matmul {label}: every body within 'identity', max abs "
            f"err {err:.3e}; " + " ".join(f"{b}_ms {ms[b]:.4f}"
                                          for b in f8.BODY_NAMES)
            + f" (route: {routed}) plain_ms {plain_ms:.4f} bound "
            f"{b_ms * 1e3:.2f} us ({b_by}: {nbytes / 1e6:.1f} MB, "
            f"{ops / 1e9:.1f} G ops) library_ms {lib_ms:.4f} (torch.matmul, "
            "bf16 weights)")

    for m, proj in cases:
        experts = proj.startswith("e_")
        n, k = ((mi, D) if proj == "e_w1" else (D, mi)) if experts \
            else flat[proj]
        shape = (E, n, k) if experts else (n, k)
        wbytes = n * k * (E if experts else 1)
        ws = _fp8_weights(torch, dev, gen, shape, copies_for(wbytes))
        xe = E if experts and m == 384 else 1
        x = torch.randn((xe, m, k) if experts else (m, k), generator=gen,
                        device=dev).to(torch.bfloat16)
        if experts and m < 384:
            x = x.expand(E, m, k)  # one x read by every expert
        ne = E if experts else 1
        label = (f"M={m} {proj} {ne} x {n}x{k}" if experts else
                 f"M={m} {proj} {n}x{k}") + " (DeepSeek-V2-Lite)"
        sweep(label, m, proj,
              lambda w, s: f8.fp8_matmul(x, w, s, exact=True),
              lambda w, s: f8.fp8_matmul_ref(x, w, s), ws,
              2 * xe * m * k + wbytes + 4 * ne * (k // 128) * n
              + 2 * ne * m * n, 2 * ne * m * n * k,
              [(x, _dequant_bf16(torch, *w)) for w in ws[:2]])
        del ws, x

    # V3's wkv_a: K-aligned 128-block scales at N = 576, which fp8_linear
    # hands the kernel as it is (the kernel masks the ragged N)
    n, k = DEEPSEEK_V3.kv_lora_rank + DEEPSEEK_V3.qk_rope_head_dim, \
        DEEPSEEK_V3.dim
    ws = []
    for _ in range(copies_for(n * k)):
        q, sc = f8.fp8_block_quantize(
            torch.randn((n, k), generator=gen, device=dev) * 0.05, 128)
        ws.append((q, f8.expand_fp8_scales(sc, n, k)))
    x = torch.randn((4, k), generator=gen, device=dev).to(torch.bfloat16)
    seen, kernel = [], f8.fp8_matmul

    def spy(x_, w_, s_, *a):
        seen.append(tuple(w_.shape))
        return kernel(x_, w_, s_, *a)

    with patched([(f8, "fp8_matmul", spy)]):
        f8.fp8_linear(x, {"w8": ws[0][0], "se": ws[0][1]}, exact=True)
    if seen != [(n, k)]:
        raise AssertionError(f"fp8_linear handed the kernel {seen} for V3's "
                             f"128-block wkv_a, expected [({n}, {k})]")
    sweep(f"M=4 wkv_a {n}x{k} (DeepSeek-V3, fp8_linear, N unpadded)", 4,
          "v3 wkv_a",
          lambda w, s: f8.fp8_linear(x, {"w8": w, "se": s}, exact=True),
          lambda w, s: f8.fp8_matmul_ref(x, w, s), ws,
          2 * 4 * k + n * k + 4 * (k // 128) * n + 2 * 4 * n, 2 * 4 * n * k,
          [(x, _dequant_bf16(torch, *w)) for w in ws[:2]])
    del ws
    r = results.setdefault("fp8_matmul", dict(rows=[], max_abs_err=0.0))
    r["rows"] += rows
    r["max_abs_err"] = max([r["max_abs_err"]] + [x["max_abs_err"]
                                                 for x in rows])
    for m in sorted({x["m"] for x in rows}):
        wins = [min(f8.BODY_NAMES, key=lambda b: x[f"{b}_ms"])
                for x in rows if x["m"] == m]
        log(f"  fp8_matmul M={m}: fastest body by shape {wins}; the route "
            f"takes {f8.fp8_body(m)}")
    wrong = route_faults(rows, f8.BODY_NAMES)
    if wrong:
        raise AssertionError(f"row 16's route picks a body that another beat "
                             f"by more than {ROUTE_MARGIN:.0%}: {wrong}")

    # row 1 at the packed W4A4 form's shapes: both bodies bit for bit at
    # M = 1, 300 and 2048; the routed body timed at M = 1 and 2048
    for m in (1, 300, 2048):
        for proj, (n, k) in (("ds dense w2", (D, cfg.inter_dim)),
                             ("ds s_w2", (D, si)),
                             ("ds wkv_a", (cfg.kv_lora_rank
                                           + cfg.qk_rope_head_dim, D))):
            xq, xs = _codes_scales(torch, dev, gen, m, k)
            ws = _rand_weights(torch, dev, gen, n, k,
                               None if m != 300 else 1)
            want = im.w4a8_matmul_ref(xq, xs, *ws[0])
            for body in BODIES:
                with forced_body(body):
                    if not torch.equal(im.w4a4_matmul_i8(xq, xs, *ws[0]),
                                       want):
                        raise AssertionError(
                            f"w4a4_matmul_i8 {body} M={m} {proj} N={n} "
                            f"K={k}: not bit-exact")
            routed = im.w4a4_body(m, n, k)
            log(f"  w4a4_matmul_i8 M={m} {proj} {n}x{k}: both bodies "
                f"bit-exact (route: {routed})")
            if m == 300:
                continue
            args = [(xq, xs, wp, sw) for wp, sw in ws]
            ms = cuda_ms(torch, im.w4a4_matmul_i8, args, 40)
            plain = cuda_ms(torch, im.w4a8_matmul_ref, args, 4)
            nbytes = m * k + n * k // 2 + 4 * m + 4 * n + 2 * m * n
            b_ms, b_by = bound_ms(nbytes, 2 * m * n * k, INT8_OPS_PER_S)
            results.setdefault("w4a4_matmul_i8", dict(
                rows=[], max_abs_err=0.0))["rows"].append(dict(
                m=m, proj=proj, n=n, k=k, body=routed, ms=ms,
                plain_ms=plain, library_ms=None, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=0.0))
            log(f"    {routed} body: kernel_ms {ms:.4f} plain_ms {plain:.4f} "
                f"bound {b_ms * 1e3:.2f} us ({b_by})")
            del ws, args


# ---------------------------------------------------------------------------
# phase 3i: rows 17-21, the JAX package's measured kernel baselines
# ---------------------------------------------------------------------------

# row 18's rel-RMS against the float32 oracle on unit-normal inputs: the
# JAX package's own bounds (tests/test_prefill_attention.py)
I8_ORACLE_REL_RMS = {True: 0.035, False: 0.02}
# phase 11's interleaved timing: rounds of every variant, decode steps
# each; rounds of the 4 x 48 prefill with row 17 and the composed route
DECODE_ROUNDS, DECODE_STEPS = 3, 16
PREFILL_ROUNDS = 5


def _flash_i8_bound(S, nh, B, nkv, pv_i8):
    """Bytes and operation time of one flash_prefill_attention_kt_i8 call:
    q, k, v read once and o written once (bf16); the causal QK^T at the
    int8 rate and PV at the int8 (pv_i8) or bf16 rate. Returns (bound ms,
    bound_by, bytes, operations)."""
    nbytes = 2 * B * S * 128 * (2 * nh + 2 * nkv)
    half = S * (S + 1) * 128 * nh * B  # one causal product, 2 ops a MAC
    t_ops = (half / INT8_OPS_PER_S
             + half / (INT8_OPS_PER_S if pv_i8 else BF16_FLOPS_PER_S)) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return max(t_bytes, t_ops), by, nbytes, 2 * half


def check_baseline_kernels(torch, dev, gen, results):
    """Rows 17-21 against their plain versions at llama-2-7b widths, timed
    beside their bounds and library yardsticks the port never calls.
    Row 17 (w4a4_matmul_i8_fusedq): one layer's four linears at M=4 and the
    merged qkv at M=2048 (bf16 activations, LAC clips), bit for bit
    against quant_acts_i8 followed by w4a4_matmul_i8 (rows 12 and 1) and
    against the plain version; yardstick torch._int_mm on pre-unpacked
    int8 weights, as row 1's. Row 18 (flash_prefill_attention_kt_i8), both
    pv_i8 modes, at 1 x 2048 with 32/32 and 32/8 heads and at S=1152 (key
    blocks shrunk to 128): the prepass's codes and scales bit for bit
    (V8^T in prefill_attention.v8t_key_order) and its time alone, the
    output within tolerance.py's "flash" mode of the plain version at
    JAX's blk_k 512, and its rel-RMS against the float32 oracle under the
    JAX package's bounds at 1 x 2048; yardstick causal SDPA. Rows 19-21
    (decode_attention_int4_v1, _wide, _v3) at row 2's B=4 MHA shapes and
    Qwen-2.5-7B's 28/4 heads, valid lengths 0 and 1 among them: within
    ATTN_TOL of decode_attention_ref, valid_len 0 exactly 0, and their
    distance to row 2 on the same inputs; no library call."""
    from flatquant_torch.kernels import int4_matmul as im
    from flatquant_torch.kernels import kv_cache as kv
    from flatquant_torch.kernels import prefill_attention as pa
    from flatquant_torch.kernels.tolerance import bf16_ulp, compare_bf16
    from flatquant_torch.models.config import get_config

    # row 17
    lcfg = get_config("llama-2-7b")
    H, I = lcfg.hidden_size, lcfg.intermediate_size
    shapes = {"qkv": (3 * H, H), "o": (H, H), "upgate": (2 * I, H),
              "down": (H, I)}
    clip = _lac_clip(torch, dev)
    for m, projs in ((4, list(shapes)), (2048, ["qkv"])):
        for proj in projs:
            n, k = shapes[proj]
            wbytes = n * k // 2
            ws = [(torch.randint(0, 256, (n, k // 2), generator=gen,
                                 device=dev, dtype=torch.uint8),
                   torch.rand((n,), generator=gen, device=dev) * 0.01 + 1e-4)
                  for _ in range(copies_for(wbytes))]
            x = (torch.randn((m, k), generator=gen, device=dev) * 2).to(
                torch.bfloat16)
            x[m // 2] = 0  # a zero row: scale 1, codes 0
            got = im.w4a4_matmul_i8_fusedq(x, *ws[0], clip)
            xq, xs = im.quant_acts_i8(x, clip, 7)
            composed = im.w4a4_matmul_i8(xq, xs, *ws[0])
            plain = im.w4a4_matmul_i8_fusedq_ref(x, *ws[0], clip)
            torch.cuda.synchronize()
            if not (torch.equal(got, composed) and torch.equal(got, plain)):
                raise AssertionError(
                    f"w4a4_matmul_i8_fusedq M={m} {proj}: not bit-exact "
                    "against quant_acts_i8 + w4a4_matmul_i8 and its plain "
                    "version")
            mp = m if m > 16 else 32
            xp = torch.randint(-8, 8, (mp, k), generator=gen, device=dev,
                               dtype=torch.int8)
            w8 = [(xp, im.unpack_weight_planar(wp).t()) for wp, _ in ws[:2]]
            _kernel_row(torch, results, "w4a4_matmul_i8_fusedq",
                        f"M={m} {proj} {n}x{k} (llama-2-7b, bf16 x, LAC "
                        "clips)",
                        lambda wp, sw: im.w4a4_matmul_i8_fusedq(x, wp, sw,
                                                                clip),
                        lambda wp, sw: im.w4a4_matmul_i8_fusedq_ref(x, wp, sw,
                                                                    clip),
                        ws, 2 * m * k + wbytes + 4 * n + 2 * m * n + 8,
                        2 * m * n * k, INT8_OPS_PER_S, 0.0,
                        iters=60 if m < 2048 else 20,
                        lib=(torch._int_mm, w8, f"torch._int_mm, int8 "
                             f"weights, M={mp}"), m=m, proj=proj)
            log(f"    w4a4_matmul_i8_fusedq M={m} {proj}: bit-exact against "
                "quant_acts_i8 + w4a4_matmul_i8 and the plain version")
            del ws, w8

    # row 18
    l3 = get_config("llama-3-8b")
    cases = [(f"llama-2-7b B=1 S=2048 {lcfg.num_heads}/"
              f"{lcfg.num_kv_heads} heads", 2048, lcfg.num_heads,
              lcfg.num_kv_heads),
             (f"llama-3-8b B=1 S=2048 {l3.num_heads}/{l3.num_kv_heads} "
              "heads", 2048, l3.num_heads, l3.num_kv_heads),
             (f"llama-2-7b B=1 S=1152 {lcfg.num_heads}/"
              f"{lcfg.num_kv_heads} heads", 1152, lcfg.num_heads,
              lcfg.num_kv_heads)]
    sm = 1.0 / math.sqrt(128)
    sdpa = _sdpa(torch)
    for label, S, nh, nkv in cases:
        B = 1
        sets = [[torch.randn((B, S, n, 128), generator=gen, device=dev).to(
            torch.bfloat16) for n in (nh, nkv, nkv)]
            for _ in range(copies_for(2 * B * S * 128 * (2 * nh + 2 * nkv)))]
        # the kt layout as the fused route passes it: a strided view
        args = [(q, k.permute(0, 2, 3, 1), v) for q, k, v in sets]
        lib_ms = cuda_ms(torch, sdpa, [(*t, sm) for t in sets], 20)
        q, kt, v = args[0]
        oracle = pa.flash_prefill_ref(q.float(),
                                      kt.permute(0, 3, 1, 2).float(),
                                      v.float(), sm).float()
        k8r, v8r, scr = pa.quantize_kv_i8_ref(kt, v)
        for pv_i8 in (True, False):
            out, k8, v8t, sc = pa._launch_i8(q, kt, v, sm, pv_i8, pa.K_BLK)
            torch.cuda.synchronize()
            same = (torch.equal(k8, k8r) and torch.equal(sc[..., 0],
                                                          scr[..., 0])
                    and (not pv_i8 or (torch.equal(v8t, pa.v8t_key_order(v8r))
                                       and torch.equal(sc[..., 1],
                                                       scr[..., 1]))))
            if not same:
                raise AssertionError(f"flash_prefill_attention_kt_i8 {label}"
                                     f" pv_i8={pv_i8}: prepass codes or "
                                     "scales not bit-exact")
            plain = pa.flash_prefill_attention_kt_i8_ref(q, kt, v, sm, pv_i8)
            what = f"flash_prefill_attention_kt_i8 {label} pv_i8={pv_i8}"
            err = compare_bf16(out, plain, "flash", what)
            # the error in bf16 ulps of its row's largest value (at most 2)
            ulps = ((out.float() - plain.float()).abs() / bf16_ulp(
                plain.float().abs().amax(-1, keepdim=True))).max().item()
            rel = ((out.float() - oracle).norm() / oracle.norm()).item()
            if S == 2048 and rel >= I8_ORACLE_REL_RMS[pv_i8]:
                raise AssertionError(f"{what}: rel-RMS {rel:.4f} against the "
                                     f"float32 oracle, bound "
                                     f"{I8_ORACLE_REL_RMS[pv_i8]}")
            b_ms, b_by, nbytes, ops = _flash_i8_bound(S, nh, B, nkv, pv_i8)
            ms = cuda_ms(torch, lambda *a: pa.flash_prefill_attention_kt_i8(
                *a, sm, pv_i8), args, 20)
            # the prepass alone (its share of ms)
            pre_ms = cuda_ms(torch, lambda q_, kt_, v_: pa.kv_quant_i8_prepass(
                kt_, v_, pv_i8), args, 20)
            plain_ms = cuda_ms(torch, lambda *a: (
                pa.flash_prefill_attention_kt_i8_ref(*a, sm, pv_i8)), args, 2)
            r = results.setdefault("flash_prefill_attention_kt_i8",
                                   dict(rows=[], max_abs_err=0.0))
            r["rows"].append(dict(case=f"{label}, pv_i8={pv_i8}", B=B, S=S,
                                  nh=nh, nkv=nkv, pv_i8=pv_i8, ms=ms,
                                  prepass_ms=pre_ms, plain_ms=plain_ms,
                                  bound_ms=b_ms,
                                  bound_by=b_by, library_ms=lib_ms,
                                  bytes=nbytes, ops=ops, max_abs_err=err,
                                  max_row_ulps=ulps, oracle_rel_rms=rel))
            r["max_abs_err"] = max(r["max_abs_err"], err)
            log(f"  {what}: prepass bit-exact, within 'flash', max abs err "
                f"{err:.3e} ({ulps:.2f} bf16 ulps of its row's largest "
                f"value), rel-RMS vs the float32 oracle {rel:.4f}; "
                f"kernel_ms {ms:.4f} (prepass {pre_ms:.4f}) plain_ms "
                f"{plain_ms:.4f} bound "
                f"{b_ms * 1e3:.2f} us ({b_by}: {nbytes / 1e6:.1f} MB, "
                f"{ops / 1e9:.1f} G ops) library_ms {lib_ms:.4f} (causal "
                "SDPA)")
        del sets, args, oracle

    # rows 19-21
    S = 2048
    cases = [("B=4 MHA 32/32 main path", 4, 32, 32, [48 + 64] * 4),
             ("B=4 MHA 32/32 ragged", 4, 32, 32, [0, 1, 1500, S]),
             ("B=1 GQA 28/4 (n_rep 7)", 1, 28, 4, [S]),
             ("B=4 GQA 28/4 (n_rep 7) ragged", 4, 28, 4, [1, 0, 1023, 77]),
             (f"B={len(span_edges()) + 1} GQA 28/4 (n_rep 7) span edges",
              len(span_edges()) + 1, 28, 4, span_edges() + [0])]

    def plain(q, kp, kpar, vp, vpar, valid, sm):
        return kv.decode_attention_ref(q, kp, kpar[..., :1], kpar[..., 1:], vp,
                                       vpar[..., :1], vpar[..., 1:], valid,
                                       sm)

    for label, B, nh, nkv, valid_l in cases:
        valid = torch.tensor(valid_l, device=dev, dtype=torch.int32)
        full = B * nkv * S * (64 * 2 + 16)
        caches = [_rand_cache(torch, dev, gen, B, nkv, S)
                  for _ in range(copies_for(full))]
        q = torch.randn((B, nh, 128), generator=gen, device=dev).to(
            torch.bfloat16)
        args = [(q, *c, valid, sm) for c in caches]
        want = plain(*args[0])
        row2 = kv.decode_attention_int4(*args[0])
        plain_ms = cuda_ms(torch, plain, args, 6)
        tokens = sum(min(x, S) for x in valid_l)
        nbytes = tokens * nkv * (64 * 2 + 16) + B * nh * 128 * 2 * 2 + 4 * B
        b_ms, b_by = bound_ms(nbytes, tokens * nh * 128 * 4, F32_FLOPS_PER_S)
        for name in ("decode_attention_int4_v1", "decode_attention_int4_wide",
                     "decode_attention_int4_v3"):
            fn = getattr(kv, name)
            got = fn(*args[0])
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL)
            if not bool((got[valid == 0] == 0).all()):
                raise AssertionError(f"{name}: valid_len 0 must give 0")
            d2 = (got.float() - row2.float()).abs().max().item()
            ms = cuda_ms(torch, fn, args, 60)
            r = results.setdefault(name, dict(rows=[], max_abs_err=0.0))
            r["rows"].append(dict(case=label, B=B, nh=nh, nkv=nkv, S=S,
                                  valid=valid_l, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, bound_by=b_by,
                                  library_ms=None, max_abs_err=err,
                                  max_abs_diff_row2=d2))
            r["max_abs_err"] = max(r["max_abs_err"], err)
            log(f"  {name} {label} S={S} valid={valid_l}: max abs err "
                f"{err:.3e} (tol rtol/atol {ATTN_TOL['rtol']}), against row 2 "
                f"{d2:.3e}; kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} bound "
                f"{b_ms * 1e3:.2f} us ({b_by}); library_ms none")
        del caches, args


# ---------------------------------------------------------------------------
# phase 3j: rows 22-27, the grouped layout, and row 1 at the prefill's M
# ---------------------------------------------------------------------------


def _rand_weights(torch, dev, gen, n, k, copies=None):
    """`copies` (default: enough to pass the L2 cache) sets of random
    planar int4 weights [n, k/2] and their scales [n]."""
    return [(torch.randint(0, 256, (n, k // 2), generator=gen, device=dev,
                           dtype=torch.uint8),
             torch.rand((n,), generator=gen, device=dev) * 0.01 + 1e-4)
            for _ in range(copies or copies_for(n * k // 2))]


def _twin_equal(torch, name, got, want):
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: not bit-identical to its flat "
                                 "twin on the same values")


def check_grouped_kernels(torch, dev, gen, results):
    """Rows 22-27 at llama-2-7b's 1 x 2048 prefill shapes (T = 2048): each
    held to its plain version (its twin's tolerance mode, tolerance.py)
    with identity and random orthogonal factors, and bit for bit to its
    flat twin on the same values through the layout glue; then timed
    (orthogonal factors) beside its bound, its plain version and, for the
    GEMMs, torch._int_mm of the GEMM part on pre-unpacked int8 weights (a
    yardstick the port never calls). Row 26 at [2048, 4096] -> [32, 2048,
    128]; row 23 at G = 32 and 86; row 27 [32, 2048, 128] -> [86, 2048,
    128], N = 2 x 11008; row 22 [2048, 4096] -> [86, 2048, 128] (rows 27
    and 22 also at the other M of SWIGLU_SWEEP_M); row 25 at
    qkv (K 4096, N 12288) and down (K 11008, N 4096), each of row 1's two
    bodies, at M = 4 and 2048; row 24 at [86, 2048, 128] with LAC clips.
    Edge shapes are checked, not timed: M = 300 (row 25 in both bodies and
    output types), float32 inputs, no clips, q_max 127 and a zero row.
    Row 1 itself is timed at row 25's shapes beside torch._int_mm."""
    from flatquant_torch.kernels import flat_pipeline as fp
    from flatquant_torch.kernels import grouped_mlp as gm
    from flatquant_torch.kernels import int4_matmul as im
    from flatquant_torch.kernels.tolerance import (
        compare_bf16, compare_codes, compare_scales)
    from flatquant_torch.models.config import get_config

    cfg = get_config("llama-2-7b")
    T, H, I = 2048, cfg.hidden_size, cfg.intermediate_size
    clip = _lac_clip(torch, dev)
    ug = gm.ungroup_layout

    # row 26
    def rms(x, w, right, mode, label):
        y = gm.rmsnorm_right_grouped(x, w, right, 1e-5)
        err = compare_bf16(ug(y), ug(gm.rmsnorm_right_grouped_ref(
            x, w, right, 1e-5)), mode, f"rmsnorm_right_grouped {label}")
        _twin_equal(torch, "rmsnorm_right_grouped", [ug(y)],
                    [fp.rmsnorm_right_flat(x, w, right, 1e-5)])
        return err

    w = torch.rand((H,), generator=gen, device=dev) + 0.5
    x300 = torch.randn((300, H), generator=gen, device=dev) * 2
    rms(x300, w, _factor(torch, dev, gen, 128, "orthogonal"), "orthogonal",
        "T=300 f32")
    x1 = (torch.randn((1, H), generator=gen, device=dev) * 2).to(
        torch.bfloat16)
    rms(x1, w, _factor(torch, dev, gen, 128, "orthogonal"), "orthogonal",
        "T=1")
    xs = [(torch.randn((T, H), generator=gen, device=dev) * 2).to(
        torch.bfloat16) for _ in range(copies_for(4 * T * H))]
    for mode in ("identity", "orthogonal"):
        right = _factor(torch, dev, gen, 128, mode)
        err = rms(xs[0], w, right, mode, mode)
    log(f"  rmsnorm_right_grouped T={T} H={H} (also T=300 f32, T=1): within "
        f"tolerance of the plain version, bit-identical to "
        f"rmsnorm_right_flat")
    rb = right.to(torch.bfloat16)  # the factor as the bf16 model holds it
    _kernel_row(torch, results, "rmsnorm_right_grouped",
                f"T={T} H={H} -> [{H // 128}, {T}, 128]",
                lambda x: gm.rmsnorm_right_grouped(x, w, rb, 1e-5),
                lambda x: gm.rmsnorm_right_grouped_ref(x, w, rb, 1e-5),
                [(x,) for x in xs], 4 * T * H + 4 * H + 2 * 128 * 128,
                2 * T * H * 128, BF16_FLOPS_PER_S, err)
    del xs, x300, x1

    # row 23
    def lq(lt, xg, c, mode, label):
        q, sc = gm.left_quant_i8_grouped(lt, xg, c)
        q_ref, sc_ref = gm.left_quant_i8_grouped_ref(lt, xg, c)
        compare_codes(q, q_ref, mode, f"left_quant_i8_grouped {label} codes")
        err = compare_scales(sc, sc_ref, mode,
                             f"left_quant_i8_grouped {label} scales")
        _twin_equal(torch, "left_quant_i8_grouped", [ug(q), sc],
                    fp.left_quant_i8_flat(lt, ug(xg), c))
        return err

    x300 = (torch.randn((300, I), generator=gen, device=dev) * 3).to(
        torch.bfloat16)
    x300[7] = 0
    lq(_factor(torch, dev, gen, I // 128, "orthogonal"),
       gm.group_layout(x300, I // 128), None, "orthogonal",
       "T=300 G=86 no clip")
    for k in (H, I):
        g = k // 128
        xs = [gm.group_layout((torch.randn((T, k), generator=gen, device=dev)
                               * 3).to(torch.bfloat16), g)
              for _ in range(copies_for(3 * T * k))]
        for mode in ("identity", "orthogonal"):
            lt = _factor(torch, dev, gen, g, mode)
            err = lq(lt, xs[0], clip, mode, f"G={g} {mode}")
        log(f"  left_quant_i8_grouped [{g}, {T}, 128] (also "
            f"[{I // 128}, 300, 128] without clips): codes and scales within "
            "tolerance, bit-identical to left_quant_i8_flat")
        _kernel_row(torch, results, "left_quant_i8_grouped",
                    f"[{g}, {T}, 128] (G={g})",
                    lambda x: gm.left_quant_i8_grouped(lt, x, clip),
                    lambda x: gm.left_quant_i8_grouped_ref(lt, x, clip),
                    [(x,) for x in xs], 3 * T * k + 4 * T + 2 * g * g + 8,
                    2 * T * k * g, BF16_FLOPS_PER_S, err, g=g)
        del xs
    del x300

    # rows 22 and 27: the merged up||gate GEMM of the MLP
    def swi(name, fn, plain, xq, xin, sx, wp, sw, right, mode, label):
        y = fn(xin, sx, wp, sw, right)
        err = compare_bf16(ug(y), ug(plain(xin, sx, wp, sw, right)), mode,
                           f"{name} {label}")
        _twin_equal(torch, name, [ug(y)],
                    [fp.w4a4_matmul_i8_swiglu_right(xq, sx, wp, sw, right)])
        return err

    rows2227 = (("w4a4_swiglu_grouped", gm.w4a4_swiglu_grouped,
                 gm.w4a4_swiglu_grouped_ref, False),
                ("w4a4_swiglu_grouped_gx", gm.w4a4_swiglu_grouped_gx,
                 gm.w4a4_swiglu_grouped_gx_ref, True))
    ws = _rand_weights(torch, dev, gen, 2 * I, H)
    for m in (300,) + SWIGLU_SWEEP_M:
        xq = torch.randint(-8, 8, (m, H), generator=gen, device=dev,
                           dtype=torch.int8)
        xqg = gm.group_layout(xq, H // 128)
        sx = torch.rand((m, 1), generator=gen, device=dev) * 0.1 + 1e-3
        modes = ("identity", "orthogonal") if m == T else ("orthogonal",)
        for name, fn, plain, gx in rows2227:
            xin = xqg if gx else xq
            for mode in modes:
                right = _factor(torch, dev, gen, 128, mode)
                err = swi(name, fn, plain, xq, xin, sx, *ws[0], right, mode,
                          f"M={m} {mode}")
            log(f"  {name} M={m} K={H} N=2x{I}: within tolerance, "
                "bit-identical to w4a4_matmul_i8_swiglu_right")
            if m == 300:
                continue
            w8 = [(xq, im.unpack_weight_planar(wp).t()) for wp, _ in ws[:2]]
            _kernel_row(
                torch, results, name,
                f"M={m} {f'[{H // 128}, {m}, 128]' if gx else f'[{m}, {H}]'}"
                f" -> "
                f"[{I // 128}, {m}, 128], N=2x{I}",
                lambda wp, sw: fn(xin, sx, wp, sw, right),
                lambda wp, sw: plain(xin, sx, wp, sw, right),
                ws, m * H + I * H + 4 * m + 8 * I + 2 * 128 * 128 + 2 * m * I,
                2 * m * 2 * I * H + 2 * m * I * 128, INT8_OPS_PER_S, err,
                lib=(torch._int_mm, w8, "torch._int_mm, int8 weights, GEMM "
                     "only"), m=m)
            del w8
    del ws

    # row 25, and row 1 at the same shapes: each body of row 25 bit for
    # bit against the plain version and the same body of row 1, in both
    # output types at M = 300; timed (the routed body) at M = 4 and 2048
    for m, proj, n, k in ((300, "down", H, I), (4, "qkv", 3 * H, H),
                          (4, "down", H, I), (T, "qkv", 3 * H, H),
                          (T, "down", H, I)):
        xq, sx = _codes_scales(torch, dev, gen, m, k)
        xqg = gm.group_layout(xq, k // 128)
        ws = _rand_weights(torch, dev, gen, n, k, None if m != 300 else 1)
        for out in ((torch.float32, torch.bfloat16) if m == 300
                    else (torch.bfloat16,)):
            want = gm.w4a4_matmul_i8_grouped_ref(xqg, sx, *ws[0], out)
            for body in BODIES:
                with forced_body(body):
                    y = gm.w4a4_matmul_i8_grouped(xqg, sx, *ws[0], out)
                    if not torch.equal(y, want):
                        raise AssertionError(
                            f"w4a4_matmul_i8_grouped {body} M={m} {proj} "
                            f"{out}: not bit-exact against its plain version")
                    _twin_equal(torch, "w4a4_matmul_i8_grouped", [y],
                                [im.w4a4_matmul_i8(xq, sx, *ws[0], out)])
        log(f"  w4a4_matmul_i8_grouped M={m} {proj} {n}x{k}: both bodies "
            f"bit-exact against its plain version and w4a4_matmul_i8's same "
            f"body (route: {im.w4a4_body(m, n, k)})")
        if m == 300:
            continue
        w8 = [(xq if m > 16 else xq.new_zeros((32, k)),
               im.unpack_weight_planar(wp).t()) for wp, _ in ws[:2]]
        lib = (torch._int_mm, w8, "torch._int_mm, int8 weights"
               + ("" if m > 16 else ", M padded to 32"))
        nbytes = m * k + n * k // 2 + 4 * m + 4 * n + 2 * m * n
        for name, x_in, fn, plain in (
                ("w4a4_matmul_i8_grouped", xqg, gm.w4a4_matmul_i8_grouped,
                 gm.w4a4_matmul_i8_grouped_ref),
                ("w4a4_matmul_i8", xq, im.w4a4_matmul_i8,
                 im.w4a8_matmul_ref)):
            _kernel_row(torch, results, name,
                        f"M={m} {proj} {n}x{k} ({im.w4a4_body(m, n, k)} "
                        f"body)", lambda wp, sw: fn(x_in, sx, wp, sw),
                        lambda wp, sw: plain(x_in, sx, wp, sw), ws, nbytes,
                        2 * m * n * k, INT8_OPS_PER_S, 0.0,
                        iters=20 if m == T else 60, lib=lib, m=m, proj=proj)
        del ws, w8

    # row 24
    x300 = gm.group_layout(torch.randn((300, H), generator=gen, device=dev)
                           * 3, H // 128)
    x300[:, 5] = 0
    xs = [gm.group_layout((torch.randn((T, I), generator=gen, device=dev)
                           * 3).to(torch.bfloat16), I // 128)
          for _ in range(copies_for(3 * T * I))]
    xs[0][:, 1] = 0  # a zero row: scale 1, codes 0
    for x, c, q_max, label in ((x300, None, 127, f"[{H // 128}, 300, 128] "
                                "f32 q_max 127, no clips"),
                               (xs[0], clip, 7, f"[{I // 128}, {T}, 128] "
                                "bf16")):
        q, sc = gm.quant_acts_i8_grouped(x, c, q_max)
        q_ref, sc_ref = gm.quant_acts_i8_grouped_ref(x, c, q_max)
        if not (torch.equal(q, q_ref) and torch.equal(sc, sc_ref)):
            raise AssertionError(f"quant_acts_i8_grouped {label}: codes or "
                                 "scales not bit-exact")
        _twin_equal(torch, "quant_acts_i8_grouped", [ug(q), sc],
                    im.quant_acts_i8(ug(x), c, q_max))
        log(f"  quant_acts_i8_grouped {label}: codes and scales bit-exact, "
            "bit-identical to quant_acts_i8")
    _kernel_row(torch, results, "quant_acts_i8_grouped",
                f"[{I // 128}, {T}, 128] bf16, LAC clips, q_max 7",
                lambda x: gm.quant_acts_i8_grouped(x, clip, 7),
                lambda x: gm.quant_acts_i8_grouped_ref(x, clip, 7),
                [(x,) for x in xs], 3 * T * I + 4 * T + 8, 4 * T * I,
                F32_FLOPS_PER_S, 0.0)
    # the round-2 tail's left product on row 24's inputs (phase 12 (b)
    # runs it between rows 22 and 24): one bf16 torch.matmul, no kernel
    g = I // 128
    lt = _factor(torch, dev, gen, g, "orthogonal").to(torch.bfloat16)
    ms = cuda_ms(torch, lambda x: torch.matmul(lt, x.reshape(g, -1)),
                 [(x,) for x in xs], 20)
    b_ms, b_by = bound_ms(4 * T * I, 2 * T * I * g, BF16_FLOPS_PER_S)
    results["round2_left_matmul"] = dict(ms=ms, bound_ms=b_ms,
                                         bound_by=b_by)
    log(f"  the round-2 tail's left product, torch.matmul [{g}, {g}] x "
        f"[{g}, {T * 128}] bf16: {ms:.4f} ms, bound {b_ms * 1e3:.2f} us "
        f"({b_by})")
    del xs, x300


# ---------------------------------------------------------------------------
# phase 4: the decode-serving path at full llama-2-7b width and depth
# ---------------------------------------------------------------------------


def build_model(torch, dev, seed, name="llama-2-7b", fq=None):
    """A random model of the registry's `name` at full width and depth,
    built through the port's build_serving_layer one layer at a time:
    seeded N(0, 0.02^2) weights (and qkv bias, where the model has one),
    random orthogonal transforms in fq's Kronecker split (core/kron.py:
    rn128 under tpu_decompose, else FlatQuant's balanced split) baked into
    the weights, the LAC clips at their init (sigmoid(4)) when activations
    are quantized, the kcache transform when K is. fq defaults to
    W4A4KV4 with tpu_decompose (the llama-2-7b of phases 4-7)."""
    from flatquant_torch.core.kron import get_decompose_dim
    from flatquant_torch.models.config import get_config
    from flatquant_torch.models.llama import init_layer_params
    from flatquant_torch.quantize.spec import W4A4KV4
    from flatquant_torch.serving.quantized import (
        build_serving_layer, kron_transform)
    import dataclasses

    t0 = time.perf_counter()
    cfg = get_config(name)
    fq = fq or dataclasses.replace(W4A4KV4, tpu_decompose=True)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def orth(n):
        qm, r = torch.linalg.qr(torch.randn((n, n), generator=gen,
                                            device=dev, dtype=torch.float64))
        return (qm * torch.sign(torch.diagonal(r))).float()

    def split(n):
        return tuple(orth(d) for d in get_decompose_dim(n, fq.tpu_decompose))

    H, I, nh, hd = (cfg.hidden_size, cfg.intermediate_size, cfg.num_heads,
                    cfg.head_dim)
    clip = (1.0 / (1.0 + math.exp(-4.0)),) * 2  # sigmoid(4): the LAC init
    layers = []
    for _ in range(cfg.num_layers):
        lp = init_layer_params(cfg, gen, torch.float32, dev)
        if cfg.attn_bias:
            for key in ("bq", "bk", "bv"):
                lp[key] = torch.randn(lp[key].shape, generator=gen,
                                      device=dev) * 0.02
        lt = {"ln_t": split(H), "ug_t": split(H), "down_t": split(I),
              "o_t": orth(nh)}
        if fq.k_cfg.enabled:
            lt["k_t"] = orth(hd)
            lt["k_t_inv"] = torch.linalg.inv(lt["k_t"]).T.contiguous()
            lt["kc_clip"] = lt["vc_clip"] = clip
        if fq.a_cfg.enabled:
            lt["a_clip"] = {nm: clip for nm in ("qkv", "o", "upgate",
                                                "down")}
        eye = torch.eye(hd, device=dev)
        # bake: y = x W^T = (x T)(W T)^T for orthogonal T, so W <- W T
        for key, tr in (("wq", "ln_t"), ("wk", "ln_t"), ("wv", "ln_t"),
                        ("wup", "ug_t"), ("wgate", "ug_t"),
                        ("wdown", "down_t")):
            lp[key] = kron_transform(lp[key], lt[tr])
        lp["wo"] = kron_transform(lp["wo"], (lt["o_t"], eye))
        layers.append(build_serving_layer(cfg, fq, lp, lt,
                                          dtype=torch.bfloat16,
                                          merge_projections=True))
        del lp
    emb = (torch.randn((cfg.vocab_size, H), generator=gen, device=dev)
           * 0.02).to(torch.bfloat16)
    head = (torch.randn((cfg.vocab_size, H), generator=gen, device=dev)
            * 0.02).to(torch.bfloat16)
    sp = {"embed": emb, "lm_head": head,
          "final_norm_w": torch.ones(H, device=dev), "layers": layers}
    torch.cuda.synchronize()
    split_s = ("rn128" if fq.tpu_decompose else "balanced") + " split " + \
        f"{get_decompose_dim(H, fq.tpu_decompose)} / " \
        f"{get_decompose_dim(I, fq.tpu_decompose)}"
    log(f"  built {name} W{fq.w_bits}A{fq.a_bits}KV{fq.k_bits} {split_s}, "
        f"{cfg.num_layers} layers, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, "
        f"{time.perf_counter() - t0:.1f} s")
    return cfg, fq, sp


def profile_steps(torch, step, n, label="decode"):
    """Device time by kernel over n steps (torch.profiler), against the
    host wall time of the same steps: where a step's time goes, and the
    device's idle share. Measurement only: a profiler that records no
    device time is reported as 'not measured', not as a failure."""
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
        log(f"  {label} profile: not measured ({type(exc).__name__}: {exc})")
        return None
    if not kern:
        log(f"  {label} profile: not measured (no device time recorded)")
        return None
    other = "other kernels (torch glue)"
    # both flash entry points launch one CUDA kernel, flash_wgmma_kernel
    flash = "flash_wgmma_kernel (both flash entry points)"
    groups = dict.fromkeys([k for k in KERNELS if "flash" not in k]
                           + [flash, other], 0.0)
    for name, ms in kern.items():
        # the longest kernel name in the symbol: w4a4_matmul_i8_swiglu_right
        # before w4a4_matmul_i8
        hits = [k for k in groups if k in name]
        if "flash_wgmma_kernel" in name:
            groups[flash] += ms
        elif hits and "true>" in name and "paged_" + max(hits, key=len) \
                in groups:
            # the paged twins are the slot kernels' templates on <..., true>
            groups["paged_" + max(hits, key=len)] += ms
        else:
            groups[max(hits, key=len) if hits else other] += ms
    busy_ms = sum(kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:10]
    log(f"  {label} profile, per step: host wall {wall_ms:.3f} ms, device "
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


def path_bodies(common, want):
    """BODY_LAUNCHES as read after a path's run, checked against want:
    {kernel: (body, launches)}, every launch of the kernel in that body."""
    got = {k: dict(v) for k, v in common.BODY_LAUNCHES.items()}
    for name, (body, n) in want.items():
        if got[name].get(body, 0) != n or sum(got[name].values()) != n:
            raise AssertionError(f"{name}: launches by body {got[name]}, "
                                 f"expected {n} in {body}")
    return got


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


def _checked_decode_attention(torch, n, worst):
    """decode_attention_int4 that holds every launch to its plain version
    on the same inputs (ATTN_TOL), counting the checks in
    n["decode_attention_int4"] and keeping the largest abs error in
    worst["decode_attention_int4"]."""
    from flatquant_torch.kernels import kv_cache

    def attn(q, kp, kpar, vp, vpar, valid, sm):
        y = kv_cache.decode_attention_int4(q, kp, kpar, vp, vpar, valid, sm)
        ref = kv_cache.decode_attention_ref(
            q, kp, kpar[..., :1], kpar[..., 1:], vp, vpar[..., :1],
            vpar[..., 1:], valid, sm)
        torch.testing.assert_close(y.float(), ref.float(), **ATTN_TOL)
        key = "decode_attention_int4"
        worst[key] = max(worst[key],
                         (y.float() - ref.float()).abs().max().item())
        n[key] += 1
        return y

    return attn


def _checked_write(torch, n):
    """write_token that holds every launch bit for bit to its plain version
    on copies of the same cache tensors, counting in n["write_token"]."""
    from flatquant_torch.kernels import kv_cache

    def write(*a):
        copies = [t.clone() for t in a[:4]]
        kv_cache.write_token(*a)
        kv_cache.write_token_ref(*copies, *a[4:])
        for x, y in zip(a[:4], copies):
            if not torch.equal(x, y):
                raise AssertionError("write_token not bit-exact on the path")
        n["write_token"] += 1
        return a[:4]

    return write


def check_launches_on_path(torch, cfg, fq, sp, prompt, feed, slot_pos0, P,
                           NEW, kw):
    """Every kernel launch of a short kernel-path run (prefill, 4 scalar and
    4 per-slot decode steps) checked against its plain version on the same
    inputs -- the path's own activations at full depth: GEMM and write
    bit-exact, attention within ATTN_TOL."""
    from flatquant_torch.kernels import int4_matmul
    from flatquant_torch.serving import engine, quantized

    n = {"w4a4_matmul_i8": 0, "decode_attention_int4": 0, "write_token": 0}
    worst = {"decode_attention_int4": 0.0}

    def gemm(xq, xs, wp, sw, out_dtype=torch.bfloat16):
        y = int4_matmul.w4a4_matmul_i8(xq, xs, wp, sw, out_dtype)
        if not torch.equal(y, int4_matmul.w4a8_matmul_ref(xq, xs, wp, sw,
                                                          out_dtype)):
            raise AssertionError("w4a4_matmul_i8 not bit-exact on the path")
        n["w4a4_matmul_i8"] += 1
        return y

    with patched([(quantized, "w4a4_matmul_i8", gemm),
                  (engine, "decode_attention_int4",
                   _checked_decode_attention(torch, n, worst)),
                  (engine, "write_token", _checked_write(torch, n))]):
        c = engine.init_cache(cfg, prompt.shape[0], kw["max_len"],
                              mode="int4", device=kw["device"])
        engine.serving_prefill(cfg, fq, sp, prompt, c, **kw)
        for i in list(range(4)) + list(range(NEW, NEW + 4)):
            pos = P + i if i < NEW else slot_pos0 + (i - NEW)
            if i == NEW:  # jump the cache to the per-slot phase
                c = engine.init_cache(cfg, prompt.shape[0], kw["max_len"],
                                      mode="int4", device=kw["device"])
                engine.serving_prefill(cfg, fq, sp, prompt, c, **kw)
            engine.serving_decode_step(cfg, fq, sp, feed[i], c, pos, **kw)
    torch.cuda.synchronize()
    log(f"  every launch on the path vs its plain version: {n} launches "
        f"checked; GEMM and write bit-exact, attention max abs err "
        f"{worst['decode_attention_int4']:.3e}")
    return dict(launches=n,
                attention_max_abs_err=worst["decode_attention_int4"])


def run_main_path(torch, dev, model, results, smi):
    from flatquant_torch.kernels import common
    from flatquant_torch.serving import engine
    from flatquant_torch.serving.engine import (
        generate, init_cache, serving_decode_step, serving_prefill)

    B, P, NEW, SLOT, MAX_LEN = 4, 48, 64, 16, 2048
    cfg, fq, sp = model
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device=dev)
    slot_pos0 = torch.tensor([P + NEW, P + NEW - 5, P + 7, P + NEW - 20],
                             device=dev, dtype=torch.int32)
    kw = dict(max_len=MAX_LEN, device=dev)

    # warm-up (allocator, cuBLAS handles), not counted
    cache = init_cache(cfg, B, MAX_LEN, mode="int4", device=dev)
    serving_prefill(cfg, fq, sp, prompt, cache, **kw)
    serving_decode_step(cfg, fq, sp, prompt[:, -1:], cache, P, **kw)
    del cache
    torch.cuda.synchronize()

    common.reset_launches()
    t0 = time.perf_counter()
    gen_toks = generate(cfg, fq, sp, prompt.cpu().numpy(),
                        max_new_tokens=NEW, cache_mode="int4", **kw)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0

    # the same run through the step entry points, timed per step
    cache = init_cache(cfg, B, MAX_LEN, mode="int4", device=dev)
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
    for name in DECODE_KERNELS:
        if launches[name] <= 0:
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
        c = init_cache(cfg, B, MAX_LEN, mode="int4", device=dev)
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
# phase 5: the fused prompt prefill at full llama-2-7b width and depth
# ---------------------------------------------------------------------------

# launches of one full-depth 4 x 512 prefill: per layer two RMSNorms (ln1,
# ln2), four left-factor quants (ln1, o, ln2, down), one swiglu GEMM, one
# prologue, three plain GEMMs (qkv, o, down)
PREFILL_LAUNCHES = {"rmsnorm_right_flat": 2, "left_quant_i8_flat": 4,
                    "w4a4_matmul_i8_swiglu_right": 1, "attn_prologue": 1,
                    "w4a4_matmul_i8": 3}


def _plain_pairs(torch):
    """(module, name, plain version) of every kernel wrapper the serving
    routes call: the same routes with each kernel swapped for its plain
    version."""
    from flatquant_torch.kernels import attn_prologue as ap
    from flatquant_torch.kernels import flat_pipeline as fp
    from flatquant_torch.kernels import int4_matmul, kv_cache
    from flatquant_torch.kernels import prefill_attention as pa
    from flatquant_torch.serving import engine, quantized

    def attn(q, kp, kpar, vp, vpar, valid, sm):
        return kv_cache.decode_attention_ref(
            q, kp, kpar[..., :1], kpar[..., 1:], vp, vpar[..., :1],
            vpar[..., 1:], valid, sm)

    return [(quantized, "rmsnorm_right_flat", fp.rmsnorm_right_flat_ref),
            (quantized, "left_quant_i8_flat", fp.left_quant_i8_flat_ref),
            (quantized, "w4a4_matmul_i8_swiglu_right",
             fp.w4a4_matmul_i8_swiglu_right_ref),
            (quantized, "w4a4_matmul_i8", int4_matmul.w4a8_matmul_ref),
            (engine, "attn_prologue", ap.attn_prologue_ref),
            (engine, "left_quant_i8_flat", fp.left_quant_i8_flat_ref),
            (engine, "w4a4_matmul_i8", int4_matmul.w4a8_matmul_ref),
            (engine, "decode_attention_int4", attn),
            (engine, "write_token", kv_cache.write_token_ref),
            (engine, "flash_prefill_attention_kt",
             pa.flash_prefill_attention_kt_ref),
            (pa, "flash_prefill_attention", pa.flash_prefill_attention_ref)]


# the prefill kernels the checked wrappers of _prefill_checks count: the
# fused routes' (PREFILL_LAUNCHES), flash kt, rows 12 and 13, and flash on
# the [B, S, nkv, hd] layout (row 15: prefill_attention's long prompts)
PREFILL_CHECKED = list(PREFILL_LAUNCHES) + [
    "flash_prefill_attention_kt", "quant_acts_i8", "w4a4_matmul_i8_swiglu",
    "flash_prefill_attention"]


def _prefill_checks(torch, n, worst):
    """[(module, name, checked wrapper)] for every prefill kernel the
    serving routes call: each launch held to its plain version on the same
    inputs (the GEMM and quant_acts_i8 bit-exact, flash kt and flash
    within the 'flash' tolerance, w4a4_matmul_i8_swiglu 'identity', the
    rest within the 'orthogonal' tolerances of
    flatquant_torch/kernels/tolerance.py), counted in n[name] with the
    largest error in worst[name]."""
    from flatquant_torch.kernels import attn_prologue as ap
    from flatquant_torch.kernels import flat_pipeline as fp
    from flatquant_torch.kernels import int4_matmul
    from flatquant_torch.kernels import prefill_attention as pa
    from flatquant_torch.kernels.tolerance import (
        compare_bf16, compare_codes, compare_kv, compare_scales)
    from flatquant_torch.serving import engine, quantized

    mode = "orthogonal"

    def qa(x, clip=None, q_max=7):
        q, s = int4_matmul.quant_acts_i8(x, clip, q_max)
        q_ref, s_ref = int4_matmul.quant_acts_i8_ref(x, clip, q_max)
        if not (torch.equal(q, q_ref) and torch.equal(s, s_ref)):
            raise AssertionError("quant_acts_i8 not bit-exact on the path")
        n["quant_acts_i8"] += 1
        return q, s

    def swi13(xq, xs, wp, sw, out_dtype=torch.bfloat16):
        # no transform factor in this GEMM: exact integer sums, the
        # float32 epilogue's exp against torch.exp
        y = int4_matmul.w4a4_matmul_i8_swiglu(xq, xs, wp, sw, out_dtype)
        err = compare_bf16(y, int4_matmul.w4a4_matmul_i8_swiglu_ref(
            xq, xs, wp, sw, out_dtype), "identity",
            "w4a4_matmul_i8_swiglu on the path")
        worst["w4a4_matmul_i8_swiglu"] = max(worst["w4a4_matmul_i8_swiglu"],
                                             err)
        n["w4a4_matmul_i8_swiglu"] += 1
        return y

    def rms(x, w, right, eps):
        y = fp.rmsnorm_right_flat(x, w, right, eps)
        err = compare_bf16(y, fp.rmsnorm_right_flat_ref(x, w, right, eps),
                           mode, "rmsnorm_right_flat on the path")
        worst["rmsnorm_right_flat"] = max(worst["rmsnorm_right_flat"], err)
        n["rmsnorm_right_flat"] += 1
        return y

    def lq(left_t, x, clip=None, q_max=7):
        q, s = fp.left_quant_i8_flat(left_t, x, clip, q_max)
        q_ref, s_ref = fp.left_quant_i8_flat_ref(left_t, x, clip, q_max)
        compare_codes(q, q_ref, mode, "left_quant_i8_flat codes on the path")
        err = compare_scales(s, s_ref, mode,
                             "left_quant_i8_flat scales on the path")
        worst["left_quant_i8_flat"] = max(worst["left_quant_i8_flat"], err)
        n["left_quant_i8_flat"] += 1
        return q, s

    def swi(xq, xs, wp, sw, right):
        y = fp.w4a4_matmul_i8_swiglu_right(xq, xs, wp, sw, right)
        err = compare_bf16(
            y, fp.w4a4_matmul_i8_swiglu_right_ref(xq, xs, wp, sw, right),
            mode, "w4a4_matmul_i8_swiglu_right on the path")
        key = "w4a4_matmul_i8_swiglu_right"
        worst[key] = max(worst[key], err)
        n[key] += 1
        return y

    def gemm(xq, xs, wp, sw, out_dtype=torch.bfloat16):
        y = int4_matmul.w4a4_matmul_i8(xq, xs, wp, sw, out_dtype)
        if not torch.equal(y, int4_matmul.w4a8_matmul_ref(xq, xs, wp, sw,
                                                          out_dtype)):
            raise AssertionError("w4a4_matmul_i8 not bit-exact on the path")
        n["w4a4_matmul_i8"] += 1
        return y

    def pro(qkv, cos, sin, k_t, k_t_inv, kc, vc, nh, nkv, cache, pos):
        ref_cache = [t.clone() for t in cache]
        out = ap.attn_prologue(qkv, cos, sin, k_t, k_t_inv, kc, vc, nh=nh,
                               nkv=nkv, cache=cache, pos=pos)
        ref = ap.attn_prologue_ref(qkv, cos, sin, k_t, k_t_inv, kc, vc,
                                   nh=nh, nkv=nkv, cache=ref_cache, pos=pos)
        err = max(compare_bf16(out[0], ref[0], mode, "q_rot on the path"),
                  compare_bf16(out[1], ref[1], mode, "k_rot on the path"))
        compare_kv(cache[0], cache[1], ref_cache[0], ref_cache[1], mode,
                   "K cache on the path")
        compare_kv(cache[2], cache[3], ref_cache[2], ref_cache[3],
                   "identity", "V cache on the path")
        worst["attn_prologue"] = max(worst["attn_prologue"], err)
        n["attn_prologue"] += 1
        return out

    def fkt(q, kt, v, sm):
        o = pa.flash_prefill_attention_kt(q, kt, v, sm)
        err = compare_bf16(o, pa.flash_prefill_attention_kt_ref(q, kt, v, sm),
                           "flash", "flash_prefill_attention_kt on the path")
        key = "flash_prefill_attention_kt"
        worst[key] = max(worst[key], err)
        n[key] += 1
        return o

    flash_n, flash_worst = [0], [0.0]
    flash = _checked_flash(torch, flash_n, flash_worst)

    def fl(q, k, v, sm):
        o = flash(q, k, v, sm)
        n["flash_prefill_attention"] = flash_n[0]
        worst["flash_prefill_attention"] = flash_worst[0]
        return o

    return [(quantized, "rmsnorm_right_flat", rms),
            (quantized, "left_quant_i8_flat", lq),
            (quantized, "w4a4_matmul_i8_swiglu_right", swi),
            (quantized, "w4a4_matmul_i8", gemm),
            (quantized, "quant_acts_i8", qa),
            (quantized, "w4a4_matmul_i8_swiglu", swi13),
            (engine, "attn_prologue", pro),
            (engine, "left_quant_i8_flat", lq),
            (engine, "w4a4_matmul_i8", gemm),
            (engine, "flash_prefill_attention_kt", fkt),
            (pa, "flash_prefill_attention", fl)]


def _check_counts(n, expected, times, what):
    """n[name] against expected[name] (launches per layer) x times for
    every name of n."""
    for name in n:
        want = expected.get(name, 0) * times
        if n[name] != want:
            raise AssertionError(f"{what}: {name} {n[name]} launches "
                                 f"checked, expected {want}")


def check_prefill_launches(torch, cfg, fq, sp, prompt, kw,
                           expected=PREFILL_LAUNCHES):
    """Every kernel launch of one full-depth prefill over the int4 cache
    checked against its plain version on the same inputs
    (_prefill_checks) -- the path's own activations, with the model's
    orthogonal factors. expected: launches per layer of each kernel."""
    from flatquant_torch.serving import engine

    n = dict.fromkeys(PREFILL_CHECKED, 0)
    worst = dict.fromkeys(PREFILL_CHECKED, 0.0)
    with patched(_prefill_checks(torch, n, worst)):
        c = engine.init_cache(cfg, prompt.shape[0], kw["max_len"],
                              mode="int4", device=kw["device"])
        engine.serving_prefill(cfg, fq, sp, prompt, c, **kw)
    torch.cuda.synchronize()
    _check_counts(n, expected, cfg.num_layers, "the prefill")
    log(f"  every launch of a full-depth prefill vs its plain version: {n} "
        f"launches checked ('orthogonal' tolerances, flash kt and flash "
        f"'flash', w4a4_matmul_i8_swiglu 'identity'; GEMM and quant_acts_i8 "
        f"bit-exact); max abs err {worst}")
    return dict(launches=n, max_abs_err=worst)


def run_prefill_path(torch, dev, model, results, smi):
    """The fused prompt prefill at B=4, S=512 (2048 rows: every fused
    route, dense attention) over the int4 cache, then 16 greedy decode
    steps over the cache attn_prologue wrote; a 4 x 128 prefill (512 rows:
    the fused input and MLP routes, composed attention); a profile of one
    prefill; every launch checked; logits against the same routes with
    every kernel swapped for its plain version."""
    from flatquant_torch.kernels import common
    from flatquant_torch.serving import engine
    from flatquant_torch.serving.engine import (
        init_cache, serving_decode_step, serving_prefill)

    B, S, NEW, SHORT, MAX_LEN = 4, 512, 16, 128, 1024
    cfg, fq, sp = model
    L = cfg.num_layers
    gen = torch.Generator(device=dev).manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    kw = dict(max_len=MAX_LEN, device=dev)

    # warm-up (allocator, cuBLAS handles), not counted
    serving_prefill(cfg, fq, sp, prompt,
                    init_cache(cfg, B, MAX_LEN, mode="int4", device=dev), **kw)
    torch.cuda.synchronize()

    common.reset_launches()
    cache = init_cache(cfg, B, MAX_LEN, mode="int4", device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = serving_prefill(cfg, fq, sp, prompt, cache, **kw)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = dict(common.LAUNCHES)
    prefill_bodies = path_bodies(common, {"attn_prologue": ("mma", L)})
    feed, kernel_logits, step_ms = [], [logits.float().cpu()], []
    tok = logits.argmax(-1, keepdim=True)
    for i in range(NEW):
        feed.append(tok)
        t0 = time.perf_counter()
        logits, cache = serving_decode_step(cfg, fq, sp, tok, cache, S + i,
                                            **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        kernel_logits.append(logits.float().cpu())
        tok = logits.argmax(-1, keepdim=True)
    launches = dict(common.LAUNCHES)
    for name, per_layer in PREFILL_LAUNCHES.items():
        if prefill_launches[name] != per_layer * L:
            raise AssertionError(
                f"{name}: {prefill_launches[name]} launches in the prefill, "
                f"expected {per_layer * L}")
    if launches["decode_attention_int4"] != NEW * L:
        raise AssertionError("the decode steps did not read the cache "
                             "through decode_attention_int4")

    # 512 rows at S=128: fused input and MLP routes, composed attention
    before = dict(common.LAUNCHES)
    short = init_cache(cfg, B, SHORT, mode="int4", device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    short_logits, _ = serving_prefill(cfg, fq, sp, prompt[:, :SHORT], short,
                                      max_len=SHORT, device=dev)
    torch.cuda.synchronize()
    short_ms = (time.perf_counter() - t0) * 1e3
    short_launches = {k: common.LAUNCHES[k] - before[k] for k in before}
    want = {"rmsnorm_right_flat": 2 * L, "left_quant_i8_flat": 3 * L,
            "w4a4_matmul_i8_swiglu_right": L, "attn_prologue": 0,
            "w4a4_matmul_i8": 3 * L}
    if any(short_launches[k] != v for k, v in want.items()):
        raise AssertionError(f"4 x {SHORT} prefill launches "
                             f"{short_launches}, expected {want}")
    if not torch.isfinite(short_logits).all():
        raise AssertionError("4 x 128 prefill logits not finite")

    decode_ms = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    log(f"  [{smi}] prefill B={B} S={S} ({B * S} rows, fused routes + "
        f"prologue): {prefill_ms:.1f} ms")
    log(f"  [{smi}] decode after it, median {decode_ms:.2f} ms/step, B={B}")
    log(f"  [{smi}] prefill B={B} S={SHORT} ({B * SHORT} rows, fused input "
        f"and MLP, composed attention): {short_ms:.1f} ms")
    log(f"  launches, 4 x {S} prefill: {prefill_launches}")
    log(f"  launches, prefill + {NEW} decode steps: {launches}")
    log(f"  launches, 4 x {SHORT} prefill: {short_launches}")
    busy = profile_steps(torch, lambda i: serving_prefill(
        cfg, fq, sp, prompt,
        init_cache(cfg, B, MAX_LEN, mode="int4", device=dev), **kw),
        1, "prefill")
    if busy:
        busy["idle_share_unprofiled"] = 1 - busy["busy_ms"] / prefill_ms
        log(f"  device idle share against the unprofiled prefill: "
            f"{busy['idle_share_unprofiled']:.3f}")
    checks = check_prefill_launches(torch, cfg, fq, sp, prompt, kw)

    def forced(pairs, use_kernel=True):
        """Teacher-forced run over the kernel run's tokens -> logits."""
        with patched(pairs):
            c = init_cache(cfg, B, MAX_LEN, mode="int4", device=dev)
            lg, c = serving_prefill(cfg, fq, sp, prompt, c,
                                    use_kernel=use_kernel, **kw)
            out = [lg.float().cpu()]
            for i, t in enumerate(feed):
                lg, c = serving_decode_step(cfg, fq, sp, t, c, S + i,
                                            use_kernel=use_kernel, **kw)
                out.append(lg.float().cpu())
        return out

    def cosines(xs, ys):
        return [torch.nn.functional.cosine_similarity(a, b, dim=-1).min()
                .item() for a, b in zip(xs, ys)]

    plain = forced(_plain_pairs(torch))
    # the noise floor: the composed routes (use_kernel=False), another
    # valid rounding of the same function
    composed = forced([], use_kernel=False)
    for a in kernel_logits + plain + composed:
        if not (torch.isfinite(a).all() and a.shape == (B, cfg.vocab_size)):
            raise AssertionError("logits not finite or of the wrong shape")
    cos, cos0 = cosines(kernel_logits, plain), cosines(composed, plain)
    mean = lambda v: sum(v) / len(v)
    log(f"  kernels vs the same routes' plain versions, teacher-forced, "
        f"prefill + {NEW} steps: logits cosine mean {mean(cos):.4f} min "
        f"{min(cos):.4f}; noise floor (composed routes vs plain): mean "
        f"{mean(cos0):.4f} min {min(cos0):.4f}")
    if mean(cos) < mean(cos0) - COSINE_MARGIN:
        raise AssertionError("kernel path drifts from its plain versions "
                             "beyond the composed-route noise floor")
    results["prefill_path"] = dict(
        model="llama-2-7b", layers=L, batch=B, prompt=S, new_tokens=NEW,
        max_len=MAX_LEN, prefill_ms=prefill_ms, decode_ms_per_step=decode_ms,
        step_ms=step_ms, short_prompt=SHORT, short_prefill_ms=short_ms,
        prefill_launches=prefill_launches, launches=launches,
        short_launches=short_launches, prefill_profile=busy,
        prefill_bodies=prefill_bodies, logits_cosine=cos,
        noise_floor_cosine=cos0,
        per_launch_checks=checks)
    return prefill_launches


# ---------------------------------------------------------------------------
# phase 6: long prompts at full llama-2-7b width and depth
# ---------------------------------------------------------------------------

# launches of one full-depth 1 x 2048 prefill over the int4 cache: the
# 4 x 512 prefill's, plus one flash kt attention per layer
LONG_PREFILL_LAUNCHES = dict(PREFILL_LAUNCHES, flash_prefill_attention_kt=1)
# the tripwire of path (b) against path (a): random W4A4 logits are
# chaotic, so rounding variants of the same prefill gave last-position
# cosines of 0.38 and 0.54, and (a) on an unrelated prompt ending in the
# same token -0.02 (PERF.md, phase 6b)
LONG_COSINE_FLOOR = 0.2
# path (c) against the same path with every flash launch swapped for its
# plain version: no quantizer amplifies the p roundings of a bf16 model
BF16_COSINE_FLOOR = 0.99
# path (b) layer by layer: each serving_layer call against the same layer
# from the same input on JAX's composed routes (use_kernel=False) with
# each kernel's plain version, flash's being flash_prefill_attention_ref
# (use_kernel=False alone would attend through JAX's float32 oracle, a
# rounding variant that random W4A4 layers amplify to 0.2-0.3 of their
# update). ||kernel - plain|| / ||plain|| over the whole layer, of its
# update (output minus input) and of the K and V cache rows it wrote. The
# two sides round apart (fused against composed routes, kernels against
# plain versions), and random W4A4 layers amplify the codes that move by
# one step: on the card the updates read 0.145-0.271, the caches 0.005.
# A wrong layout, mask or cache write moves them by order 1 (1.4 for
# uncorrelated rows; 0.65-1.5 for rolled kv heads or a missing diagonal
# mask in a CPU rehearsal) (PERF.md, phase 6b)
LAYER_REL_LIMIT = 0.5


def _cosine(torch, a, b):
    return torch.nn.functional.cosine_similarity(
        a.double().flatten(), b.double().flatten(), dim=0).item()


def _rel(torch, got, want):
    """||got - want|| / ||want|| over the whole tensor, and the largest of
    the same per token row [B, S, ...]."""
    g = got.float().reshape(got.shape[0] * got.shape[1], -1)
    w = want.float().reshape(g.shape)
    rows = (g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
    return ((g - w).norm() / w.norm().clamp_min(1e-30)).item(), \
        rows.max().item()


def _checked_layer(torch, rec):
    """serving_layer that also runs the same layer on its plain versions
    from the same input into a scratch cache pair (LAYER_REL_LIMIT), and
    appends to rec its measure, over the layer and at the worst token row,
    of the layer's update and of the K and V cache rows written. The plain
    run launches no kernel."""
    from flatquant_torch.kernels import prefill_attention as pa
    from flatquant_torch.serving import engine

    layer = engine.serving_layer

    def run(cfg, fq, sl, x, cos, sin, ck, cv, pos, phase, use_kernel,
            compute_dtype=torch.bfloat16, **kw):
        y = layer(cfg, fq, sl, x, cos, sin, ck, cv, pos, phase, use_kernel,
                  compute_dtype, **kw)
        pk, pv = torch.zeros_like(ck), torch.zeros_like(cv)
        with patched([(pa, "flash_prefill_ref",
                       pa.flash_prefill_attention_ref)]):
            yp = layer(cfg, fq, sl, x, cos, sin, pk, pv, pos, phase, False,
                       compute_dtype, **kw)
        S = x.shape[1]
        r = {}
        for key, got, want in (
                ("update", y - x, yp - x),
                ("k", ck[:, pos:pos + S], pk[:, pos:pos + S]),
                ("v", cv[:, pos:pos + S], pv[:, pos:pos + S])):
            r[key], r[key + "_worst_row"] = _rel(torch, got, want)
        rec.append(r)
        return y

    return run


def _checked_flash(torch, n, worst):
    """flash_prefill_attention that holds every launch to its plain
    version ('flash' tolerance), counting the checks in n."""
    from flatquant_torch.kernels import prefill_attention as pa
    from flatquant_torch.kernels.tolerance import compare_bf16

    kernel, plain = pa.flash_prefill_attention, pa.flash_prefill_attention_ref

    def flash(q, k, v, sm):
        o = kernel(q, k, v, sm)
        err = compare_bf16(o, plain(q, k, v, sm), "flash",
                           "flash_prefill_attention on the path")
        worst[0] = max(worst[0], err)
        n[0] += 1
        return o

    return flash


# phases 6a and 8: rounds of the 1 x 2048 prefill with row 1 forced to
# its stream body and on the route (the tile body at M = 2048)
ROUTE_ROUNDS = 3


def _prefill_timer(torch, model, prompt, kw):
    """() -> (last-position logits, wall ms) of one serving_prefill of
    `prompt` over a fresh int4 cache, up to torch.cuda.synchronize()."""
    from flatquant_torch.serving.engine import init_cache, serving_prefill

    cfg, fq, sp = model

    def prefill():
        c = init_cache(cfg, prompt.shape[0], kw["max_len"], mode="int4",
                       device=kw["device"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, _ = serving_prefill(cfg, fq, sp, prompt, c, **kw)
        torch.cuda.synchronize()
        return lg, (time.perf_counter() - t0) * 1e3

    return prefill


def compare_routes(torch, prefill, label, smi):
    """prefill() -> (last-position logits, wall ms) of one prefill. Runs it
    with every row-1 launch forced to the stream body and on the normal
    route in ROUTE_ROUNDS interleaved rounds of (stream, tile, tile,
    stream), after one warm-up of each; every run's logits must equal the
    first stream run's bit for bit (both bodies are exact), each route
    must have taken only its body, and the tile route must be faster in
    every round (sum of its two runs against the stream route's)."""
    from flatquant_torch.kernels import common

    def run(body):
        before = dict(common.BODY_LAUNCHES["w4a4_matmul_i8"])
        with (forced_body("stream") if body == "stream"
              else contextlib.nullcontext()):
            lg, ms = prefill()
        took = {b: common.BODY_LAUNCHES["w4a4_matmul_i8"][b] - before[b]
                for b in BODIES}
        if took[body] == 0 or sum(took.values()) != took[body]:
            raise AssertionError(f"{label}: the {body} route launched row 1's "
                                 f"bodies {took}")
        return lg, ms, took

    ref, _, took_s = run("stream")
    lg, _, took_t = run("tile")
    if not torch.equal(lg, ref):
        raise AssertionError(f"{label}: the tile route's logits differ from "
                             "the stream route's")
    rounds = []
    for _ in range(ROUTE_ROUNDS):
        walls = {"stream": [], "tile": []}
        for body in ("stream", "tile", "tile", "stream"):
            lg, ms, _ = run(body)
            if not torch.equal(lg, ref):
                raise AssertionError(f"{label}: a {body}-route prefill's "
                                     "logits differ from the first run's")
            walls[body].append(ms)
        rounds.append(dict(walls, ratio=sum(walls["tile"])
                           / sum(walls["stream"])))
    log(f"  [{smi}] {label}, row 1 on the stream body vs the route (tile "
        f"body; {took_t['tile']} row-1 launches, the stream route "
        f"{took_s['stream']}), {ROUTE_ROUNDS} interleaved rounds: stream "
        f"{[[round(w, 1) for w in r['stream']] for r in rounds]} ms, tile "
        f"{[[round(w, 1) for w in r['tile']] for r in rounds]} ms, tile / "
        f"stream by round {[round(r['ratio'], 4) for r in rounds]}; logits "
        "bit-identical")
    slower = [i for i, r in enumerate(rounds) if r["ratio"] >= 1]
    if slower:
        raise AssertionError(f"{label}: the tile route was not faster in "
                             f"rounds {slower}")
    return dict(rounds=rounds, row1_launches=took_t["tile"],
                logits_equal=True)


def run_long_prefill_path(torch, dev, model, results, smi):
    """fulldepth_bench.py's protocol on the int4-cache engine: (a) a 1 x
    2048 prompt (max_len 2304) through serving_prefill (fused routes,
    prologue, flash kt), then 32 greedy decode steps over the cache the
    prologue wrote; a profile of one prefill; every launch of one prefill
    checked. (b) serving_all_logits on the same tokens through the
    bf16-cache engine with use_kernel=True (composed attention input,
    flash on the [B, S, nkv, hd] layout), every flash launch checked,
    every layer against the same layer on its plain versions from the same
    input (LAYER_REL_LIMIT), its last-position logits against (a)'s.
    Returns the launches of (a) and of (b)."""
    from flatquant_torch.kernels import common
    from flatquant_torch.kernels import prefill_attention as pa
    from flatquant_torch.serving import engine
    from flatquant_torch.serving.engine import (
        init_cache, serving_all_logits, serving_decode_step, serving_prefill)

    B, S, NEW, MAX_LEN = 1, 2048, 32, 2304
    cfg, fq, sp = model
    L = cfg.num_layers
    gen = torch.Generator(device=dev).manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    kw = dict(max_len=MAX_LEN, device=dev)

    # warm-up (allocator, cuBLAS handles), not counted
    serving_prefill(cfg, fq, sp, prompt,
                    init_cache(cfg, B, MAX_LEN, mode="int4", device=dev), **kw)
    torch.cuda.synchronize()

    # (a) the int4-cache engine
    common.reset_launches()
    cache = init_cache(cfg, B, MAX_LEN, mode="int4", device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits_a, cache = serving_prefill(cfg, fq, sp, prompt, cache, **kw)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = dict(common.LAUNCHES)
    prefill_bodies = path_bodies(common, {"attn_prologue": ("mma", L)})
    step_ms = []
    tok = logits_a.argmax(-1, keepdim=True)
    for i in range(NEW):
        t0 = time.perf_counter()
        logits, cache = serving_decode_step(cfg, fq, sp, tok, cache, S + i,
                                            **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(logits).all():
            raise AssertionError(f"decode step {i} logits not finite")
        tok = logits.argmax(-1, keepdim=True)
    launches_a = dict(common.LAUNCHES)
    del cache
    for name, per_layer in LONG_PREFILL_LAUNCHES.items():
        if prefill_launches[name] != per_layer * L:
            raise AssertionError(
                f"{name}: {prefill_launches[name]} launches in the 1 x {S} "
                f"prefill, expected {per_layer * L}")
    if launches_a["decode_attention_int4"] != NEW * L:
        raise AssertionError("the decode steps did not read the cache "
                             "through decode_attention_int4")
    decode_ms = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    log(f"  [{smi}] (a) int4 engine prefill B={B} S={S} (fused routes, "
        f"prologue, flash kt): {prefill_ms:.1f} ms")
    log(f"  [{smi}] (a) decode after it, median {decode_ms:.2f} ms/step, "
        f"B={B}, {NEW} steps")
    log(f"  launches, (a) 1 x {S} prefill: {prefill_launches}")
    log(f"  launches, (a) prefill + {NEW} decode steps: {launches_a}; row 1 "
        f"by body: {common.BODY_LAUNCHES['w4a4_matmul_i8']}")

    routes = compare_routes(torch, _prefill_timer(torch, model, prompt, kw),
                            f"(a) 1 x {S} prefill", smi)
    busy = profile_steps(torch, lambda i: serving_prefill(
        cfg, fq, sp, prompt,
        init_cache(cfg, B, MAX_LEN, mode="int4", device=dev), **kw),
        1, f"(a) prefill 1 x {S}")
    if busy:
        busy["idle_share_unprofiled"] = 1 - busy["busy_ms"] / prefill_ms
        log(f"  device idle share against the unprofiled prefill: "
            f"{busy['idle_share_unprofiled']:.3f}")
    checks = check_prefill_launches(torch, cfg, fq, sp, prompt, kw,
                                    LONG_PREFILL_LAUNCHES)
    # another valid rounding of (a): the same engine on the plain versions
    logits_plain, _ = serving_prefill(
        cfg, fq, sp, prompt,
        init_cache(cfg, B, MAX_LEN, mode="int4", device=dev),
        use_kernel=False, **kw)

    # a control for the tripwire below: (a) on an unrelated prompt that
    # ends in the same token
    other = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                          device=dev)
    other[:, -1] = prompt[:, -1]
    logits_other, _ = serving_prefill(
        cfg, fq, sp, other,
        init_cache(cfg, B, MAX_LEN, mode="int4", device=dev), **kw)

    # (b) the bf16-cache engine's full-sequence logits, every flash launch
    # checked against its plain version and every layer against the same
    # layer on its plain versions
    n, worst, layers = [0], [0.0], []
    common.reset_launches()
    with patched([(pa, "flash_prefill_attention",
                   _checked_flash(torch, n, worst)),
                  (engine, "serving_layer", _checked_layer(torch, layers))]):
        t0 = time.perf_counter()
        all_logits = serving_all_logits(cfg, fq, sp, prompt, use_kernel=True,
                                        device=dev)
        torch.cuda.synchronize()
        all_ms = (time.perf_counter() - t0) * 1e3
    launches_b = dict(common.LAUNCHES)
    if launches_b["flash_prefill_attention"] != L or n[0] != L:
        raise AssertionError(
            f"serving_all_logits: {launches_b['flash_prefill_attention']} "
            f"flash launches ({n[0]} checked), expected {L}")
    if not (tuple(all_logits.shape) == (B, S, cfg.vocab_size)
            and torch.isfinite(all_logits).all()):
        raise AssertionError("serving_all_logits: not finite or of the "
                             "wrong shape")
    for a in (logits_a, logits_plain, logits_other):
        if not (torch.isfinite(a).all() and a.shape == (B, cfg.vocab_size)):
            raise AssertionError("prefill logits not finite or of the wrong "
                                 "shape")
    cos_ab = _cosine(torch, all_logits[:, -1], logits_a)
    cos_noise = _cosine(torch, logits_plain, logits_a)
    cos_control = _cosine(torch, logits_other, logits_a)
    layer_worst = {key: max(r[key] for r in layers) for key in layers[0]}
    log(f"  (b) serving_all_logits B={B} S={S}, use_kernel=True: "
        f"{all_ms:.1f} ms (with the per-launch and per-layer checks); "
        f"{n[0]} flash launches checked ('flash' tolerance, max abs err "
        f"{worst[0]:.3e})")
    log(f"  (b) {len(layers)} layers against the same layers on their plain "
        f"versions, ||kernel - plain|| / ||plain|| (limit "
        f"{LAYER_REL_LIMIT} on update, k, v; worst rows not gated), the "
        f"largest over the layers: {layer_worst}; update by layer: "
        f"{[round(r['update'], 4) for r in layers]}")
    log(f"  launches, (b): {launches_b}")
    log(f"  last-position logits cosine, (b) vs (a): {cos_ab:.4f} (floor "
        f"{LONG_COSINE_FLOOR}); (a) on the plain versions vs (a): "
        f"{cos_noise:.4f}; control, (a) on an unrelated prompt ending in the "
        f"same token vs (a): {cos_control:.4f} (neither gated)")
    if len(layers) != L or max(layer_worst[key] for key in
                               ("update", "k", "v")) > LAYER_REL_LIMIT:
        raise AssertionError(
            f"serving_all_logits: {len(layers)} layers checked, worst "
            f"{layer_worst} against the limit {LAYER_REL_LIMIT}")
    if cos_ab < LONG_COSINE_FLOOR:
        raise AssertionError("serving_all_logits' last position does not "
                             "follow the int4 engine's prefill")
    results["long_prefill_path"] = dict(
        model="llama-2-7b", layers=L, batch=B, prompt=S, new_tokens=NEW,
        max_len=MAX_LEN, prefill_ms=prefill_ms, decode_ms_per_step=decode_ms,
        step_ms=step_ms, prefill_launches=prefill_launches,
        launches=launches_a, prefill_bodies=prefill_bodies,
        prefill_profile=busy, per_launch_checks=checks,
        row1_routes=routes, all_logits_ms_checked=all_ms, all_logits_launches=launches_b,
        all_logits_flash_max_abs_err=worst[0], all_logits_layers=layers,
        all_logits_layer_worst=layer_worst, cosine_b_vs_a=cos_ab,
        cosine_plain_vs_a=cos_noise, cosine_control_vs_a=cos_control)
    return prefill_launches, launches_b


def run_bf16_comparator(torch, dev, results, smi):
    """(c) The bf16 comparator at the same shape: a random bf16 llama-2-7b
    (seed 0), bf16_prefill 1 x 2048 and 32 bf16_decode_steps over the bf16
    cache (max_len 2304), timed; a profile of one prefill; every flash
    launch of one prefill checked against its plain version, and its
    logits against the same prefill with every flash launch swapped for
    its plain version. The model is freed afterwards. Returns the
    launches of the timed prefill and decode steps."""
    from flatquant_torch.kernels import common
    from flatquant_torch.kernels import prefill_attention as pa
    from flatquant_torch.models.config import get_config
    from flatquant_torch.models.llama import init_params
    from flatquant_torch.serving.baseline import (
        bf16_decode_step, bf16_prefill, build_bf16_params)
    from flatquant_torch.serving.engine import init_cache

    B, S, NEW, MAX_LEN = 1, 2048, 32, 2304
    cfg = get_config("llama-2-7b")
    L = cfg.num_layers
    t0 = time.perf_counter()
    bp = build_bf16_params(cfg, init_params(cfg, seed=0,
                                            dtype=torch.bfloat16, device=dev))
    torch.cuda.synchronize()
    log(f"  built bf16 llama-2-7b, {L} layers, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card in "
        f"all, {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    kw = dict(max_len=MAX_LEN, device=dev)
    bf16_prefill(cfg, bp, prompt, init_cache(cfg, B, MAX_LEN, device=dev),
                 **kw)  # warm-up, not counted
    torch.cuda.synchronize()

    common.reset_launches()
    cache = init_cache(cfg, B, MAX_LEN, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = bf16_prefill(cfg, bp, prompt, cache, **kw)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = dict(common.LAUNCHES)
    step_ms = []
    tok = logits.argmax(-1, keepdim=True)
    for i in range(NEW):
        t0 = time.perf_counter()
        lg, cache = bf16_decode_step(cfg, bp, tok, cache, S + i, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if not torch.isfinite(lg).all():
            raise AssertionError(f"bf16 decode step {i} logits not finite")
        tok = lg.argmax(-1, keepdim=True)
    launches = dict(common.LAUNCHES)
    del cache
    if prefill_launches["flash_prefill_attention"] != L:
        raise AssertionError(
            f"bf16_prefill: {prefill_launches['flash_prefill_attention']} "
            f"flash launches, expected {L}")
    decode_ms = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    log(f"  [{smi}] (c) bf16 comparator prefill B={B} S={S}: "
        f"{prefill_ms:.1f} ms")
    log(f"  [{smi}] (c) bf16 comparator decode, median {decode_ms:.2f} "
        f"ms/step, B={B}, {NEW} steps")
    log(f"  launches, (c) prefill + {NEW} decode steps: {launches}")
    busy = profile_steps(torch, lambda i: bf16_prefill(
        cfg, bp, prompt, init_cache(cfg, B, MAX_LEN, device=dev), **kw),
        1, f"(c) bf16 prefill 1 x {S}")
    if busy:
        busy["idle_share_unprofiled"] = 1 - busy["busy_ms"] / prefill_ms
    n, worst = [0], [0.0]
    with patched([(pa, "flash_prefill_attention",
                   _checked_flash(torch, n, worst))]):
        checked, _ = bf16_prefill(cfg, bp, prompt,
                                  init_cache(cfg, B, MAX_LEN, device=dev),
                                  **kw)
    with patched([(pa, "flash_prefill_attention",
                   pa.flash_prefill_attention_ref)]):
        plain, _ = bf16_prefill(cfg, bp, prompt,
                                init_cache(cfg, B, MAX_LEN, device=dev), **kw)
    torch.cuda.synchronize()
    if n[0] != L:
        raise AssertionError(f"{n[0]} flash launches checked, expected {L}")
    cos = _cosine(torch, checked, plain)
    log(f"  (c) every flash launch of a prefill vs its plain version: {n[0]} "
        f"checked ('flash' tolerance, max abs err {worst[0]:.3e}); logits "
        f"cosine against the prefill on the plain flash version {cos:.6f} "
        f"(floor {BF16_COSINE_FLOOR})")
    if not (torch.isfinite(checked).all() and cos >= BF16_COSINE_FLOOR):
        raise AssertionError("bf16 comparator logits off their plain "
                             "versions'")
    results["bf16_comparator"] = dict(
        model="llama-2-7b bf16", layers=L, batch=B, prompt=S, new_tokens=NEW,
        max_len=MAX_LEN, prefill_ms=prefill_ms, decode_ms_per_step=decode_ms,
        step_ms=step_ms, prefill_launches=prefill_launches, launches=launches,
        prefill_profile=busy, flash_max_abs_err=worst[0],
        logits_cosine_vs_plain_flash=cos)
    del bp
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 7: the continuous batcher at full llama-2-7b width and depth
# ---------------------------------------------------------------------------

# the requests of runs (a) and (b): prompt lengths and max_new_tokens
BATCH_PROMPTS = [48, 300, 1100, 96, 700, 1500, 200, 40]
BATCH_NEW = [32, 24, 16, 32, 24, 16, 32, 24]
BATCH_MAX_LEN, BATCH_SLOTS = 2048, 4


def _checked_batch_attention(torch, n, worst):
    """(module, name, wrapper) for the engine's calls of rows 9-11: every
    launch held to its plain version on the same inputs (ATTN_TOL), and
    each paged launch bit for bit to its slot twin on the gathered cache.
    n / worst: checks and largest abs error per kernel."""
    from flatquant_torch.kernels import kv_cache as kv
    from flatquant_torch.kernels import paged_kv as pk
    from flatquant_torch.serving import engine

    def note(name, got, want):
        torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL)
        worst[name] = max(worst[name],
                          (got.float() - want.float()).abs().max().item())
        n[name] += 1

    def chunk(q, kp, kpar, vp, vpar, pos, sm):
        y = kv.chunk_attention_int4(q, kp, kpar, vp, vpar, pos, sm)
        note("chunk_attention_int4", y,
             kv.chunk_attention_ref(q, kp, kpar, vp, vpar, pos, sm))
        return y

    def pdecode(q, kp, kpar, vp, vpar, tbl, valid, sm):
        y = pk.paged_decode_attention_int4(q, kp, kpar, vp, vpar, tbl, valid,
                                           sm)
        note("paged_decode_attention_int4", y,
             pk.paged_decode_attention_ref(q, kp, kpar, vp, vpar, tbl, valid,
                                           sm))
        slot = _slot_view(torch, kp, kpar, vp, vpar, tbl)
        if not torch.equal(y, kv.decode_attention_int4(q, *slot, valid, sm)):
            raise AssertionError("paged decode differs from the slot kernel "
                                 "on the path")
        return y

    def pchunk(q, kp, kpar, vp, vpar, tbl, pos, sm):
        y = pk.paged_chunk_attention_int4(q, kp, kpar, vp, vpar, tbl, pos, sm)
        note("paged_chunk_attention_int4", y,
             pk.paged_chunk_attention_ref(q, kp, kpar, vp, vpar, tbl, pos,
                                          sm))
        slot = _slot_view(torch, kp, kpar, vp, vpar, tbl)
        if not torch.equal(y, kv.chunk_attention_int4(q, *slot, pos, sm)):
            raise AssertionError("paged chunk differs from the slot kernel "
                                 "on the path")
        return y

    return [(engine, "chunk_attention_int4", chunk),
            (engine, "paged_decode_attention_int4", pdecode),
            (engine, "paged_chunk_attention_int4", pchunk)]


def _serve(torch, dev, model, requests, **kw):
    """One ContinuousBatcher run (use_kernel=True, bf16 compute, 4 slots,
    max_len 2048) over requests [(prompt, max_new_tokens)], launch counts
    set to 0 just before and read just after. Returns (tokens by request
    in submission order, record)."""
    from flatquant_torch.kernels import common
    from flatquant_torch.serving.batcher import ContinuousBatcher

    cfg, fq, sp = model
    b = ContinuousBatcher(cfg, fq, sp, batch_slots=BATCH_SLOTS,
                          max_len=BATCH_MAX_LEN, use_kernel=True,
                          compute_dtype=torch.bfloat16, device=dev, **kw)
    times = {"decode": [], "chunk": [], "prefill": []}

    def timed(name, fn):
        def run(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    b._decode_multi = timed("decode", b._decode_multi)
    b._chunk_one = timed("chunk", b._chunk_one)
    b._prefill_one = timed("prefill", b._prefill_one)
    rids = [b.submit(p, m) for p, m in requests]
    torch.cuda.synchronize()
    common.reset_launches()
    t0 = time.perf_counter()
    out = b.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in common.LAUNCHES.items() if v}
    if set(out) != set(rids):
        raise AssertionError(f"served {sorted(out)} of {rids}")
    toks = [out[r] for r in rids]
    for t, (_, m) in zip(toks, requests):
        if len(t) != m or not all(0 <= x < cfg.vocab_size for x in t):
            raise AssertionError(f"request served {len(t)} of {m} tokens, or "
                                 "a token outside the vocabulary")
    free = None
    if b.cache_mode == "paged":
        free = b.alloc.free_count
        if free != b.alloc.n_blocks - 1:
            raise AssertionError(f"{free} of {b.alloc.n_blocks - 1} pool "
                                 "blocks back in the allocator")
    med = lambda v: sorted(v)[len(v) // 2] if v else None
    n_out = sum(len(t) for t in toks)
    rec = dict(requests=len(requests), wall_s=wall, output_tokens=n_out,
               tokens_per_s=n_out / wall, decode_steps=len(times["decode"]),
               decode_ms_median=med(times["decode"]),
               chunks=len(times["chunk"]), chunk_ms_median=med(times["chunk"]),
               prefills=len(times["prefill"]),
               prefill_ms_median=med(times["prefill"]), launches=launches,
               pool_blocks=(None if free is None else b.alloc.n_blocks),
               options={k: getattr(v, "__name__", v) for k, v in kw.items()})
    return toks, rec


def run_batcher_path(torch, dev, model, results, smi):
    """The continuous batcher over the full-depth model: (a) int4 slot
    cache, chunked prefill of 256; (b) the same requests over the paged
    pool (block 256, the default half-capacity pool of 17 blocks: 16
    usable against reservations of 20, so admission defers); (c) and (d)
    int4 and paged, bucketed prefill of 128, the first four requests; (e)
    the bf16 cache, chunked, two requests. Then (a) and (b) again with
    every launch of rows 9-11 held to its plain version (and each paged
    launch to its slot twin), their tokens equal to the unchecked runs'.
    Checks: (b) = (a) and (d) = (c) token for token, every request served
    in full, every pool block returned. Returns {run: launches}."""
    cfg = model[0]
    gen = torch.Generator().manual_seed(7)
    reqs = [(torch.randint(0, cfg.vocab_size, (n,), generator=gen)
             .to(torch.int32).numpy(), m)
            for n, m in zip(BATCH_PROMPTS, BATCH_NEW)]
    runs = {
        "batcher_int4": ("(a) int4, chunks of 256", reqs,
                         dict(cache_mode="int4", prefill_chunk=256)),
        "batcher_paged": ("(b) paged, chunks of 256, block 256, default pool",
                          reqs, dict(cache_mode="paged", prefill_chunk=256,
                                     block_size=256)),
        "batcher_int4_bucket": ("(c) int4, buckets of 128", reqs[:4],
                                dict(cache_mode="int4", prefill_bucket=128)),
        "batcher_paged_bucket": ("(d) paged, buckets of 128, block 256",
                                 reqs[:4], dict(cache_mode="paged",
                                                prefill_bucket=128,
                                                block_size=256)),
        "batcher_bf16": ("(e) bf16 cache, chunks of 256", reqs[:2],
                         dict(cache_mode="bf16", prefill_chunk=256)),
    }
    toks, recs, paths = {}, {}, {}
    for key, (label, rq, kw) in runs.items():
        toks[key], rec = _serve(torch, dev, model, rq, **kw)
        recs[key] = rec
        paths[key] = rec["launches"]
        dm, cm = rec["decode_ms_median"], rec["chunk_ms_median"]
        log(f"  [{smi}] phase 7 {label}: {rec['requests']} requests, wall "
            f"{rec['wall_s']:.2f} s, {rec['output_tokens']} output tokens, "
            f"{rec['tokens_per_s']:.2f} tokens/s; decode step median "
            f"{dm:.2f} ms ({rec['decode_steps']} steps); chunk median "
            f"{'-' if cm is None else f'{cm:.2f} ms'} ({rec['chunks']} "
            f"chunks); prefills {rec['prefills']}; launches {rec['launches']}"
            + ("" if rec["pool_blocks"] is None else
               f"; all {rec['pool_blocks'] - 1} pool blocks returned"))
        gc.collect()
        torch.cuda.empty_cache()
    for x, y in (("batcher_paged", "batcher_int4"),
                 ("batcher_paged_bucket", "batcher_int4_bucket")):
        if toks[x] != toks[y]:
            raise AssertionError(f"{x} tokens differ from {y}'s")
    log("  (b) = (a) and (d) = (c), token for token")
    for key, name in (("batcher_int4", "chunk_attention_int4"),
                      ("batcher_paged", "paged_decode_attention_int4"),
                      ("batcher_paged", "paged_chunk_attention_int4")):
        if paths[key].get(name, 0) <= 0:
            raise AssertionError(f"{name} never launched in {key}")

    # every launch of rows 9-11 in (a) and (b) against its plain version
    names = ("chunk_attention_int4", "paged_decode_attention_int4",
             "paged_chunk_attention_int4")
    n, worst = dict.fromkeys(names, 0), dict.fromkeys(names, 0.0)
    for key in ("batcher_int4", "batcher_paged"):
        label, rq, kw = runs[key]
        with patched(_checked_batch_attention(torch, n, worst)):
            checked, _ = _serve(torch, dev, model, rq, **kw)
        if checked != toks[key]:
            raise AssertionError(f"{key}: the checked run's tokens differ")
    for key, name in (("batcher_int4", "chunk_attention_int4"),
                      ("batcher_paged", "paged_decode_attention_int4"),
                      ("batcher_paged", "paged_chunk_attention_int4")):
        if n[name] != paths[key][name]:
            raise AssertionError(f"{name}: {n[name]} launches checked, "
                                 f"{paths[key][name]} in {key}")
    log(f"  every launch of rows 9-11 in (a) and (b) vs its plain version: "
        f"{n} checked (tol rtol/atol {ATTN_TOL['rtol']}; paged bit-equal to "
        f"the slot kernels); max abs err {worst}")
    busy = {key: _profile_batcher(torch, dev, model, reqs[:4], runs[key][2])
            for key in ("batcher_int4", "batcher_paged")}
    results["batcher_path"] = dict(
        model="llama-2-7b", layers=cfg.num_layers, slots=BATCH_SLOTS,
        max_len=BATCH_MAX_LEN, prompts=BATCH_PROMPTS, new_tokens=BATCH_NEW,
        runs=recs, per_launch_checks=dict(launches=n, max_abs_err=worst),
        decode_step_profiles=busy)
    return paths


def _profile_batcher(torch, dev, model, requests, kw):
    """Device time by kernel over 3 scheduler steps of a batcher whose four
    slots all decode (no chunk in flight): where a decode step's time
    goes, and the device's idle share."""
    from flatquant_torch.serving.batcher import ContinuousBatcher

    cfg, fq, sp = model
    b = ContinuousBatcher(cfg, fq, sp, batch_slots=BATCH_SLOTS,
                          max_len=BATCH_MAX_LEN, use_kernel=True,
                          compute_dtype=torch.bfloat16, device=dev, **kw)
    for p, _ in requests:
        b.submit(p, 64)
    while b.pending is not None or b.queue:
        b.step()
    return profile_steps(torch, lambda i: b.step(), 3,
                         f"batcher decode step ({kw['cache_mode']}, 4 slots)")


# ---------------------------------------------------------------------------
# phase 8: Qwen-2.5-7B in FlatQuant's balanced split (rows 12 and 13)
# ---------------------------------------------------------------------------

# launches of one full-depth 1 x 2048 prefill of Qwen-2.5-7B over the int4
# cache, per layer: the balanced split's right factors (64 for the hidden
# width, 148 for the intermediate) leave out every rn128 kernel; the
# prologue, flash kt and the o path's left quant (G = 28 heads) carry the
# attention; the MLP is the swiglu GEMM (row 13, K = 3584 < 8192: eager
# quant) and the down linear, whose input (K = 18944) takes quant_acts_i8
# (row 12); three plain GEMMs: qkv, o, down
QWEN_PREFILL_LAUNCHES = {"attn_prologue": 1, "flash_prefill_attention_kt": 1,
                         "left_quant_i8_flat": 1, "w4a4_matmul_i8_swiglu": 1,
                         "quant_acts_i8": 1, "w4a4_matmul_i8": 3}


def check_decode_attention(torch, cfg, fq, sp, prompt, kw, steps=2):
    """Every decode_attention_int4 launch of `steps` greedy decode steps
    after a prefill, against its plain version on the same inputs
    (ATTN_TOL). Returns the checks' count and largest abs error."""
    from flatquant_torch.serving import engine

    key = "decode_attention_int4"
    n, worst = {key: 0}, {key: 0.0}
    S = prompt.shape[1]
    c = engine.init_cache(cfg, prompt.shape[0], kw["max_len"], mode="int4",
                          device=kw["device"])
    logits, c = engine.serving_prefill(cfg, fq, sp, prompt, c, **kw)
    with patched([(engine, key, _checked_decode_attention(torch, n,
                                                          worst))]):
        for i in range(steps):
            logits, c = engine.serving_decode_step(
                cfg, fq, sp, logits.argmax(-1, keepdim=True), c, S + i, **kw)
    torch.cuda.synchronize()
    if n[key] != steps * cfg.num_layers:
        raise AssertionError(f"{n[key]} decode attention launches checked, "
                             f"expected {steps * cfg.num_layers}")
    log(f"  every decode_attention_int4 launch of {steps} decode steps vs its "
        f"plain version: {n[key]} checked (tol rtol/atol {ATTN_TOL['rtol']}), "
        f"max abs err {worst[key]:.3e}")
    return dict(launches=n[key], max_abs_err=worst[key])


def _timed_serving(torch, cfg, fq, sp, prompt, new, kw, mode):
    """A warm-up prefill (not counted), then serving_prefill of `prompt`
    and `new` greedy decode steps over a fresh `mode` cache, each timed on
    the host clock up to torch.cuda.synchronize(); the launch counts are
    set to 0 just before the prefill and read after it and after the
    steps; every logits row finite and of the vocabulary's width. Returns
    a dict of the times, launches and greedy tokens, with the cache and
    the next token for further steps."""
    from flatquant_torch.kernels import common
    from flatquant_torch.serving.engine import (
        init_cache, serving_decode_step, serving_prefill)

    B, S = prompt.shape
    dev, max_len = kw["device"], kw["max_len"]
    serving_prefill(cfg, fq, sp, prompt,
                    init_cache(cfg, B, max_len, mode=mode, device=dev), **kw)
    torch.cuda.synchronize()

    def checked(logits, what):
        if not (torch.isfinite(logits).all()
                and tuple(logits.shape) == (B, cfg.vocab_size)):
            raise AssertionError(f"{what} logits not finite or of the wrong "
                                 "shape")
        return logits.argmax(-1, keepdim=True)

    common.reset_launches()
    cache = init_cache(cfg, B, max_len, mode=mode, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = serving_prefill(cfg, fq, sp, prompt, cache, **kw)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_launches = dict(common.LAUNCHES)
    prefill_bodies = {k: dict(v) for k, v in common.BODY_LAUNCHES.items()}
    tok = checked(logits, "prefill")
    step_ms, toks = [], []
    for i in range(new):
        toks.append(int(tok[0, 0]))
        t0 = time.perf_counter()
        logits, cache = serving_decode_step(cfg, fq, sp, tok, cache, S + i,
                                            **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        tok = checked(logits, f"decode step {i}")
    return dict(prefill_ms=prefill_ms, prefill_launches=prefill_launches,
                prefill_bodies=prefill_bodies,
                bodies={k: dict(v) for k, v in
                        common.BODY_LAUNCHES.items()},
                launches=dict(common.LAUNCHES), step_ms=step_ms,
                decode_ms=sorted(step_ms[1:])[len(step_ms[1:]) // 2],
                tokens=toks, cache=cache, tok=tok)


def run_qwen_path(torch, dev, results, smi):
    """Qwen-2.5-7B at full width and depth (28 layers, 28/4 heads: n_rep 7,
    qkv bias), W4A4KV4 in JAX's default FlatQuant configuration (no
    tpu_decompose: the balanced Kronecker split), random seeded weights,
    over the int4 cache: serving_prefill 1 x 2048 (max_len 2304), then 32
    greedy decode steps at B=1, timed; launch counts read around them; a
    profile of one prefill; every launch of one prefill against its plain
    version (rows 12 and 13 among them); every decode attention launch of
    two steps against its plain version. The model is freed afterwards.
    Returns the launches of the timed prefill and decode steps."""
    from flatquant_torch.quantize.spec import W4A4KV4
    from flatquant_torch.serving.engine import init_cache, serving_prefill

    B, S, NEW, MAX_LEN = 1, 2048, 32, 2304
    cfg, fq, sp = build_model(torch, dev, 0, "qwen-2.5-7b", W4A4KV4)
    L = cfg.num_layers
    gen = torch.Generator(device=dev).manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    kw = dict(max_len=MAX_LEN, device=dev)
    run = _timed_serving(torch, cfg, fq, sp, prompt, NEW, kw, "int4")
    prefill_launches, launches = run["prefill_launches"], run["launches"]
    del run["cache"], run["tok"]
    for name, per_layer in dict(
            QWEN_PREFILL_LAUNCHES, rmsnorm_right_flat=0,
            w4a4_matmul_i8_swiglu_right=0).items():
        if prefill_launches[name] != per_layer * L:
            raise AssertionError(
                f"{name}: {prefill_launches[name]} launches in the Qwen "
                f"prefill, expected {per_layer * L}")
    if launches["decode_attention_int4"] != NEW * L:
        raise AssertionError("the Qwen decode steps did not read the cache "
                             "through decode_attention_int4")
    log(f"  [{smi}] Qwen-2.5-7B prefill B={B} S={S} (balanced split, rows 12 "
        f"and 13, prologue, flash kt): {run['prefill_ms']:.1f} ms")
    log(f"  [{smi}] Qwen-2.5-7B decode after it, median "
        f"{run['decode_ms']:.2f} ms/step, B={B}, {NEW} steps")
    log(f"  launches, prefill: {prefill_launches}")
    log(f"  launches, prefill + {NEW} decode steps: {launches}")
    log(f"  greedy tokens: {run['tokens']}")

    routes = compare_routes(torch, _prefill_timer(torch, (cfg, fq, sp),
                                                  prompt, kw),
                            f"Qwen-2.5-7B 1 x {S} prefill", smi)
    busy = profile_steps(torch, lambda i: serving_prefill(
        cfg, fq, sp, prompt,
        init_cache(cfg, B, MAX_LEN, mode="int4", device=dev), **kw),
        1, f"Qwen-2.5-7B prefill 1 x {S}")
    if busy:
        busy["idle_share_unprofiled"] = 1 - busy["busy_ms"] / run["prefill_ms"]
        log(f"  device idle share against the unprofiled prefill: "
            f"{busy['idle_share_unprofiled']:.3f}")
    checks = check_prefill_launches(torch, cfg, fq, sp, prompt, kw,
                                    QWEN_PREFILL_LAUNCHES)
    dchecks = check_decode_attention(torch, cfg, fq, sp, prompt, kw)
    results["qwen_path"] = dict(
        model="qwen-2.5-7b", layers=L, batch=B, prompt=S, new_tokens=NEW,
        max_len=MAX_LEN, prefill_profile=busy, per_launch_checks=checks,
        decode_attention_checks=dchecks, row1_routes=routes, **run)
    del sp
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 9: llama-2-7b weight-only W4A16 (row 14)
# ---------------------------------------------------------------------------


def _checked_w4a8(torch, n, worst):
    """w4a8_matmul that holds every launch to its plain version (the
    "identity" tolerance: float32 sums in another order), counting the
    checks in n."""
    from flatquant_torch.kernels import int4_matmul as im
    from flatquant_torch.kernels.tolerance import compare_bf16

    def w4a8(x, xs, wp, sw, out_dtype=torch.bfloat16):
        y = im.w4a8_matmul(x, xs, wp, sw, out_dtype)
        err = compare_bf16(y, im.w4a8_matmul_rowsum_ref(x, xs, wp, sw,
                                                        out_dtype),
                           "identity", "w4a8_matmul on the path")
        worst[0] = max(worst[0], err)
        n[0] += 1
        return y

    return w4a8


def run_w4a16_path(torch, dev, results, smi):
    """llama-2-7b weight-only W4A16 (FQConfig(w_bits=4, a_bits=16,
    k_bits=16, v_bits=16): every linear through w4a8_matmul on bf16
    activations with unit scales; the bf16 cache) at full width and depth,
    rebuilt from phase 4's seed in the balanced split, with the bf16
    comparator's protocol (phase 6c): a 1 x 2048 prefill (flash on the
    [B, S, nkv, hd] layout) and 32 greedy decode steps at B=1, max_len
    2304, timed; every w4a8_matmul launch of one prefill and two decode
    steps against its plain version; a profile of one decode step. The
    model is freed afterwards. Returns the launches of the timed prefill
    and decode steps."""
    from flatquant_torch.quantize.spec import FQConfig
    from flatquant_torch.serving import quantized
    from flatquant_torch.serving.engine import (
        init_cache, serving_decode_step, serving_prefill)

    B, S, NEW, MAX_LEN = 1, 2048, 32, 2304
    fq = FQConfig(w_bits=4, a_bits=16, k_bits=16, v_bits=16)
    cfg, fq, sp = build_model(torch, dev, 0, "llama-2-7b", fq)
    L = cfg.num_layers
    gen = torch.Generator(device=dev).manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    kw = dict(max_len=MAX_LEN, device=dev)
    run = _timed_serving(torch, cfg, fq, sp, prompt, NEW, kw, "bf16")
    prefill_launches, launches = run["prefill_launches"], run["launches"]
    cache, tok = run.pop("cache"), run.pop("tok")
    want = {"w4a8_matmul": 4 * L, "flash_prefill_attention": L}
    if any(prefill_launches[k] != v for k, v in want.items()) or any(
            v for k, v in prefill_launches.items() if k not in want):
        raise AssertionError(f"W4A16 prefill launches {prefill_launches}, "
                             f"expected {want} and nothing else")
    if launches["w4a8_matmul"] != 4 * L * (1 + NEW):
        raise AssertionError("the W4A16 decode steps did not run every "
                             "linear through w4a8_matmul")
    # the 2048-row prefill on the tile body, the B=1 steps on the stream
    bodies = run["bodies"]["w4a8_matmul"]
    want_bodies = dict.fromkeys(bodies, 0)
    want_bodies.update(tile=4 * L, stream=4 * L * NEW)
    if run["prefill_bodies"]["w4a8_matmul"].get("tile") != 4 * L \
            or bodies != want_bodies:
        raise AssertionError(f"w4a8_matmul launches by body {bodies}, "
                             f"expected {want_bodies}")
    log(f"  [{smi}] llama-2-7b W4A16 prefill B={B} S={S} (w4a8_matmul "
        f"wgmma tiles, flash): {run['prefill_ms']:.1f} ms")
    log(f"  [{smi}] llama-2-7b W4A16 decode after it, median "
        f"{run['decode_ms']:.2f} ms/step, B={B}, {NEW} steps (w4a8_matmul "
        f"weight stream); w4a8_matmul launches by body {bodies}")
    log(f"  launches, prefill + {NEW} decode steps: {launches}")

    # every w4a8_matmul launch of one prefill and two decode steps
    n, worst = [0], [0.0]
    with patched([(quantized, "w4a8_matmul", _checked_w4a8(torch, n,
                                                            worst))]):
        c = init_cache(cfg, B, MAX_LEN, device=dev)
        lg, c = serving_prefill(cfg, fq, sp, prompt, c, **kw)
        for i in range(2):
            lg, c = serving_decode_step(cfg, fq, sp,
                                        lg.argmax(-1, keepdim=True), c,
                                        S + i, **kw)
        torch.cuda.synchronize()
        del c
    if n[0] != 4 * L * 3:
        raise AssertionError(f"{n[0]} w4a8_matmul launches checked, "
                             f"expected {4 * L * 3}")
    log(f"  every w4a8_matmul launch of a prefill and 2 decode steps vs its "
        f"plain version: {n[0]} checked ('identity' tolerance), max abs err "
        f"{worst[0]:.3e}")
    busy = profile_steps(torch, lambda i: serving_decode_step(
        cfg, fq, sp, tok, cache, S + NEW + i, **kw), 1,
        "llama-2-7b W4A16 decode step")
    if busy:
        busy["idle_share_unprofiled"] = 1 - busy["busy_ms"] / run["decode_ms"]
        log(f"  device idle share against the unprofiled step: "
            f"{busy['idle_share_unprofiled']:.3f}")
    results["w4a16_path"] = dict(
        model="llama-2-7b W4A16", layers=L, batch=B, prompt=S,
        new_tokens=NEW, max_len=MAX_LEN, decode_profile=busy,
        per_launch_checks=dict(launches=n[0], max_abs_err=worst[0]), **run)
    del sp, cache
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 10: DeepSeek-V2-Lite, native FP8 (row 16) and packed W4A4 (row 1)
# ---------------------------------------------------------------------------

# the batcher's requests of phase 10 (b): prompt lengths, 16 new tokens each
DS_BATCH_PROMPTS = [40, 600, 200, 350, 90, 480]
DS_BATCH_NEW = 16


def _ds_cfg(cfg):
    from flatquant_torch.models.deepseek import DeepSeekConfig

    return cfg or DeepSeekConfig()


def _ds_embed_head(torch, dev, gen, cfg):
    def w():
        return (torch.randn((cfg.vocab_size, cfg.dim), generator=gen,
                            device=dev) * 0.02).to(torch.bfloat16)

    return {"embed": w(), "head": w(),
            "final_norm": torch.ones(cfg.dim, device=dev)}


def build_ds_fp8_model(torch, dev, seed, cfg=None):
    """A random DeepSeek (default DeepSeekConfig: V2-Lite's shapes, 27
    layers) in native FP8, built layer by layer: seeded N(0, 0.02^2)
    weights packed by the port's build_ds_fp8_serving_layer (128-blocks
    where they divide; wkv_a and the dense FFN fall to 64-blocks, as in
    JAX). Returns the serving params."""
    from flatquant_torch.models.deepseek import (
        build_ds_fp8_serving_layer, init_ds_layer_params)

    t0 = time.perf_counter()
    cfg = _ds_cfg(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def layer(moe):
        lp = init_ds_layer_params(cfg, moe, gen, torch.float32, dev)
        return build_ds_fp8_serving_layer(cfg, lp, moe, torch.bfloat16)

    sp = {"dense_layers": [layer(False) for _ in range(cfg.n_dense_layers)],
          "moe_layers": [layer(True) for _ in range(cfg.n_moe_layers)],
          **_ds_embed_head(torch, dev, gen, cfg)}
    torch.cuda.synchronize()
    log(f"  built {cfg.name} native FP8, {cfg.n_layers} layers "
        f"({cfg.n_routed_experts} routed experts), "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, "
        f"{time.perf_counter() - t0:.1f} s")
    return sp


def build_ds_w4a4_model(torch, dev, seed, cfg=None):
    """A random DeepSeek in packed W4A4 (FQConfig W4A4), built by the
    port's build chain layer by layer: init_ds_fq's state for every layer
    (SVD Kronecker factors in FlatQuant's balanced split with diag scales,
    LWC and LAC clips at their init), bake_ds_fq, then each layer's seeded
    weights (init_ds_layer_params) packed by build_ds_serving_layer and
    freed before the next is drawn. Returns (serving params, the baked
    (dense_fq, moe_fq))."""
    from flatquant_torch.core.kron import get_decompose_dim
    from flatquant_torch.models.deepseek import (
        bake_ds_fq, build_ds_serving_layer, init_ds_fq, init_ds_layer_params)
    from flatquant_torch.quantize.spec import W4A4

    t0 = time.perf_counter()
    cfg = _ds_cfg(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    baked = bake_ds_fq(*init_ds_fq(cfg, W4A4, seed=seed, device=dev))

    def layers(moe, states):
        return [build_ds_serving_layer(
            cfg, W4A4, init_ds_layer_params(cfg, moe, gen, torch.float32,
                                            dev), b) for b in states]

    sp = {"dense_layers": layers(False, baked[0]),
          "moe_layers": layers(True, baked[1]),
          **_ds_embed_head(torch, dev, gen, cfg)}
    torch.cuda.synchronize()
    log(f"  built {cfg.name} packed W4A4 (balanced split "
        f"{get_decompose_dim(cfg.dim)}), {cfg.n_layers} layers, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, "
        f"{time.perf_counter() - t0:.1f} s")
    return sp, baked


def _timed_generate(torch, cfg, fq, fq_cfg, sp, prompt, new, max_len, dev):
    """deepseek_generate of `prompt` with `new` greedy tokens (a prefill
    and `new` decode steps over the latent caches, serve mode, bf16,
    use_kernel=True) after a warm-up generate of one token; each step
    timed on the host clock up to torch.cuda.synchronize() (its _ds_step
    wrapped); launch counts set to 0 just before and read after the
    prefill and at the end, and the calls of fp8_linear's plain route
    (fp8_matmul_ref) counted; every logits row finite and of the
    vocabulary's width."""
    from flatquant_torch.kernels import common
    from flatquant_torch.kernels import fp8_matmul as f8
    from flatquant_torch.models import deepseek as ds

    kw = dict(max_len=max_len, mode="serve", compute_dtype=torch.bfloat16,
              device=dev)
    ds.deepseek_generate(cfg, sp, fq, fq_cfg, prompt, max_new_tokens=1, **kw)
    step, ref = ds._ds_step, f8.fp8_matmul_ref
    times, snaps, ref_calls = [], [], [0]

    def counted_ref(*a, **k):
        ref_calls[0] += 1
        return ref(*a, **k)

    def timed(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = step(*a, **k)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if not (torch.isfinite(logits).all() and tuple(logits.shape)
                == (prompt.shape[0], cfg.vocab_size)):
            raise AssertionError(f"step {len(times) - 1}: logits not finite "
                                 "or of the wrong shape")
        snaps.append((dict(common.LAUNCHES), ref_calls[0],
                      dict(common.BODY_LAUNCHES["fp8_matmul"])))
        return logits, cache

    torch.cuda.synchronize()
    common.reset_launches()
    with patched([(ds, "_ds_step", timed), (f8, "fp8_matmul_ref",
                                            counted_ref)]):
        toks = ds.deepseek_generate(cfg, sp, fq, fq_cfg, prompt,
                                    max_new_tokens=new, **kw)
    dec = sorted(times[2:])
    return dict(prefill_ms=times[0], step_ms=times[1:],
                decode_ms=dec[len(dec) // 2], tokens=toks[0].tolist(),
                prefill_launches={k: v for k, v in snaps[0][0].items() if v},
                prefill_ref_route_calls=snaps[0][1],
                launches={k: v for k, v in snaps[-1][0].items() if v},
                ref_route_calls=snaps[-1][1], fp8_bodies_prefill=snaps[0][2],
                fp8_bodies=snaps[-1][2])


def _checked_fp8(torch, n, worst):
    """fp8_matmul that holds every launch to fp8_matmul_ref on the same
    inputs (bf16 outputs within one ulp: the "identity" tolerance of
    kernels/tolerance.py), counting the checks in n."""
    from flatquant_torch.kernels import fp8_matmul as f8
    from flatquant_torch.kernels.tolerance import compare_bf16

    kernel = f8.fp8_matmul

    def fp8(x, w8, se, out_dtype=torch.bfloat16, exact=True):
        y = kernel(x, w8, se, out_dtype, exact)
        err = compare_bf16(y, f8.fp8_matmul_ref(x, w8, se, out_dtype, exact),
                           "identity", "fp8_matmul on the path")
        worst[0] = max(worst[0], err)
        n[0] += 1
        return y

    return fp8


def _checked_w4a4(torch, n):
    """w4a4_matmul_i8 held bit for bit to w4a8_matmul_ref on every launch."""
    from flatquant_torch.kernels import int4_matmul as im

    def gemm(xq, xs, wp, sw, out_dtype=torch.bfloat16):
        y = im.w4a4_matmul_i8(xq, xs, wp, sw, out_dtype)
        if not torch.equal(y, im.w4a8_matmul_ref(xq, xs, wp, sw, out_dtype)):
            raise AssertionError("w4a4_matmul_i8 not bit-exact on the path")
        n[0] += 1
        return y

    return gemm


def run_deepseek_path(torch, dev, results, smi, cfg=None):
    """DeepSeek-V2-Lite at full width and depth (the default
    DeepSeekConfig: dim 2048, 27 layers with 1 dense, 16 heads, kv_lora
    512, 64 routed experts with 6 active and 2 shared), random seeded
    weights, serve mode, bf16:
    (a) native FP8: deepseek_generate of a 1 x 2048 prompt (max_len 2304;
        the gather MoE, C = 384) and 32 greedy decode steps at B=1 (the
        dense-masked MoE), timed; launch counts read around the prefill
        and the steps; fp8_linear's plain-route calls counted (wkv_a and
        the dense FFN, packed in 64-blocks); a profile of one prefill and
        one decode step; every fp8_matmul launch of one prefill and two
        decode steps against its plain version;
    (b) the continuous batcher over (a)'s model with the DeepSeek hooks
        (ds_batch_forward, ds_init_batch_cache): 4 slots, six requests of
        40-600 prompt tokens and 16 new tokens, chunks of 256 (per-slot
        rope and masked latent writes in every decode step); tokens
        compared with single-request deepseek_generate as a tripwire;
    (c) packed W4A4 (build_ds_w4a4_model), (a)'s model freed first: a
        1 x 2048 prefill and 32 decode steps, every w4a4_matmul_i8 launch
        of one prefill bit for bit against its plain version.
    Returns {path: launches} for "deepseek_fp8", "deepseek_batcher",
    "deepseek_w4a4"."""
    from flatquant_torch.kernels import fp8_matmul as f8
    from flatquant_torch.models import deepseek as ds
    from flatquant_torch.quantize.spec import W4A4
    from flatquant_torch.serving import quantized

    cfg = _ds_cfg(cfg)
    B, S, NEW, MAX_LEN = 1, 2048, 32, 2304
    L, Lm = cfg.n_layers, cfg.n_moe_layers
    gen = torch.Generator(device=dev).manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    rec, paths = {}, {}

    # (a) native FP8
    sp = build_ds_fp8_model(torch, dev, 0, cfg)
    run = _timed_generate(torch, cfg, None, None, sp, prompt, NEW, MAX_LEN,
                          dev)
    # per forward: wq and wo in every layer, the shared s_w1/s_w3/s_w2 and
    # the expert-batched e_w1/e_w3/e_w2 (one launch each) in every MoE
    # layer; fp8_matmul_ref for wkv_a everywhere and the dense FFN
    fwd = 2 * L + 6 * Lm
    ref_fwd = L + 3 * cfg.n_dense_layers
    pl = run["prefill_launches"]
    if pl.get("fp8_matmul") != fwd or set(pl) != {"fp8_matmul"}:
        raise AssertionError(f"FP8 prefill launches {pl}, expected "
                             f"fp8_matmul {fwd} and nothing else")
    if run["launches"]["fp8_matmul"] != fwd * (1 + NEW):
        raise AssertionError("the FP8 decode steps did not run every "
                             "128-block linear through fp8_matmul")
    if (run["prefill_ref_route_calls"] != ref_fwd
            or run["ref_route_calls"] != ref_fwd * (1 + NEW)):
        raise AssertionError(f"{run['ref_route_calls']} fp8_matmul_ref "
                             f"route calls, expected {ref_fwd} per forward")
    log(f"  [{smi}] {cfg.name} FP8 prefill B={B} S={S} (gather MoE): "
        f"{run['prefill_ms']:.1f} ms")
    log(f"  [{smi}] {cfg.name} FP8 decode after it, median "
        f"{run['decode_ms']:.2f} ms/step, B={B}, {NEW} steps (dense-masked "
        "MoE)")
    log(f"  launches, prefill + {NEW} decode steps: {run['launches']}; "
        f"fp8_matmul_ref route calls {run['ref_route_calls']} "
        f"({ref_fwd} per forward: wkv_a and the dense FFN, 64-blocks)")
    log(f"  fp8_matmul launches by body: prefill {run['fp8_bodies_prefill']}, "
        f"prefill + {NEW} steps {run['fp8_bodies']}")
    log(f"  greedy tokens: {run['tokens']}")
    step_kw = dict(max_len=MAX_LEN, compute_dtype=torch.bfloat16)

    def prefill(i):
        c = ds.init_ds_cache(cfg, B, MAX_LEN, device=dev)
        return ds._ds_step(cfg, None, "serve", sp, None, prompt, c, 0,
                           **step_kw)

    busy_p = profile_steps(torch, prefill, 1, f"{cfg.name} FP8 prefill "
                           f"1 x {S}")
    lg, cache = prefill(0)
    tok = lg.argmax(-1, keepdim=True)
    busy_d = profile_steps(torch, lambda i: ds._ds_step(
        cfg, None, "serve", sp, None, tok, cache, S, **step_kw), 1,
        f"{cfg.name} FP8 decode step")
    for what, busy, ms in (("prefill", busy_p, run["prefill_ms"]),
                           ("decode step", busy_d, run["decode_ms"])):
        if busy:
            busy["idle_share_unprofiled"] = 1 - busy["busy_ms"] / ms
            row16 = busy["groups"]["fp8_matmul"]
            log(f"  device idle share against the unprofiled {what}: "
                f"{busy['idle_share_unprofiled']:.3f}; row 16 (fp8_matmul) "
                f"{row16:.2f} of {busy['busy_ms']:.2f} busy ms "
                f"({row16 / busy['busy_ms']:.3f})")
    n, worst = [0], [0.0]
    with patched([(f8, "fp8_matmul", _checked_fp8(torch, n, worst))]):
        lg, cache = prefill(0)
        for i in range(2):
            lg, cache = ds._ds_step(cfg, None, "serve", sp, None,
                                    lg.argmax(-1, keepdim=True), cache,
                                    S + i, **step_kw)
        torch.cuda.synchronize()
    del cache
    if n[0] != 3 * fwd:
        raise AssertionError(f"{n[0]} fp8_matmul launches checked, expected "
                             f"{3 * fwd}")
    log(f"  every fp8_matmul launch of a prefill and 2 decode steps vs its "
        f"plain version: {n[0]} checked ('identity' tolerance), max abs err "
        f"{worst[0]:.3e}")
    rec["fp8"] = dict(prefill_profile=busy_p, decode_profile=busy_d,
                      per_launch_checks=dict(launches=n[0],
                                             max_abs_err=worst[0]), **run)
    paths["deepseek_fp8"] = run["launches"]

    # (b) the continuous batcher with the DeepSeek hooks
    requests = [(torch.randint(0, cfg.vocab_size, (p,), generator=gen,
                               device=dev).cpu().numpy(), DS_BATCH_NEW)
                for p in DS_BATCH_PROMPTS]
    toks, brec = _serve(torch, dev, (cfg, None, {"params": sp, "fq": None}),
                        requests, prefill_chunk=256,
                        forward_fn=ds.ds_batch_forward,
                        init_cache_fn=ds.ds_init_batch_cache)
    single = [ds.deepseek_generate(cfg, sp, None, None, p[None],
                                   max_new_tokens=m, max_len=BATCH_MAX_LEN,
                                   mode="serve", device=dev)[0].tolist()
              for p, m in requests]
    first = sum(a[0] == b[0] for a, b in zip(toks, single))
    whole = sum(a == b for a, b in zip(toks, single))
    brec.update(first_tokens_equal=first, requests_equal=whole)
    log(f"  [{smi}] batcher, {len(requests)} requests "
        f"({DS_BATCH_PROMPTS} prompt tokens, {DS_BATCH_NEW} new), chunks of "
        f"256: wall {brec['wall_s']:.2f} s, {brec['tokens_per_s']:.2f} "
        f"tokens/s, median decode step {brec['decode_ms_median']:.2f} ms, "
        f"median chunk {brec['chunk_ms_median']:.2f} ms")
    log(f"  launches: {brec['launches']}")
    log(f"  tripwire against single-request deepseek_generate: first tokens "
        f"equal in {first} of {len(requests)}, whole outputs in {whole}")
    if 2 * first < len(requests):
        raise AssertionError("the batcher's first tokens disagree with "
                             "single-request generation on most requests")
    rec["batcher"] = brec
    paths["deepseek_batcher"] = brec["launches"]
    del sp
    gc.collect()
    torch.cuda.empty_cache()

    # (c) packed W4A4
    sp, fq = build_ds_w4a4_model(torch, dev, 0, cfg)
    run = _timed_generate(torch, cfg, fq, W4A4, sp, prompt, NEW, MAX_LEN,
                          dev)
    # per forward: wq, wkv_a, wo and the three dense-FFN or shared-expert
    # linears in every layer (the routed experts run plain, as in JAX)
    fwd = 6 * L if cfg.q_lora_rank == 0 else 7 * L
    pl = run["prefill_launches"]
    if pl.get("w4a4_matmul_i8") != fwd or set(pl) != {"w4a4_matmul_i8"}:
        raise AssertionError(f"W4A4 prefill launches {pl}, expected "
                             f"w4a4_matmul_i8 {fwd} and nothing else")
    if run["launches"]["w4a4_matmul_i8"] != fwd * (1 + NEW):
        raise AssertionError("the W4A4 decode steps did not run every "
                             "packed linear through w4a4_matmul_i8")
    log(f"  [{smi}] {cfg.name} W4A4 prefill B={B} S={S}: "
        f"{run['prefill_ms']:.1f} ms; decode median {run['decode_ms']:.2f} "
        f"ms/step, {NEW} steps")
    log(f"  launches, prefill + {NEW} decode steps: {run['launches']}")
    n = [0]
    with patched([(quantized, "w4a4_matmul_i8", _checked_w4a4(torch, n))]):
        c = ds.init_ds_cache(cfg, B, MAX_LEN, device=dev)
        ds._ds_step(cfg, W4A4, "serve", sp, fq, prompt, c, 0, **step_kw)
        torch.cuda.synchronize()
        del c
    if n[0] != fwd:
        raise AssertionError(f"{n[0]} w4a4_matmul_i8 launches checked, "
                             f"expected {fwd}")
    log(f"  every w4a4_matmul_i8 launch of a prefill vs its plain version: "
        f"{n[0]} checked, bit-exact")
    rec["w4a4"] = dict(per_launch_checks=dict(launches=n[0],
                                              max_abs_err=0.0), **run)
    paths["deepseek_w4a4"] = run["launches"]
    results["deepseek_path"] = dict(model=cfg.name, layers=L, batch=B,
                                    prompt=S, new_tokens=NEW,
                                    max_len=MAX_LEN, **rec)
    del sp, fq
    gc.collect()
    torch.cuda.empty_cache()
    return paths


# ---------------------------------------------------------------------------
# phase 11: rows 17-21 in place of their twins on the llama-2-7b path
# ---------------------------------------------------------------------------


def _decode_run(torch, cfg, fq, sp, prompt, new, kw):
    """Phase 4's generate protocol through the step entry points: a prefill
    over a fresh int4 cache, then `new` greedy decode steps. Returns the
    tokens [B, new], the logits of every step (prefill first) and the
    decode steps' host ms."""
    from flatquant_torch.serving.engine import (
        init_cache, serving_decode_step, serving_prefill)

    P = prompt.shape[1]
    c = init_cache(cfg, prompt.shape[0], kw["max_len"], mode="int4",
                   device=kw["device"])
    logits, c = serving_prefill(cfg, fq, sp, prompt, c, **kw)
    out, toks, step_ms = [logits], [], []
    for i in range(new):
        tok = logits.argmax(-1, keepdim=True)
        toks.append(tok)
        t0 = time.perf_counter()
        logits, c = serving_decode_step(cfg, fq, sp, tok, c, P + i, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        out.append(logits)
    return torch.cat(toks, 1), out, step_ms


def _fusedq_linear(torch, orig):
    """_quant_linear with its A4 "wp" route below 256 rows (the eager
    quant chain, then w4a4_matmul_i8) sent through w4a4_matmul_i8_fusedq;
    every other route unchanged."""
    from flatquant_torch.kernels import int4_matmul

    def linear(x2d, lin, use_kernel, out_dtype=torch.bfloat16,
               quant_acts=True, a_q_max=7, axis_name=None):
        if (use_kernel and quant_acts and a_q_max == 7 and axis_name is None
                and "wp" in lin and "w8" not in lin and x2d.shape[0] < 256):
            return int4_matmul.w4a4_matmul_i8_fusedq(
                x2d, lin["wp"], lin["scale"], lin.get("a_clip"), out_dtype)
        return orig(x2d, lin, use_kernel, out_dtype, quant_acts, a_q_max,
                    axis_name)

    return linear


def _checked_decode_baseline(torch, fn, n, worst):
    """fn (a row 19-21 entry point) holding every launch to the plain
    version (ATTN_TOL; valid_len 0 gives 0) and recording its distance to
    row 2 (decode_attention_int4) on the same inputs."""
    from flatquant_torch.kernels import kv_cache

    row2 = kv_cache.decode_attention_int4

    def attn(q, kp, kpar, vp, vpar, valid, sm):
        y = fn(q, kp, kpar, vp, vpar, valid, sm)
        ref = kv_cache.decode_attention_ref(
            q, kp, kpar[..., :1], kpar[..., 1:], vp, vpar[..., :1],
            vpar[..., 1:], valid, sm)
        torch.testing.assert_close(y.float(), ref.float(), **ATTN_TOL)
        if not bool((y[valid == 0] == 0).all()):
            raise AssertionError(f"{fn.__name__}: valid_len 0 must give 0")
        worst["plain"] = max(worst["plain"],
                             (y.float() - ref.float()).abs().max().item())
        worst["row2"] = max(worst["row2"], (y.float() - row2(
            q, kp, kpar, vp, vpar, valid, sm).float()).abs().max().item())
        n[0] += 1
        return y

    return attn


def _checked_flash_i8(torch, pv_i8, n, worst):
    """flash_prefill_attention_kt_i8 (mode pv_i8) at the engine's
    flash_prefill_attention_kt call site, holding every launch to its
    plain version ("flash")."""
    from flatquant_torch.kernels import prefill_attention as pa
    from flatquant_torch.kernels.tolerance import compare_bf16

    def flash(q, kt, v, sm):
        o = pa.flash_prefill_attention_kt_i8(q, kt, v, sm, pv_i8)
        err = compare_bf16(
            o, pa.flash_prefill_attention_kt_i8_ref(q, kt, v, sm, pv_i8),
            "flash", f"flash_prefill_attention_kt_i8 pv_i8={pv_i8} on the "
            "path")
        worst[0] = max(worst[0], err)
        n[0] += 1
        return o

    return flash


def run_baseline_paths(torch, dev, model, results, smi):
    """Rows 17-21 each in place of its twin on phase 4's llama-2-7b W4A4KV4.
    (a) phase 4's generate protocol (B=4, 48-token prompts, 64 greedy
    steps over the int4 cache) with _quant_linear's A4 route below 256
    rows through w4a4_matmul_i8_fusedq instead of the eager quant chain
    and w4a4_matmul_i8: tokens and every step's logits bit-identical to
    the composed run. (b) the same decode with the engine's
    decode_attention_int4 replaced by rows 19, 20 and 21 in turn, and
    every launch of two more steps held to the plain version (ATTN_TOL)
    and compared with row 2. The decode step of (a) and (b) is timed
    against the composed run's in DECODE_ROUNDS interleaved rounds of
    DECODE_STEPS steps (medians). (c) phase 6a's 1 x 2048 prefill with the
    engine's flash_prefill_attention_kt replaced by row 18, pv_i8 on and
    off: every launch held to its plain version, the prefill's wall time
    interleaved with the row-8 prefill's (medians), and the last-position
    logits against row 8's as a tripwire (LONG_COSINE_FLOOR). Returns the
    launches of each path."""
    from flatquant_torch.kernels import common
    from flatquant_torch.kernels import int4_matmul
    from flatquant_torch.kernels import kv_cache
    from flatquant_torch.kernels import prefill_attention as pa
    from flatquant_torch.serving import engine, quantized
    from flatquant_torch.serving.engine import init_cache, serving_prefill

    cfg, fq, sp = model
    L = cfg.num_layers
    B, P, NEW, MAX_LEN = 4, 48, 64, 2048
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device=dev)
    kw = dict(max_len=MAX_LEN, device=dev)
    paths, rec = {}, {}
    med = lambda v: sorted(v)[len(v) // 2]

    # (a) row 17 at every A4 linear of the decode path
    _decode_run(torch, cfg, fq, sp, prompt, 1, kw)  # warm-up
    toks_c, logits_c, _ = _decode_run(torch, cfg, fq, sp, prompt, NEW, kw)
    fused = _fusedq_linear(torch, quantized._quant_linear)
    common.reset_launches()
    with patched([(quantized, "_quant_linear", fused),
                  (engine, "_quant_linear", fused)]):
        toks_f, logits_f, _ = _decode_run(torch, cfg, fq, sp, prompt, NEW,
                                             kw)
    paths["baseline_fusedq"] = dict(common.LAUNCHES)
    bodies = dict(common.BODY_LAUNCHES["w4a4_matmul_i8_fusedq"])
    n_f = paths["baseline_fusedq"]["w4a4_matmul_i8_fusedq"]
    if n_f != 4 * L * (1 + NEW) or paths["baseline_fusedq"][
            "w4a4_matmul_i8"] != 0:
        raise AssertionError(f"(a) {n_f} fused-quant launches, expected "
                             f"{4 * L * (1 + NEW)}, and no w4a4_matmul_i8")
    # the prefill's M = B * P rows and the steps' B rows, each of the
    # layer's four linears (N, K) by route
    H, I = cfg.hidden_size, cfg.intermediate_size
    linears = (((cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim, H),
               (H, cfg.num_heads * cfg.head_dim), (2 * I, H), (H, I))
    want = {"stream": 0, "tile": 0}
    for rows, count in ((B * P, L), (B, L * NEW)):
        for n, k in linears:
            want[int4_matmul.fusedq_body(rows, n, k)] += count
    if bodies != want:
        raise AssertionError(f"(a) row 17 launches by body {bodies}, the "
                             f"route gives {want}")
    same = torch.equal(toks_c, toks_f) and all(
        torch.equal(a, b) for a, b in zip(logits_c, logits_f))
    if not same:
        raise AssertionError("(a) the fused-quant path's tokens or logits "
                             "differ from the composed run's")
    rec["fusedq"] = dict(launches=n_f, bodies=bodies)
    log(f"  (a) B={B} prompt={P} new={NEW}: {n_f} w4a4_matmul_i8_fusedq "
        f"launches (by body {bodies}) in place of the eager quant chain + "
        f"w4a4_matmul_i8; tokens and all {len(logits_f)} steps' logits "
        "bit-identical to the composed run")

    # the 4 x 48 prefill (M = 192 rows a linear: row 17's tile body) with
    # row 17 against the composed route (rows 12 + 1), interleaved rounds
    def prefill(pairs):
        c = init_cache(cfg, B, MAX_LEN, mode="int4", device=dev)
        torch.cuda.synchronize()
        with patched(pairs):
            t0 = time.perf_counter()
            lg, _ = serving_prefill(cfg, fq, sp, prompt, c, **kw)
            torch.cuda.synchronize()
        return lg, (time.perf_counter() - t0) * 1e3

    fq_pairs = [(quantized, "_quant_linear", fused),
                (engine, "_quant_linear", fused)]
    walls = {"composed": [], "fusedq": []}
    first = {key: prefill(pairs)[0] for key, pairs in (("composed", []),
                                                       ("fusedq", fq_pairs))}
    if not torch.equal(first["composed"], first["fusedq"]):
        raise AssertionError("(a) the fused-quant prefill's logits differ "
                             "from the composed prefill's")
    for _ in range(PREFILL_ROUNDS):
        for key, pairs in (("composed", []), ("fusedq", fq_pairs)):
            walls[key].append(prefill(pairs)[1])
    ratio = [f / c for f, c in zip(walls["fusedq"], walls["composed"])]
    for key in walls:
        rec.setdefault(key, {}).update(prefill_ms=walls[key],
                                       prefill_ms_median=med(walls[key]))
    rec["fusedq"]["prefill_ratio_to_composed"] = ratio
    log(f"  [{smi}] (a) {B} x {P} prefill, {PREFILL_ROUNDS} interleaved "
        f"rounds: row 17 median {med(walls['fusedq']):.2f} ms "
        f"{[round(x, 2) for x in walls['fusedq']]}, composed (rows 12 + 1) "
        f"median {med(walls['composed']):.2f} ms "
        f"{[round(x, 2) for x in walls['composed']]}; row 17 / composed by "
        f"round {[round(x, 3) for x in ratio]}; logits bit-identical")

    # (b) rows 19-21 at the engine's decode attention call site
    for name in ("decode_attention_int4_v1", "decode_attention_int4_wide",
                 "decode_attention_int4_v3"):
        fn = getattr(kv_cache, name)
        common.reset_launches()
        with patched([(engine, "decode_attention_int4", fn)]):
            toks_b, logits_b, _ = _decode_run(torch, cfg, fq, sp, prompt,
                                                 NEW, kw)
        launches = dict(common.LAUNCHES)
        paths["baseline_" + name[len("decode_attention_int4_"):]] = launches
        if launches[name] != L * NEW or launches["decode_attention_int4"]:
            raise AssertionError(f"(b) {launches[name]} {name} launches, "
                                 f"expected {L * NEW}")
        if not all(torch.isfinite(x).all() for x in logits_b):
            raise AssertionError(f"(b) {name}: logits not finite")
        n, worst = [0], {"plain": 0.0, "row2": 0.0}
        c = init_cache(cfg, B, MAX_LEN, mode="int4", device=dev)
        lg, c = serving_prefill(cfg, fq, sp, prompt, c, **kw)
        with patched([(engine, "decode_attention_int4",
                       _checked_decode_baseline(torch, fn, n, worst))]):
            for i in range(2):
                lg, c = engine.serving_decode_step(
                    cfg, fq, sp, lg.argmax(-1, keepdim=True), c, P + i, **kw)
        torch.cuda.synchronize()
        if n[0] != 2 * L:
            raise AssertionError(f"(b) {name}: {n[0]} launches checked")
        agree = int((toks_b == toks_c).all(0).sum())
        rec[name] = dict(launches=launches[name], checked=n[0],
                         max_abs_err=worst["plain"],
                         max_abs_diff_row2=worst["row2"],
                         tokens_agreeing_with_row2=agree)
        log(f"  (b) {name}: {launches[name]} launches in {NEW} steps; "
            f"{n[0]} launches of 2 steps checked, max abs err "
            f"{worst['plain']:.3e} "
            f"(tol rtol/atol {ATTN_TOL['rtol']}), against row 2 "
            f"{worst['row2']:.3e}; greedy tokens equal to row 2's run at "
            f"{agree}/{NEW} steps (not gated: random W4A4 logits are "
            "chaotic)")

    # the decode step of (a) and (b) against the composed run (rows 1 and
    # 2), interleaved: the host's speed swings between calls and drifts
    # within one, so each round runs every variant once
    attn = lambda name: [(engine, "decode_attention_int4",
                          getattr(kv_cache, name))]
    rotation = {"composed": [],
                "fusedq": [(quantized, "_quant_linear", fused),
                           (engine, "_quant_linear", fused)],
                **{name: attn(name) for name in (
                    "decode_attention_int4_v1", "decode_attention_int4_wide",
                    "decode_attention_int4_v3")}}
    steps = {key: [] for key in rotation}
    ratio = {key: [] for key in rotation}
    for _ in range(DECODE_ROUNDS):
        for key, pairs in rotation.items():
            with patched(pairs):
                ms = _decode_run(torch, cfg, fq, sp, prompt, DECODE_STEPS,
                                 kw)[2]
            steps[key].append(med(ms[1:]))
            ratio[key].append(steps[key][-1] / steps["composed"][-1])
    for key in rotation:
        rec.setdefault(key, {}).update(
            decode_ms=steps[key], decode_ms_median=med(steps[key]),
            decode_ratio_to_composed=ratio[key])
        log(f"  [{smi}] (a/b) decode, {key}: median {med(steps[key]):.2f} "
            f"ms/step of the round medians "
            f"{[round(x, 2) for x in steps[key]]}; against the composed "
            f"run (rows 1, 2) of the same round "
            f"{[round(x, 3) for x in ratio[key]]}")

    # (c) row 18 at the engine's flash_prefill_attention_kt call site
    S, MAX_LONG = 2048, 2304
    gen = torch.Generator(device=dev).manual_seed(3)
    long = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                         device=dev)
    kwl = dict(max_len=MAX_LONG, device=dev)
    variants = {"flash_prefill_attention_kt (row 8)": None,
                "kt_i8 pv_i8=True": True, "kt_i8 pv_i8=False": False}

    def prefill(pv_i8):
        c = init_cache(cfg, 1, MAX_LONG, mode="int4", device=dev)
        torch.cuda.synchronize()
        if pv_i8 is None:
            t0 = time.perf_counter()
            lg, _ = serving_prefill(cfg, fq, sp, long, c, **kwl)
        else:
            fn = lambda q, kt, v, sm: pa.flash_prefill_attention_kt_i8(
                q, kt, v, sm, pv_i8)
            with patched([(engine, "flash_prefill_attention_kt", fn)]):
                t0 = time.perf_counter()
                lg, _ = serving_prefill(cfg, fq, sp, long, c, **kwl)
        torch.cuda.synchronize()
        return lg, (time.perf_counter() - t0) * 1e3

    last = {}
    for label, pv_i8 in variants.items():  # warm-up, and the logits
        last[label] = prefill(pv_i8)[0]
    for pv_i8, tag in ((True, "baseline_i8_prefill"),
                       (False, "baseline_i8_prefill_bf16pv")):
        common.reset_launches()
        prefill(pv_i8)
        paths[tag] = dict(common.LAUNCHES)
        got = paths[tag]["flash_prefill_attention_kt_i8"]
        if got != L or paths[tag]["flash_prefill_attention_kt"]:
            raise AssertionError(f"(c) pv_i8={pv_i8}: {got} int8 flash "
                                 f"launches, expected {L}")
        n, worst = [0], [0.0]
        with patched([(engine, "flash_prefill_attention_kt",
                       _checked_flash_i8(torch, pv_i8, n, worst))]):
            serving_prefill(cfg, fq, sp, long,
                            init_cache(cfg, 1, MAX_LONG, mode="int4",
                                       device=dev), **kwl)
        torch.cuda.synchronize()
        if n[0] != L:
            raise AssertionError(f"(c) pv_i8={pv_i8}: {n[0]} launches "
                                 "checked")
        rec[tag] = dict(checked=n[0], max_abs_err=worst[0])
        log(f"  (c) pv_i8={pv_i8}: {n[0]} flash_prefill_attention_kt_i8 "
            f"launches of a 1 x {S} prefill within 'flash' of the plain "
            f"version, max abs err {worst[0]:.3e}")
    walls = {label: [] for label in variants}
    repeat = True  # every timed prefill's logits equal the first run's
    for _ in range(3):  # interleaved
        for label, pv_i8 in variants.items():
            lg, ms = prefill(pv_i8)
            walls[label].append(ms)
            repeat = repeat and torch.equal(lg, last[label])
    ref_label = next(iter(variants))
    for label in variants:
        cos = _cosine(torch, last[label], last[ref_label])
        if not torch.isfinite(last[label]).all():
            raise AssertionError(f"(c) {label}: logits not finite")
        if cos < LONG_COSINE_FLOOR:
            raise AssertionError(f"(c) {label}: last-position logits cosine "
                                 f"{cos:.4f} against row 8's")
        rec[label] = dict(rec.get(label, {}), prefill_ms=walls[label],
                          prefill_ms_median=med(walls[label]),
                          cosine_vs_row8=cos)
        runs = [round(w, 1) for w in walls[label]]
        log(f"  [{smi}] (c) 1 x {S} prefill, {label}: median "
            f"{med(walls[label]):.1f} ms of {runs}; last-position logits "
            f"cosine against row 8's {cos:.4f} (floor {LONG_COSINE_FLOOR})")
    log(f"  (c) the timed prefills' logits equal each variant's first run: "
        f"{repeat}")
    rec["prefill_logits_repeat"] = repeat
    results["baseline_paths"] = rec
    return paths


# ---------------------------------------------------------------------------
# phase 12: rows 22-27 at their flat twins' call sites
# ---------------------------------------------------------------------------

# launches per layer of one 1 x 2048 prefill: (a) the attention input and
# the MLP on the grouped layout (the o projection stays flat); (b) the flat
# ln2 + quant, then the round-2 tail
GROUPED_FULL_LAUNCHES = {
    "rmsnorm_right_grouped": 2, "left_quant_i8_grouped": 3,
    "w4a4_swiglu_grouped_gx": 1, "w4a4_matmul_i8_grouped": 2,
    "rmsnorm_right_flat": 0, "left_quant_i8_flat": 1,
    "w4a4_matmul_i8_swiglu_right": 0, "w4a4_matmul_i8": 1}
GROUPED_ROUND2_LAUNCHES = {
    "w4a4_swiglu_grouped": 1, "quant_acts_i8_grouped": 1,
    "w4a4_matmul_i8_grouped": 1, "rmsnorm_right_flat": 2,
    "left_quant_i8_flat": 3, "w4a4_matmul_i8_swiglu_right": 0,
    "w4a4_matmul_i8": 2}


def _checked_grouped(torch, n, worst):
    """(quantized, name, checking wrapper) for each grouped wrapper the
    grouped routes call: every launch held to its plain version (the
    "orthogonal" mode, the model's factors; rows 24 and 25 bit for bit)
    and bit for bit to its flat twin on the same values."""
    from flatquant_torch.kernels import flat_pipeline as fp
    from flatquant_torch.kernels import grouped_mlp as gm
    from flatquant_torch.kernels import int4_matmul as im
    from flatquant_torch.kernels.tolerance import (
        compare_bf16, compare_codes, compare_scales)
    from flatquant_torch.serving import quantized

    mode, ug = "orthogonal", gm.ungroup_layout

    def note(name, err):
        n[name] = n.get(name, 0) + 1
        worst[name] = max(worst.get(name, 0.0), err)

    def rms(x, w, right, eps):
        y = gm.rmsnorm_right_grouped(x, w, right, eps)
        err = compare_bf16(ug(y), ug(gm.rmsnorm_right_grouped_ref(
            x, w, right, eps)), mode, "rmsnorm_right_grouped on the path")
        _twin_equal(torch, "rmsnorm_right_grouped on the path", [ug(y)],
                    [fp.rmsnorm_right_flat(x, w, right, eps)])
        note("rmsnorm_right_grouped", err)
        return y

    def lq(left_t, x, clip=None, q_max=7):
        q, s = gm.left_quant_i8_grouped(left_t, x, clip, q_max)
        q_ref, s_ref = gm.left_quant_i8_grouped_ref(left_t, x, clip, q_max)
        compare_codes(q, q_ref, mode, "left_quant_i8_grouped on the path")
        err = compare_scales(s, s_ref, mode,
                             "left_quant_i8_grouped scales on the path")
        _twin_equal(torch, "left_quant_i8_grouped on the path", [ug(q), s],
                    fp.left_quant_i8_flat(left_t, ug(x), clip, q_max))
        note("left_quant_i8_grouped", err)
        return q, s

    def swiglu(name, xq_flat):
        fn, plain = getattr(gm, name), getattr(gm, name + "_ref")

        def swi(xq, xs, wp, sw, right):
            y = fn(xq, xs, wp, sw, right)
            err = compare_bf16(ug(y), ug(plain(xq, xs, wp, sw, right)), mode,
                               f"{name} on the path")
            _twin_equal(torch, f"{name} on the path", [ug(y)],
                        [fp.w4a4_matmul_i8_swiglu_right(
                            xq_flat(xq), xs, wp, sw, right)])
            note(name, err)
            return y

        return swi

    def qa(x, clip=None, q_max=7):
        q, s = gm.quant_acts_i8_grouped(x, clip, q_max)
        if not all(torch.equal(a, b) for a, b in zip(
                (q, s), gm.quant_acts_i8_grouped_ref(x, clip, q_max))):
            raise AssertionError("quant_acts_i8_grouped not bit-exact on the "
                                 "path")
        _twin_equal(torch, "quant_acts_i8_grouped on the path", [ug(q), s],
                    im.quant_acts_i8(ug(x), clip, q_max))
        note("quant_acts_i8_grouped", 0.0)
        return q, s

    def gemm(xq, xs, wp, sw, out_dtype=torch.bfloat16):
        y = gm.w4a4_matmul_i8_grouped(xq, xs, wp, sw, out_dtype)
        if not torch.equal(y, gm.w4a4_matmul_i8_grouped_ref(xq, xs, wp, sw,
                                                            out_dtype)):
            raise AssertionError("w4a4_matmul_i8_grouped not bit-exact on "
                                 "the path")
        _twin_equal(torch, "w4a4_matmul_i8_grouped on the path", [y],
                    [im.w4a4_matmul_i8(ug(xq), xs, wp, sw, out_dtype)])
        note("w4a4_matmul_i8_grouped", 0.0)
        return y

    return [(quantized, "rmsnorm_right_grouped", rms),
            (quantized, "left_quant_i8_grouped", lq),
            (quantized, "w4a4_swiglu_grouped",
             swiglu("w4a4_swiglu_grouped", lambda x: x)),
            (quantized, "w4a4_swiglu_grouped_gx",
             swiglu("w4a4_swiglu_grouped_gx", ug)),
            (quantized, "quant_acts_i8_grouped", qa),
            (quantized, "w4a4_matmul_i8_grouped", gemm)]


def run_grouped_paths(torch, dev, model, results, smi):
    """Rows 22-27 at their flat twins' call sites in phase 6a's 1 x 2048
    prefill over the int4 cache (phase 7's llama-2-7b, rebuilt from seed
    0; the same prompt). (a) The fused attention input through rows 26 ->
    23 -> 25 and the fused MLP through 26 -> 23 -> 27 -> 23 -> 25
    (quantized._grouped_layout_attn_in and _grouped_layout_mlp_full at
    _grouped_attn_in and _quant_mlp_grouped_full; the o projection stays
    flat): the launches counted, every launch of a prefill held to its
    plain version and bit for bit to its flat twin, and the last-position
    logits bit-identical to the flat routes'. (b) The MLP through rows 4
    -> 5 -> 22 -> the left factor as one bf16 torch.matmul -> 24 -> 25
    (_grouped_layout_mlp_round2): counted, every launch checked (rows 22,
    24 and 25 bit for bit against rows 6, 12 and 1), the logits against
    the flat route's as a tripwire (LONG_COSINE_FLOOR: cuBLAS sums the
    left product in another order than row 5). The prefill of the flat
    routes, (a) and (b) timed in 3 interleaved rounds (medians). Returns
    the launches of (a) and (b)."""
    from flatquant_torch.kernels import common
    from flatquant_torch.serving import engine, quantized
    from flatquant_torch.serving.engine import init_cache, serving_prefill

    cfg, fq, sp = model
    L = cfg.num_layers
    B, S, MAX_LEN = 1, 2048, 2304
    gen = torch.Generator(device=dev).manual_seed(3)  # phase 6a's prompt
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    kw = dict(max_len=MAX_LEN, device=dev)
    at_sites = lambda attn_in, mlp: [
        (m, name, fn) for m in (quantized, engine)
        for name, fn in (("_grouped_attn_in", attn_in),
                         ("_quant_mlp_grouped_full", mlp)) if fn]
    routes = {"flat": [],
              "grouped_full": at_sites(quantized._grouped_layout_attn_in,
                                       quantized._grouped_layout_mlp_full),
              "grouped_round2": at_sites(
                  None, quantized._grouped_layout_mlp_round2)}
    expected = {"grouped_full": GROUPED_FULL_LAUNCHES,
                "grouped_round2": GROUPED_ROUND2_LAUNCHES}

    def prefill(key, checks=()):
        c = init_cache(cfg, B, MAX_LEN, mode="int4", device=dev)
        torch.cuda.synchronize()
        with patched(routes[key] + list(checks)):
            t0 = time.perf_counter()
            lg, _ = serving_prefill(cfg, fq, sp, prompt, c, **kw)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        return lg, ms

    last = {key: prefill(key)[0] for key in routes}  # warm-up, the logits
    paths, rec = {}, {}
    for key, tag in (("grouped_full", "(a)"), ("grouped_round2", "(b)")):
        common.reset_launches()
        prefill(key)
        paths[key] = dict(common.LAUNCHES)
        bad = {name: paths[key][name] for name, per_layer in
               expected[key].items() if paths[key][name] != per_layer * L}
        if bad:
            raise AssertionError(f"{tag} launches {bad}, expected per layer "
                                 f"{expected[key]} x {L}")
        n, worst = {}, {}
        prefill(key, _checked_grouped(torch, n, worst))
        want = {name: c * L for name, c in expected[key].items()
                if name.endswith(("_grouped", "_grouped_gx"))}
        if n != want:
            raise AssertionError(f"{tag} launches checked {n}, expected "
                                 f"{want}")
        rec[key] = dict(launches=want, checked=n, max_abs_err=worst)
        log(f"  {tag} {key}: launches per 1 x {S} prefill {want}; every one "
            f"held to its plain version and bit-identical to its flat twin, "
            f"max abs err {worst}")
    for key in routes:
        if not torch.isfinite(last[key]).all():
            raise AssertionError(f"{key}: logits not finite")
    if not torch.equal(last["grouped_full"], last["flat"]):
        raise AssertionError("(a) the fully grouped prefill's last-position "
                             "logits differ from the flat routes'")
    cos = _cosine(torch, last["grouped_round2"], last["flat"])
    if cos < LONG_COSINE_FLOOR:
        raise AssertionError(f"(b) last-position logits cosine {cos:.4f} "
                             "against the flat routes'")
    rec["grouped_full"]["logits_equal_flat"] = True
    rec["grouped_round2"]["cosine_vs_flat"] = cos
    log(f"  (a) last-position logits bit-identical to the flat routes'; (b) "
        f"cosine against them {cos:.4f} (floor {LONG_COSINE_FLOOR})")

    med = lambda v: sorted(v)[len(v) // 2]
    walls = {key: [] for key in routes}
    repeat = True  # every timed prefill's logits equal the first run's
    for _ in range(3):  # interleaved
        for key in routes:
            lg, ms = prefill(key)
            walls[key].append(ms)
            repeat = repeat and torch.equal(lg, last[key])
    for key in routes:
        ratio = [w / f for w, f in zip(walls[key], walls["flat"])]
        rec.setdefault(key, {}).update(prefill_ms=walls[key],
                                       prefill_ms_median=med(walls[key]),
                                       ratio_to_flat=ratio)
        log(f"  [{smi}] 1 x {S} prefill, {key}: median {med(walls[key]):.1f}"
            f" ms of {[round(w, 1) for w in walls[key]]}; against the flat "
            f"routes' of the same round {[round(r, 4) for r in ratio]}")
    log(f"  the timed prefills' logits equal each route's first run: "
        f"{repeat}")
    rec["prefill_logits_repeat"] = repeat
    results["grouped_paths"] = rec
    return paths


# ---------------------------------------------------------------------------
# phase 13: llama-2-7b through the port's own build chain
# ---------------------------------------------------------------------------

# the kernel table's row of each wrapper phase 13 counts
ROW_OF = {"w4a4_matmul_i8": 1, "decode_attention_int4": 2, "write_token": 3,
          "rmsnorm_right_flat": 4, "left_quant_i8_flat": 5,
          "w4a4_matmul_i8_swiglu_right": 6, "attn_prologue": 7,
          "flash_prefill_attention_kt": 8, "quant_acts_i8": 12,
          "w4a4_matmul_i8_swiglu": 13, "flash_prefill_attention": 15}
# launches per layer of the 1 x 2048 prefill and of one decode step, (c)
# JAX's default unmerged layout: seven GEMMs (q, k, v, o, up, gate, down;
# down's input, K = 11008, through quant_acts_i8), flash on the [B, S, nkv,
# hd] layout; (d) the perm layout, merged: the composed routes (no fused
# route takes ln_tp / ug_tp / down_tp / o_tp), the swiglu GEMM (row 13) at
# 2048 rows, quant_acts_i8 before down, flash
UNMERGED_PREFILL = {"w4a4_matmul_i8": 7, "quant_acts_i8": 1,
                    "flash_prefill_attention": 1}
UNMERGED_STEP = {"w4a4_matmul_i8": 7, "decode_attention_int4": 1}
PERM_PREFILL = {"w4a4_matmul_i8": 3, "quant_acts_i8": 1,
                "w4a4_matmul_i8_swiglu": 1, "flash_prefill_attention": 1}
PERM_STEP = {"w4a4_matmul_i8": 4, "decode_attention_int4": 1}
# (c)'s and (d)'s tripwires: their prefill logits against the merged
# standard layout's, all cut to 2 layers: the same function in another
# layout. In float32 (params packed with float32 transforms, float32
# compute, the plain versions: only float32 sums in other orders) the
# layouts agree but for W4A4 codes at float32 ties: floor
# LAYOUT_COSINE_FLOOR. In bf16 on the kernel routes they are rounding
# variants (the fused routes against the composed ones, bf16 products in
# other shapes), which two random W4A4 layers amplify: on an NVIDIA H100
# 80GB HBM3 (700 W) the cosines read 0.896 (perm) and 0.899 (unmerged)
# beside 0.889 for the same merged model on its plain versions (the noise
# floor, printed beside them); a permutation or layout fault leaves the
# logits uncorrelated (~0), so the bf16 floor is BF16_LAYOUT_FLOOR
LAYOUT_COSINE_FLOOR = 0.99
BF16_LAYOUT_FLOOR = 0.5
# (a): codes of the card's pack against a CPU pack of layer 0 from the
# same frozen transforms; cuBLAS and the CPU sum the float32 transforms in
# other orders, so a code at a float32 tie may flip, by one step
TIE_NIBBLE_SHARE = 1e-5
TIE_SCALE_REL = 2.0 ** -22


def _tree_to(tree, device):
    """A dataclass tree of tensors (the FQ state) on `device`."""
    import dataclasses

    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _tree_to(getattr(tree, f.name), device)
            for f in dataclasses.fields(tree)})
    return tree.to(device) if hasattr(tree, "to") else tree


def _nbytes(tree):
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size() if hasattr(tree, "numel") \
        else 0


def compare_packs(torch, got, want, label):
    """Packed projections of one layer (card) against the same layer
    packed elsewhere: differing int4 nibbles (count, share, largest code
    step) and scales (count, largest relative difference) per
    projection; the a_clip ratios must be equal."""
    out = {}
    for nm in ("qkv", "o", "upgate", "down"):
        g, w = got[nm], want[nm]
        gb, wb = g["wp"].cpu().to(torch.int16), w["wp"].to(torch.int16)
        steps = torch.cat([((gb & 0xF) - (wb & 0xF)).abs().flatten(),
                           ((gb >> 4) - (wb >> 4)).abs().flatten()])
        gs, ws = g["scale"].cpu(), w["scale"]
        rel = ((gs - ws).abs() / ws.abs()).max().item()
        for a, b in zip(g["a_clip"], w["a_clip"]):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"{label} {nm}: a_clip differs")
        out[nm] = dict(nibbles=int((steps > 0).sum()),
                       of=steps.numel(),
                       largest_step=int(steps.max()),
                       scales=int((gs != ws).sum()), scale_max_rel=rel)
    tot = sum(r["nibbles"] for r in out.values())
    of = sum(r["of"] for r in out.values())
    log(f"  {label}: {tot} of {of} nibbles differ (share {tot / of:.2e}); "
        f"by projection {out}")
    return dict(by_projection=out, nibbles=tot, of=of, share=tot / of,
                largest_step=max(r["largest_step"] for r in out.values()),
                scale_max_rel=max(r["scale_max_rel"] for r in out.values()))


def check_every_launch(torch, cfg, fq, sp, prompt, kw, steps, prefill,
                       step, what):
    """One prefill over the int4 cache and `steps` greedy decode steps
    (the first half at a scalar position, the rest per slot, which writes
    through write_token), every kernel launch held to its plain version
    on the same inputs (_prefill_checks, _checked_decode_attention,
    _checked_write). prefill / step: expected launches per layer of the
    prefill and of one decode step (write_token: one per layer of each
    per-slot step). Returns the counts and largest errors."""
    from flatquant_torch.serving import engine

    names = PREFILL_CHECKED + ["decode_attention_int4", "write_token"]
    n = dict.fromkeys(names, 0)
    worst = dict.fromkeys(names, 0.0)
    B, S = prompt.shape
    L = cfg.num_layers
    checks = _prefill_checks(torch, n, worst) + [
        (engine, "decode_attention_int4",
         _checked_decode_attention(torch, n, worst)),
        (engine, "write_token", _checked_write(torch, n))]
    with patched(checks):
        c = engine.init_cache(cfg, B, kw["max_len"], mode="int4",
                              device=kw["device"])
        logits, c = engine.serving_prefill(cfg, fq, sp, prompt, c, **kw)
        torch.cuda.synchronize()
        n_prefill = dict(n)
        for i in range(steps):
            pos = S + i if i < steps // 2 else torch.full(
                (B,), S + i, dtype=torch.int32, device=kw["device"])
            logits, c = engine.serving_decode_step(
                cfg, fq, sp, logits.argmax(-1, keepdim=True), c, pos, **kw)
    torch.cuda.synchronize()
    _check_counts(n_prefill, prefill, L, f"{what} prefill")
    n_steps = {k: n[k] - n_prefill[k] for k in n}
    want = {k: v * steps for k, v in step.items()}
    want["write_token"] = steps - steps // 2
    _check_counts(n_steps, want, L, f"{what} decode steps")
    log(f"  {what}: every launch of a prefill and {steps} decode steps vs "
        f"its plain version, by row: prefill "
        f"{ {ROW_OF[k]: v for k, v in n_prefill.items() if v} }, steps "
        f"{ {ROW_OF[k]: v for k, v in n_steps.items() if v} }; max abs err "
        f"{ {k: v for k, v in worst.items() if n[k]} }")
    return dict(prefill=n_prefill, steps=n_steps, max_abs_err=worst)


def run_build_chain_path(torch, dev, results, smi):
    """Phase 13: llama-2-7b (32 layers, full width) through the port's own
    build chain, bench.py's recipe: seeded fp weights (init_params, a
    torch.Generator on the card), init_model_fq(seed=0) -> bake_model ->
    build_serving_params(merge_projections=True) on the card, W4A4KV4 with
    tpu_decompose. (a) layer 0 packed again on the CPU from the same fp
    weights, twice: from the card's frozen transforms (bake_layer_fq on
    the card; the tie rule gates it: at most TIE_NIBBLE_SHARE of nibbles
    differ, each by one code, every scale within TIE_SCALE_REL) and from
    the raw FQ state (the Cayley maps and inverses solved on the CPU;
    reported). (b) the merged model: a 1 x 2048 serving_prefill and 32
    decode steps over the int4 cache, timed; every launch of a prefill
    (check_prefill_launches) and of 8 decode steps
    (check_launches_on_path) checked. (c) JAX's default unmerged layout
    and (d) the perm layout (merged) at 2 layers of full width: a 1 x 2048
    prefill and 8 decode steps each, timed, then every launch of the same
    checked (check_every_launch); the prefill logits of (c) and (d)
    against (b)'s model cut to 2 layers, in bf16 on the kernels
    (BF16_LAYOUT_FLOOR, beside the noise floor of (b)'s plain versions)
    and in float32 on the plain versions (LAYOUT_COSINE_FLOOR). Returns
    the launches of the timed runs of (b), (c), (d)."""
    import dataclasses

    from flatquant_torch.models.config import get_config
    from flatquant_torch.models.llama import init_params
    from flatquant_torch.quantize.bake import bake_layer, bake_model
    from flatquant_torch.quantize.spec import W4A4KV4
    from flatquant_torch.quantize.state import bake_layer_fq, init_model_fq
    from flatquant_torch.serving.engine import init_cache, serving_prefill
    from flatquant_torch.serving.quantized import (
        build_serving_layer, build_serving_params, layer_transforms)

    cfg = get_config("llama-2-7b")
    fq = dataclasses.replace(W4A4KV4, tpu_decompose=True)
    L = cfg.num_layers
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device=dev)
    state = init_model_fq(cfg, fq, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # (a)'s inputs, copied before the bake: layer 0's fp weights, its raw
    # FQ state and its transforms frozen on the card
    lp0 = {k: v.cpu() for k, v in params["layers"][0].items()}
    fq0 = _tree_to(state[0], "cpu")
    frozen0 = _tree_to(bake_layer_fq(state[0]), "cpu")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    baked, bfq = bake_model(cfg, fq, params, state)
    torch.cuda.synchronize()
    bake_s = time.perf_counter() - t1
    del params, state
    t1 = time.perf_counter()
    sp = build_serving_params(cfg, fq, baked, bfq, dtype=torch.bfloat16,
                              merge_projections=True)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t1
    peak = torch.cuda.max_memory_allocated()
    two = dict(baked, layers=baked["layers"][:2])
    bfq2 = bfq[:2]
    del baked, bfq
    gc.collect()
    torch.cuda.empty_cache()
    packed_gib = _nbytes(sp) / 2**30
    log(f"  [{smi}] build: init_params + init_model_fq {init_s:.1f} s, "
        f"bake_model {bake_s:.1f} s, build_serving_params {pack_s:.1f} s "
        f"(build {bake_s + pack_s:.1f} s; {init_s + bake_s + pack_s:.1f} s "
        f"with the init); max_memory_allocated during it "
        f"{peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB before); packed "
        f"model {packed_gib:.2f} GiB ({L} layers, embed and head bf16)")

    # (a) layer 0 on the CPU
    t1 = time.perf_counter()
    lt0, bf0 = bake_layer(cfg, fq, lp0, frozen0)
    cpu_frozen = build_serving_layer(cfg, fq, lt0, layer_transforms(bf0),
                                     torch.bfloat16, merge_projections=True)
    lr0, br0 = bake_layer(cfg, fq, lp0, fq0)
    cpu_raw = build_serving_layer(cfg, fq, lr0, layer_transforms(br0),
                                  torch.bfloat16, merge_projections=True)
    cpu_s = time.perf_counter() - t1
    del lp0, lt0, lr0
    codes = compare_packs(torch, sp["layers"][0], cpu_frozen,
                          "(a) layer 0, card vs CPU from the card's frozen "
                          "transforms")
    codes_raw = compare_packs(torch, sp["layers"][0], cpu_raw,
                              "(a) layer 0, card vs CPU from the raw FQ "
                              "state (Cayley solves on the CPU; not gated)")
    log(f"  (a) two CPU packs of layer 0: {cpu_s:.1f} s")
    if (codes["share"] > TIE_NIBBLE_SHARE or codes["largest_step"] > 1
            or codes["scale_max_rel"] > TIE_SCALE_REL):
        raise AssertionError(
            f"(a) layer 0's codes break the tie rule: {codes['nibbles']} "
            f"nibbles differ (share {codes['share']:.2e}, limit "
            f"{TIE_NIBBLE_SHARE}), largest step {codes['largest_step']}, "
            f"scales {codes['scale_max_rel']:.2e} relative (limit "
            f"{TIE_SCALE_REL:.2e})")

    # (b) the merged rn128 model, full depth
    B, S, NEW, MAX_LEN = 1, 2048, 32, 2304
    gen = torch.Generator(device=dev).manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    kw = dict(max_len=MAX_LEN, device=dev)
    run = _timed_serving(torch, cfg, fq, sp, prompt, NEW, kw, "int4")
    launches_b = run["launches"]
    del run["cache"], run["tok"]
    _check_counts({k: run["prefill_launches"][k]
                   for k in LONG_PREFILL_LAUNCHES}, LONG_PREFILL_LAUNCHES,
                  L, "(b) prefill")
    if launches_b["decode_attention_int4"] != NEW * L:
        raise AssertionError("(b): the decode steps did not read the cache "
                             "through decode_attention_int4")
    log(f"  [{smi}] (b) merged, {L} layers: prefill B={B} S={S} "
        f"{run['prefill_ms']:.1f} ms, decode median {run['decode_ms']:.2f} "
        f"ms/step ({NEW} steps)")
    log(f"  launches, (b) prefill + {NEW} decode steps: {launches_b}")
    checks_b = check_prefill_launches(torch, cfg, fq, sp, prompt, kw,
                                      LONG_PREFILL_LAUNCHES)
    feed = [torch.tensor([[t]], device=dev) for t in run["tokens"][:8]]
    slot_pos0 = torch.tensor([S + 4], dtype=torch.int32, device=dev)
    checks_b_decode = check_launches_on_path(torch, cfg, fq, sp, prompt,
                                             feed, slot_pos0, S, 4, kw)

    # (c), (d) at 2 layers of full width
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    sp_b2 = dict(sp, layers=sp["layers"][:2])

    def prefill2(spx, **kwx):
        lg, _ = serving_prefill(cfg2, fq, spx, prompt, init_cache(
            cfg2, B, MAX_LEN, mode="int4", device=dev), **kw, **kwx)
        return lg

    logits_b2 = prefill2(sp_b2)
    cos_noise = _cosine(torch, prefill2(sp_b2, use_kernel=False), logits_b2)
    f32 = dict(use_kernel=False, compute_dtype=torch.float32)
    logits_b2_f32 = prefill2(build_serving_params(
        cfg2, fq, two, bfq2, dtype=torch.float32, merge_projections=True),
        **f32)
    log(f"  (b) cut to 2 layers: prefill logits cosine of its plain "
        f"versions against its kernels {cos_noise:.5f} (the bf16 noise "
        "floor)")
    del sp
    gc.collect()
    torch.cuda.empty_cache()
    out, launches = {}, {}
    for key, label, kwargs, prefill, step in (
            ("unmerged", "(c) unmerged (JAX's default layout)", {},
             UNMERGED_PREFILL, UNMERGED_STEP),
            ("perm", "(d) perm layout, merged",
             dict(merge_projections=True, perm_transforms=True),
             PERM_PREFILL, PERM_STEP)):
        t1 = time.perf_counter()
        spx = build_serving_params(cfg2, fq, two, bfq2, dtype=torch.bfloat16,
                                   **kwargs)
        torch.cuda.synchronize()
        build_x = time.perf_counter() - t1
        runx = _timed_serving(torch, cfg2, fq, spx, prompt, 8, kw, "int4")
        launches[key] = runx["launches"]
        del runx["cache"], runx["tok"]
        cos = _cosine(torch, prefill2(spx), logits_b2)
        cos32 = _cosine(torch, prefill2(build_serving_params(
            cfg2, fq, two, bfq2, dtype=torch.float32, **kwargs), **f32),
            logits_b2_f32)
        log(f"  [{smi}] {label}, 2 layers: built in {build_x:.1f} s; "
            f"prefill B={B} S={S} {runx['prefill_ms']:.1f} ms, decode median "
            f"{runx['decode_ms']:.2f} ms/step (8 steps); launches of the "
            f"timed run by row "
            f"{ {ROW_OF.get(k, k): v for k, v in runx['launches'].items() if v} }"
            f"; prefill logits cosine against (b)'s model cut to 2 layers: "
            f"bf16 on the kernels {cos:.5f} (floor {BF16_LAYOUT_FLOOR}), "
            f"float32 on the plain versions {cos32:.6f} (floor "
            f"{LAYOUT_COSINE_FLOOR})")
        checks = check_every_launch(torch, cfg2, fq, spx, prompt, kw, 8,
                                    prefill, step, label)
        out[key] = dict(build_s=build_x, cosine_vs_b2=cos,
                        cosine_vs_b2_f32=cos32, per_launch_checks=checks,
                        **runx)
        if cos < BF16_LAYOUT_FLOOR or cos32 < LAYOUT_COSINE_FLOOR:
            raise AssertionError(
                f"{label}: prefill logits cosine against the merged "
                f"standard layout {cos:.5f} (bf16, floor "
                f"{BF16_LAYOUT_FLOOR}), {cos32:.6f} (float32, floor "
                f"{LAYOUT_COSINE_FLOOR})")
        del spx
    results["build_chain_path"] = dict(
        model="llama-2-7b", layers=L, init_s=init_s, bake_s=bake_s,
        pack_s=pack_s, build_s=bake_s + pack_s, peak_gib=peak / 2**30,
        cosine_b2_plain_vs_kernels=cos_noise,
        packed_gib=packed_gib, codes_vs_cpu=codes,
        codes_vs_cpu_raw_state=codes_raw, cpu_pack_s=cpu_s, merged=run,
        merged_checks=checks_b, merged_decode_checks=checks_b_decode,
        **out)
    del two, bfq2
    gc.collect()
    torch.cuda.empty_cache()
    return {"build_chain": launches_b,
            "build_chain_unmerged": launches["unmerged"],
            "build_chain_perm": launches["perm"]}


# ---------------------------------------------------------------------------
# phase 14: the calibrate -> eval pipeline (main.py's path)
# ---------------------------------------------------------------------------

# (a): the CLI on qwen-2.5-0.5b at full width and depth, W4A4KV4 with
# every learnable group, GPTQ, PPL, the three artifacts and the demo
CLI_ARGV = ["--model", "qwen-2.5-0.5b", "--w_bits", "4", "--a_bits", "4",
            "--k_bits", "4", "--v_bits", "4", "--k_asym", "--v_asym",
            "--k_groupsize", "64", "--v_groupsize", "64", "--cali_trans",
            "--add_diag", "--lwc", "--lac", "--epochs", "1", "--nsamples",
            "16", "--cali_bsz", "4", "--seqlen", "2048", "--gptq",
            "--eval_ppl", "--save_matrix", "--quantized_save",
            "--generate_demo", "16"]
# (b): launches per layer of one decode step of the merged rn128 layout
CALIB_STEP = {"w4a4_matmul_i8": 4, "decode_attention_int4": 1}


def _calib_summary(hist, what):
    """Per layer: the MSE of every step and epoch (finite, and the last
    step's below the first's: the loss falls within the layer) and the
    seconds of its teacher pass and steps."""
    for h in hist:
        m = h["step_mse"]
        if not (all(math.isfinite(v) for v in m + h["epoch_mse"])
                and m[-1] < m[0]):
            raise AssertionError(f"{what} layer {h['layer']}: step MSEs {m} "
                                 "not finite or not falling")
    def median(v):
        return sorted(v)[len(v) // 2]

    return dict(per_layer=hist,
                step_s_median=[median(h["step_s"]) for h in hist],
                teacher_s=[h["teacher_s"] for h in hist])


def _leaves_equal(torch, a, b, what):
    from flatquant_torch.utils.tree import tree_leaves

    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb) or not all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb)):
        raise AssertionError(f"{what}: the reload differs")
    return len(la)


def run_cli_path(torch, dev, smi):
    """Phase 14 (a): flatquant_torch.main.main(CLI_ARGV), in process, on
    qwen-2.5-0.5b (24 layers, hidden 896, vocab 151,936) over the
    synthetic corpus: calibration, bake, GPTQ, PPL, the flat_parameters,
    flat_matrices and packed safetensors exports and a 16-token demo
    through the kernels. Launch counts set to 0 before the run and read
    after it (only the demo launches kernels, all of them
    w4a4_matmul_i8), every launch held bit for bit to its plain version
    at the CLI's shapes (_checked_w4a4; one check per counted launch).
    Then each export reloads equal to what the run held, and the reloaded
    safetensors serve the same demo tokens. The exports go to a scratch
    directory under the checkout, removed after."""
    import shutil
    import tempfile

    from flatquant_torch import main as cli
    from flatquant_torch.kernels import common
    from flatquant_torch.quantize.state import init_model_fq
    from flatquant_torch.serving import quantized
    from flatquant_torch.serving.engine import generate
    from flatquant_torch.utils import checkpoint as ckpt
    from flatquant_torch.utils.reference_convert import (
        matrices_fq_template, matrices_state)

    scratch = os.path.abspath(".chipscratch")
    os.makedirs(scratch, exist_ok=True)
    out_dir = tempfile.mkdtemp(dir=scratch, prefix="phase14_")
    argv = CLI_ARGV + ["--output_dir", out_dir] + (
        ["--platform", "cpu"] if dev.type == "cpu" else [])
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n = [0]
        common.reset_launches()
        t0 = time.perf_counter()
        with patched([(quantized, "w4a4_matmul_i8",
                       _checked_w4a4(torch, n))]):
            out = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in common.LAUNCHES.items() if v}
        peak = torch.cuda.max_memory_allocated() / 2**30
        cfg, fq, exp = out["cfg"], out["fq_cfg"], out["exp_dir"]
        ppl = out["ppl"]["wikitext2"]
        if not math.isfinite(ppl) or set(launches) != {"w4a4_matmul_i8"}:
            raise AssertionError(f"PPL {ppl}, launches {launches}")
        if n[0] != launches["w4a4_matmul_i8"]:
            raise AssertionError(f"{n[0]} w4a4_matmul_i8 launches checked "
                                 f"of {launches['w4a4_matmul_i8']}")
        n_params = _leaves_equal(torch, ckpt.load_flat_parameters(
            exp, init_model_fq(cfg, fq, seed=0, device=dev)), out["fq"],
            "flat_parameters")
        _leaves_equal(torch, ckpt.load_flat_matrices(
            exp, matrices_fq_template(cfg, fq, seed=0, device=dev)),
            matrices_state(out["fq"]), "flat_matrices")
        path = os.path.join(exp, "model_packed_int4.safetensors")
        sp = ckpt.load_packed_safetensors(path, out["serving"])
        n_tensors = _leaves_equal(torch, sp, out["serving"],
                                  "the packed safetensors")
        toks = generate(cfg, fq, sp, out["prompt"], max_new_tokens=16,
                        max_len=64, use_kernel=True, device=dev).tolist()
        if toks != out["tokens"]:
            raise AssertionError(f"the reloaded export serves {toks}, the "
                                 f"run served {out['tokens']}")
        sizes = {f: os.path.getsize(os.path.join(exp, f)) / 2**20
                 for f in sorted(os.listdir(exp)) if not f.startswith("log")}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    secs = out["seconds"]
    log(f"  [{smi}] (a) CLI, {cfg.name} ({cfg.num_layers} layers, hidden "
        f"{cfg.hidden_size}, vocab {cfg.vocab_size}): {wall:.1f} s in all; "
        f"by stage {secs}; max_memory_allocated {peak:.2f} GiB")
    log(f"  (a) wikitext2 (synthetic) PPL {ppl:.4f}; demo tokens "
        f"{out['tokens']}; launches {launches}, every one bit-exact to "
        f"its plain version ({n[0]} checked)")
    log(f"  (a) reloads: flat_parameters ({n_params} tensors) and "
        f"flat_matrices equal, the packed safetensors ({n_tensors} tensors) "
        f"equal and serving the same 16 tokens; file MiB {sizes}")
    return dict(model=cfg.name, wall_s=wall, seconds=secs, peak_gib=peak,
                ppl=ppl, tokens=out["tokens"], launches=launches,
                per_launch_checks=dict(launches=n[0], max_abs_err=0.0),
                export_mib=sizes), launches


def run_calib_llama_path(torch, dev, smi):
    """Phase 14 (b): llama-2-7b at full width, 2 layers, W4A4KV4 with
    tpu_decompose and every learnable group: calibrate (16 samples of
    2048 tokens in batches of 4, 1 epoch), bake_model, gptq_model,
    build_serving_params(merge_projections=True) from the GPTQ weights;
    then a 1 x 2048 prefill and 8 decode steps over the int4 cache,
    timed, and the same run with every launch held to its plain version
    (check_every_launch)."""
    import dataclasses

    from flatquant_torch.calib.data import get_loaders
    from flatquant_torch.calib.gptq import gptq_model
    from flatquant_torch.calib.trainer import calibrate
    from flatquant_torch.models.config import get_config
    from flatquant_torch.models.llama import init_params
    from flatquant_torch.quantize.bake import bake_model
    from flatquant_torch.quantize.spec import W4A4KV4
    from flatquant_torch.quantize.state import init_model_fq
    from flatquant_torch.serving.quantized import build_serving_params

    cfg = dataclasses.replace(get_config("llama-2-7b"), num_layers=2)
    fq = dataclasses.replace(W4A4KV4, tpu_decompose=True, epochs=1,
                             nsamples=16, cali_bsz=4)
    toks = get_loaders("synthetic", cfg.vocab_size, nsamples=16, seqlen=2048,
                       seed=0).train
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device=dev)
    state = init_model_fq(cfg, fq, seed=0, device=dev)
    hist, ghist = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = calibrate(cfg, fq, params, state, toks,
                      log=lambda m: log("  (b) " + m), history=hist)
    calib_s = time.perf_counter() - t0
    calib = _calib_summary(hist, "(b)")
    baked, bfq = bake_model(cfg, fq, params, state)
    del params, state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gp = gptq_model(cfg, fq, baked, bfq, toks, log=lambda m: None,
                    history=ghist)
    gptq_s = time.perf_counter() - t0
    sp = build_serving_params(cfg, fq, baked, bfq, dtype=torch.bfloat16,
                              merge_projections=True, eval_params=gp)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    del baked, bfq, gp
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  [{smi}] (b) {cfg.name} width, {cfg.num_layers} layers: "
        f"calibrate {calib_s:.1f} s (median step by layer "
        f"{[round(t, 3) for t in calib['step_s_median']]} s, teacher passes "
        f"{[round(t, 3) for t in calib['teacher_s']]} s), gptq_model "
        f"{gptq_s:.1f} s ({[round(h['seconds'], 2) for h in ghist]} s per "
        f"layer, {ghist[0]['columns']} columns each); max_memory_allocated "
        f"{peak:.2f} GiB")
    log(f"  (b) MSE by (layer, epoch): "
        f"{[h['epoch_mse'] for h in hist]}; by step "
        f"{[h['step_mse'] for h in hist]}")
    B, S, NEW = 1, 2048, 8
    gen = torch.Generator(device=dev).manual_seed(7)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    kw = dict(max_len=S + 256, device=dev)
    run = _timed_serving(torch, cfg, fq, sp, prompt, NEW, kw, "int4")
    del run["cache"], run["tok"]
    _check_counts({k: run["prefill_launches"][k]
                   for k in LONG_PREFILL_LAUNCHES}, LONG_PREFILL_LAUNCHES,
                  cfg.num_layers, "(b) prefill")
    log(f"  [{smi}] (b) prefill B={B} S={S} {run['prefill_ms']:.1f} ms, "
        f"decode median {run['decode_ms']:.2f} ms/step ({NEW} steps); "
        f"launches {run['launches']}")
    checks = check_every_launch(torch, cfg, fq, sp, prompt, kw, NEW,
                                LONG_PREFILL_LAUNCHES, CALIB_STEP,
                                "(b) calibrated llama-2-7b, 2 layers")
    del sp
    gc.collect()
    torch.cuda.empty_cache()
    return dict(model="llama-2-7b", layers=cfg.num_layers, calibrate_s=calib_s,
                gptq_s=gptq_s, gptq_layers=ghist, peak_gib=peak,
                per_launch_checks=checks, serve=run, **calib), run["launches"]


def run_calib_deepseek_path(torch, dev, smi):
    """Phase 14 (c): DeepSeek-V2-Lite's width (DeepSeekConfig()) cut to 1
    dense and 1 MoE layer with all 64 experts, W4A4 with every learnable
    group: init_ds_fq, calibrate_deepseek (2 samples of 512 tokens, batch
    1, 1 epoch), bake_ds_fq, build_ds_serving_params; then
    deepseek_generate of a 1 x 512 prompt (the gather MoE) and 8 decode
    steps, timed, and again with every w4a4_matmul_i8 launch held bit for
    bit to its plain version (_checked_w4a4)."""
    import dataclasses

    from flatquant_torch.calib.data import get_loaders
    from flatquant_torch.models import deepseek as ds
    from flatquant_torch.quantize.spec import W4A4
    from flatquant_torch.serving import quantized

    cfg = dataclasses.replace(ds.DeepSeekConfig(), n_layers=2,
                              n_dense_layers=1)
    fq = dataclasses.replace(W4A4, epochs=1, nsamples=2, cali_bsz=1)
    toks = get_loaders("synthetic", cfg.vocab_size, nsamples=2, seqlen=512,
                       seed=0).train
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = ds.init_ds_params(cfg, seed=0, device=dev)
    dense, moe = ds.init_ds_fq(cfg, fq, seed=0, device=dev)
    hist = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense, moe = ds.calibrate_deepseek(cfg, fq, params, dense, moe, toks,
                                       log=lambda m: log("  (c) " + m),
                                       history=hist)
    calib_s = time.perf_counter() - t0
    calib = _calib_summary(hist, "(c)")
    baked = ds.bake_ds_fq(dense, moe)
    t0 = time.perf_counter()
    sp, fq_serve = ds.build_ds_serving_params(cfg, fq, params, dense, moe)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    if len(baked[1]) != 1 or baked[1][0]["ffn"]["w1_trans"] is None:
        raise AssertionError("bake_ds_fq lost the MoE layer's transforms")
    del params, dense, moe, baked
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  [{smi}] (c) {cfg.name} width (V2-Lite), 1 dense + 1 MoE layer, "
        f"{cfg.n_routed_experts} experts: calibrate_deepseek {calib_s:.1f} s "
        f"(median step by layer "
        f"{[round(t, 3) for t in calib['step_s_median']]} s, teacher passes "
        f"{[round(t, 3) for t in calib['teacher_s']]} s), "
        f"build_ds_serving_params {pack_s:.1f} s; max_memory_allocated "
        f"{peak:.2f} GiB; MSE by (layer, epoch) "
        f"{[h['epoch_mse'] for h in hist]}")
    B, S, NEW = 1, 512, 8
    gen = torch.Generator(device=dev).manual_seed(9)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=dev)
    run = _timed_generate(torch, cfg, fq_serve, fq, sp, prompt, NEW, S + 128,
                          dev)
    # wq, wkv_a, wo and the dense FFN's or shared experts' three linears
    fwd = 6 * cfg.n_layers
    if (run["prefill_launches"] != {"w4a4_matmul_i8": fwd}
            or run["launches"] != {"w4a4_matmul_i8": fwd * (1 + NEW)}):
        raise AssertionError(f"(c) launches {run['prefill_launches']}, "
                             f"{run['launches']}; expected w4a4_matmul_i8 "
                             f"{fwd} per forward")
    n = [0]
    with patched([(quantized, "w4a4_matmul_i8", _checked_w4a4(torch, n))]):
        ds.deepseek_generate(cfg, sp, fq_serve, fq, prompt,
                             max_new_tokens=NEW, max_len=S + 128,
                             mode="serve", device=dev)
        torch.cuda.synchronize()
    if n[0] != fwd * (1 + NEW):
        raise AssertionError(f"(c) {n[0]} launches checked, expected "
                             f"{fwd * (1 + NEW)}")
    log(f"  [{smi}] (c) prefill B={B} S={S} {run['prefill_ms']:.1f} ms, "
        f"decode median {run['decode_ms']:.2f} ms/step ({NEW} steps); every "
        f"w4a4_matmul_i8 launch of a prefill and {NEW} steps ({n[0]}) "
        "bit-exact against its plain version")
    del sp, fq_serve
    gc.collect()
    torch.cuda.empty_cache()
    return dict(model="deepseek-v2-lite", layers=cfg.n_layers,
                calibrate_s=calib_s, pack_s=pack_s, peak_gib=peak,
                per_launch_checks=dict(launches=n[0], max_abs_err=0.0),
                serve=run, **calib), run["launches"]


def run_calibrate_path(torch, dev, results, smi):
    """Phase 14: (a) the CLI, (b) llama-2-7b-width calibration, (c)
    DeepSeek-V2-Lite-width calibration; returns the serve runs' launches
    by path."""
    rec, paths = {}, {}
    for key, fn in (("cli", run_cli_path), ("calib_llama",
                                            run_calib_llama_path),
                    ("calib_deepseek", run_calib_deepseek_path)):
        rec[key], paths[key] = fn(torch, dev, smi)
    results["calibrate_path"] = rec
    return paths


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
        replaces="flatquant_tpu/kernels/kv_cache.py:735",
        body="a warp per (slot, kv head), 16-byte code chunks and float2 "
        "params loaded beside pos"),
    "rmsnorm_right_flat": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/flat_pipeline.cu",
        replaces="flatquant_tpu/kernels/flat_pipeline.py:84",
        body="wgmma m64n16k16 bf16 (R^T as register A, 16 tokens as N), "
        "clusters of 2 CTAs splitting the columns, each CTA's half of x "
        "in shared memory"),
    "left_quant_i8_flat": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/flat_pipeline.cu",
        replaces="flatquant_tpu/kernels/flat_pipeline.py:154"),
    "w4a4_matmul_i8_swiglu_right": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/flat_pipeline.cu",
        replaces="flatquant_tpu/kernels/flat_pipeline.py:235",
        body="wgmma s8 tile (csrc/w4a4_tile.cuh, up and gate), right "
        "factor on wgmma bf16"),
    "attn_prologue": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/attn_prologue.cu",
        replaces="flatquant_tpu/kernels/attn_prologue.py:161",
        body="bf16 qkv: wgmma bf16 products, qkv by TMA, RoPE in registers "
        "(mma); float32 qkv: CUDA-core float32 products (simt) "
        "(prologue_body)"),
    "flash_prefill_attention_kt": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/flash_prefill.cu",
        replaces="flatquant_tpu/kernels/prefill_attention.py:233",
        body="wgmma q k^T and p v, K / V by TMA from a producer warp, two "
        "consumer warpgroups"),
    "flash_prefill_attention": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/flash_prefill.cu",
        replaces="flatquant_tpu/kernels/prefill_attention.py:117",
        body="row 8's body"),
    "chunk_attention_int4": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/kv_cache.cu",
        replaces="flatquant_tpu/kernels/kv_cache.py:624"),
    "paged_decode_attention_int4": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/kv_cache.cu",
        replaces="flatquant_tpu/kernels/paged_kv.py:213"),
    "paged_chunk_attention_int4": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/kv_cache.cu",
        replaces="flatquant_tpu/kernels/paged_kv.py:337"),
    "quant_acts_i8": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/int4_matmul.cu",
        replaces="flatquant_tpu/kernels/int4_matmul.py:139"),
    "w4a4_matmul_i8_swiglu": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/flat_pipeline.cu",
        replaces="flatquant_tpu/kernels/int4_matmul.py:417",
        body="wgmma s8 tile (csrc/w4a4_tile.cuh, up and gate)"),
    "w4a8_matmul": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/int4_matmul.cu",
        replaces="flatquant_tpu/kernels/int4_matmul.py:213",
        body="weight stream up to 8 rows, wgmma bf16 tile above "
        "(w4a8_body)"),
    "fp8_matmul": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/fp8_matmul.cu",
        replaces="flatquant_tpu/kernels/fp8_matmul.py:188"),
    "w4a4_matmul_i8_fusedq": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/int4_matmul.cu",
        replaces="flatquant_tpu/kernels/int4_matmul.py:553"),
    "flash_prefill_attention_kt_i8": dict(
        route="cuda",
        source="flatquant_torch/kernels/csrc/flash_prefill_i8.cu",
        replaces="flatquant_tpu/kernels/prefill_attention.py:377"),
    "decode_attention_int4_v1": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/kv_cache.cu",
        replaces="flatquant_tpu/kernels/kv_cache.py:190"),
    "decode_attention_int4_wide": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/kv_cache.cu",
        replaces="flatquant_tpu/kernels/kv_cache.py:291"),
    "decode_attention_int4_v3": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/kv_cache.cu",
        replaces="flatquant_tpu/kernels/kv_cache.py:386"),
    "w4a4_swiglu_grouped": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/flat_pipeline.cu",
        replaces="flatquant_tpu/kernels/grouped_mlp.py:71",
        body="row 6's body, GROUPED_OUT"),
    "left_quant_i8_grouped": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/flat_pipeline.cu",
        replaces="flatquant_tpu/kernels/grouped_mlp.py:170"),
    "quant_acts_i8_grouped": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/int4_matmul.cu",
        replaces="flatquant_tpu/kernels/grouped_mlp.py:238"),
    "w4a4_matmul_i8_grouped": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/int4_matmul.cu",
        replaces="flatquant_tpu/kernels/grouped_mlp.py:323"),
    "rmsnorm_right_grouped": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/flat_pipeline.cu",
        replaces="flatquant_tpu/kernels/grouped_mlp.py:424",
        body="row 4's body, GROUPED"),
    "w4a4_swiglu_grouped_gx": dict(
        route="cuda", source="flatquant_torch/kernels/csrc/flat_pipeline.cu",
        replaces="flatquant_tpu/kernels/grouped_mlp.py:505",
        body="row 6's body, GROUPED_IN and GROUPED_OUT"),
}
# the path each kernel's `launches` is read from (each path's counts set to
# 0 just before it and read just after): the decode-serving run of phase 4
# for slice 1's kernels, the 4 x 512 prefill of phase 5 for slice 2's, the
# int4 engine's 1 x 2048 prefill + decode (phase 6a) for flash kt, the
# bf16 comparator's (phase 6c) for flash, the batcher's runs (a) int4
# and (b) paged (phase 7) for slice 4's, Qwen-2.5-7B's prefill + decode
# (phase 8) for rows 12 and 13, the W4A16 llama-2-7b's (phase 9) for
# row 14, DeepSeek-V2-Lite's native-FP8 prefill + decode (phase 10 (a))
# for row 16, and phase 11's runs of rows 17-21 in place of their twins:
# (a) the fused-quant decode for row 17, (b) the decode with each of rows
# 19-21 at row 2's call site, (c) the 1 x 2048 prefill with row 18 (pv_i8,
# JAX's default) at row 8's; and phase 12's 1 x 2048 prefills, (a) fully
# grouped for rows 23, 25, 26 and 27, (b) the round-2 tail for rows 22 and
# 24
# where the kernel line reads a kernel's launches by body: (results key,
# entry, BODY_LAUNCHES key)
KERNEL_BODIES = {
    "w4a8_matmul": ("w4a16_path", "bodies", "w4a8_matmul"),
    "attn_prologue": ("prefill_path", "prefill_bodies", "attn_prologue"),
}
KERNEL_PATH = dict(
    dict.fromkeys(("w4a4_matmul_i8", "decode_attention_int4", "write_token"),
                  "decode"),
    **dict.fromkeys(("rmsnorm_right_flat", "left_quant_i8_flat",
                     "w4a4_matmul_i8_swiglu_right", "attn_prologue"),
                    "prefill"),
    flash_prefill_attention_kt="long_prefill",
    flash_prefill_attention="bf16_comparator",
    chunk_attention_int4="batcher_int4",
    paged_decode_attention_int4="batcher_paged",
    paged_chunk_attention_int4="batcher_paged",
    quant_acts_i8="qwen", w4a4_matmul_i8_swiglu="qwen", w4a8_matmul="w4a16",
    fp8_matmul="deepseek_fp8", w4a4_matmul_i8_fusedq="baseline_fusedq",
    flash_prefill_attention_kt_i8="baseline_i8_prefill",
    decode_attention_int4_v1="baseline_v1",
    decode_attention_int4_wide="baseline_wide",
    decode_attention_int4_v3="baseline_v3",
    **dict.fromkeys(("rmsnorm_right_grouped", "left_quant_i8_grouped",
                     "w4a4_swiglu_grouped_gx", "w4a4_matmul_i8_grouped"),
                    "grouped_full"),
    w4a4_swiglu_grouped="grouped_round2",
    quant_acts_i8_grouped="grouped_round2")
DECODE_KERNELS = [k for k, p in KERNEL_PATH.items() if p == "decode"]
SWIGLU_ROWS = ("w4a4_matmul_i8_swiglu_right", "w4a4_matmul_i8_swiglu",
               "w4a4_swiglu_grouped", "w4a4_swiglu_grouped_gx")


def kernel_line(results, paths):
    """One entry per kernel at its path's shapes. Slice 1's at the decode
    shapes: the GEMM as one layer's four projections at M=4, attention at
    B=4 MHA over the valid lengths of the last generate step, the write at
    B=4. Slice 2's at the 4 x 512 prefill: left_quant_i8_flat as one
    layer's four launches (three at K=4096, one at K=11008). Slice 3's at
    llama-2-7b's 1 x 2048 prefill (32/32 heads). Rows 12 and 13 at
    Qwen-2.5-7B's prefill shapes (the down input [2048, 18944], the MLP
    GEMM at M=2048); row 14 as one W4A16 llama-2-7b layer's four linears
    at M=1 (the B=1 decode of phase 9). Row 17 as row 1 (one layer's four
    linears at M=4), row 18 at llama-2-7b's 1 x 2048 with pv_i8, rows
    19-21 at row 2's shape. Rows 22-27 at the 1 x 2048 prefill's shapes:
    row 25 as one layer's qkv + down, row 23 as one layer's three
    launches (2 x G=32, 1 x G=86). paths: {path: launches read around
    it}."""
    out = []
    for name, meta in KERNELS.items():
        r = results[name]
        weights = None
        if name in ("w4a4_matmul_i8", "w4a4_matmul_i8_fusedq"):
            # rows 1 and 17: phase 3a's sweep rows (3i's and 3j's carry a
            # "case")
            rows = [x for x in r["rows"] if x["m"] == 4 and "case" not in x]
            at = "M=4 (B=4 decode), sum of qkv+o+upgate+down of one layer"
        elif name.startswith("decode_attention_int4"):
            rows = [x for x in r["rows"] if x["case"].endswith("main path")]
            at = "B=4 MHA 32/32 S=2048, valid lengths of the last step"
        elif name == "write_token":
            rows = [x for x in r["rows"] if x["B"] == 4]
            at = "B=4 nkv=32 S=2048"
        elif name == "quant_acts_i8":
            rows = [x for x in r["rows"] if x["case"].startswith("[2048,")]
            at = rows[0]["case"]
        elif name in SWIGLU_ROWS:
            rows = [x for x in r["rows"] if x["m"] == 2048]
            at = rows[0]["case"]
        elif name == "w4a8_matmul":
            rows = [x for x in r["rows"] if x["m"] == 1]
            at = "M=1 (B=1 decode), sum of qkv+o+upgate+down of one layer"
        elif name == "fp8_matmul":
            # s_w1/s_w3 and e_w1/e_w3 share a shape: timed once, counted twice
            rows = [x for x in r["rows"] if x["m"] == 1]
            weights = [2 if x["proj"] in ("s_w1", "e_w1") else 1
                       for x in rows]
            at = ("M=1 (B=1 decode), one MoE layer's 8 fp8 linears: wq, wo, "
                  "s_w1, s_w3, s_w2 and the 64-expert e_w1, e_w3, e_w2")
        elif name == "left_quant_i8_flat":
            rows, weights = r["rows"], [3, 1]
            at = ("T=2048, one layer: 3 x K=4096 (ln1, o, ln2) + "
                  "1 x K=11008 (down)")
        elif name == "left_quant_i8_grouped":
            rows, weights = r["rows"], [2, 1]
            at = ("T=2048, one layer: 2 x G=32 (ln1, ln2) + 1 x G=86 "
                  "(down)")
        elif name == "w4a4_matmul_i8_grouped":
            rows = [x for x in r["rows"] if x["m"] == 2048]
            at = ("M=2048 (1 x 2048 prefill, tile body), sum of qkv + down "
                  "of one layer")
        elif name.startswith("flash_prefill") or name == "attn_prologue":
            rows = r["rows"][:1]
            at = rows[0]["case"]
        elif name in ("chunk_attention_int4", "paged_chunk_attention_int4",
                      "paged_decode_attention_int4"):
            # MHA at a middle chunk (768; paged: 640, straddling a block
            # edge), and the paged decode at valid [1, 255, 256, 1000]
            rows = [x for x in r["rows"] if x["nkv"] == 32][1:2] \
                if name == "chunk_attention_int4" else r["rows"][:1]
            at = rows[0]["case"]
        else:
            rows = r["rows"]
            at = rows[0]["case"]
        weights = weights or [1] * len(rows)

        def total(key):
            return sum(w * x[key] for w, x in zip(weights, rows))

        lib = (total("library_ms") if all(x.get("library_ms") is not None
                                          for x in rows) else None)
        by = {x["bound_by"] for x in rows}
        # launches by body on the path (row 14: phase 9's timed run; row 7:
        # phase 5's prefill)
        body_of = KERNEL_BODIES.get(name)
        by_body = (results.get(body_of[0], {}).get(body_of[1], {})
                   .get(body_of[2]) if body_of else None)
        out.append(dict(
            name=name, **meta,
            launches=paths.get(KERNEL_PATH[name], {}).get(name, 0),
            **({"launches_by_body": by_body} if by_body else {}),
            launches_by_path={p: c.get(name, 0) for p, c in paths.items()},
            max_abs_err=r["max_abs_err"], ms=total("ms"),
            plain_ms=total("plain_ms"), bound_ms=total("bound_ms"),
            bound_by=by.pop() if len(by) == 1 else "bytes", library_ms=lib,
            at=at))
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="",
                    help="comma-separated phases to run after 1-2 (3a-3j, "
                    "3 for all of them, 4-14; 6 runs 6a-6c); the default "
                    "is all. A partial run prints no kernel table")
    args = ap.parse_args(argv)
    only = set(filter(None, args.phases.split(",")))

    def want(*names):
        return not only or bool(only & set(names))

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
    failed, results, paths = [], {}, {}

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
    kernel_phases = [
        ("3a", "w4a4_matmul_i8 vs w4a8_matmul_ref, w4a4_matmul_i8_fusedq "
         "vs quant_acts_i8 + w4a4_matmul_i8, both bodies each",
         lambda *a: (check_gemm(*a), check_fusedq(*a))),
        ("3b", "decode_attention_int4 vs decode_attention_ref",
         lambda *a: check_attention(*a, main_valid)),
        ("3c", "write_token vs the masked select", check_write),
        ("3d", "prefill kernels vs their plain versions",
         check_prefill_kernels),
        ("3e", "flash prefill attention vs its plain versions", check_flash),
        ("3f", "chunk and paged attention vs their plain versions",
         check_chunk_paged),
        ("3g", "quant_acts_i8, w4a4_matmul_i8_swiglu, w4a8_matmul vs their "
         "plain versions", check_quant_mode_kernels),
        ("3h", "fp8_matmul (row 16) and w4a4_matmul_i8 at DeepSeek-V2-Lite's "
         "shapes vs their plain versions", check_fp8_kernels),
        ("3i", "rows 17-21, the JAX package's kernel baselines, vs their "
         "plain versions", check_baseline_kernels),
        ("3j", "rows 22-27, the grouped layout, vs their plain versions and "
         "flat twins; row 1 at M=2048", check_grouped_kernels)]
    for key, what, fn in kernel_phases:
        if not failed and want(key, "3"):
            phase(f"phase {key}: {what}", fn, torch, dev, gen, results)
    # the serving phases run when every kernel check passed
    serve = not failed
    model = None
    if serve and want("4", "5", "6"):
        # the kernel checks' inputs and graph pools go back to the card
        # before the path runs start
        gc.collect()
        torch.cuda.empty_cache()
        model = phase("build the random llama-2-7b (shared by phases 4-6)",
                      build_model, torch, dev, 0)
    if model is not None:
        if want("4"):
            paths["decode"] = phase("phase 4: llama-2-7b decode-serving path",
                                    run_main_path, torch, dev, model,
                                    results, smi) or {}
        if want("5"):
            paths["prefill"] = phase(
                "phase 5: llama-2-7b fused prompt prefill (4 x 512)",
                run_prefill_path, torch, dev, model, results, smi) or {}
        if want("6"):
            paths["long_prefill"], paths["all_logits"] = phase(
                "phase 6a/b: llama-2-7b 1 x 2048 prefill, int4 and bf16 "
                "caches", run_long_prefill_path, torch, dev, model, results,
                smi) or ({}, {})
        model = None  # freed; a later phase may test it
        gc.collect()
        torch.cuda.empty_cache()
        if want("6"):
            paths["bf16_comparator"] = phase(
                "phase 6c: the bf16 comparator, llama-2-7b 1 x 2048",
                run_bf16_comparator, torch, dev, results, smi) or {}
    if serve and want("7", "11", "12"):
        model = phase("rebuild the random llama-2-7b (seed 0) for phases 7, "
                      "11 and 12", build_model, torch, dev, 0)
    if model is not None:
        if want("7"):
            paths.update(phase(
                "phase 7: llama-2-7b under the continuous batcher",
                run_batcher_path, torch, dev, model, results, smi) or {})
        if want("11"):
            paths.update(phase(
                "phase 11: rows 17-21 in place of their twins on llama-2-7b "
                "(decode B=4, prefill 1 x 2048)", run_baseline_paths, torch,
                dev, model, results, smi) or {})
        if want("12"):
            paths.update(phase(
                "phase 12: rows 22-27 at their flat twins' call sites on "
                "llama-2-7b (1 x 2048 prefill)", run_grouped_paths, torch,
                dev, model, results, smi) or {})
        model = None  # freed; a later phase may test it
        gc.collect()
        torch.cuda.empty_cache()
    serving = [("8", "qwen", "phase 8: Qwen-2.5-7B, balanced split, 1 x 2048 "
                "+ 32 decode steps", run_qwen_path),
               ("9", "w4a16", "phase 9: llama-2-7b W4A16, 1 x 2048 + 32 "
                "decode steps", run_w4a16_path)]
    for key, path, what, fn in serving:
        if serve and want(key):
            paths[path] = phase(what, fn, torch, dev, results, smi) or {}
    if serve and want("10"):
        paths.update(phase(
            "phase 10: DeepSeek-V2-Lite, native FP8 (1 x 2048 + 32 decode "
            "steps, the batcher) and packed W4A4", run_deepseek_path, torch,
            dev, results, smi) or {})
    if serve and want("13"):
        paths.update(phase(
            "phase 13: llama-2-7b through the port's own build chain "
            "(init_model_fq -> bake_model -> build_serving_params), merged, "
            "unmerged and perm layouts", run_build_chain_path, torch, dev,
            results, smi) or {})
    if serve and want("14"):
        paths.update(phase(
            "phase 14: the calibrate -> eval pipeline (the CLI on "
            "qwen-2.5-0.5b; calibration, GPTQ and serving at llama-2-7b and "
            "DeepSeek-V2-Lite widths)", run_calibrate_path, torch, dev,
            results, smi) or {})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=smi, torch=torch.__version__,
                       failed=failed, results=results), f, indent=1)
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    if not only:
        print(json.dumps(kernel_line(results, paths)), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
