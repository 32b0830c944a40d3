"""The port's continuous batcher, paged pool and chunk phase against the
JAX package, on the CPU.

Kernels: seeded numpy inputs go through JAX's Pallas kernels in interpret
mode (as tests/test_kv_kernel.py and tests/test_paged_kv.py run them) and
through the port's plain versions, which its wrappers run for CPU tensors.
Pool writes, the allocator, `_forward(..., "chunk")`, `generate` over the
paged cache and `ContinuousBatcher` (modes bf16/int4/paged, whole,
bucketed and chunked prefill, deferred admission, eos, slot reuse,
chunk/decode interleaving) go through both packages on `tiny-llama`
float32 (merged projections, lm_head sharpened 6x against greedy ties),
and one `mini-128` run takes the fused routes and the chunk kernels'
routes on both sides (use_kernel=True).

Tolerances, and why:
  - the plain attention versions against the Pallas kernels: 2e-5, the
    JAX package's own (the kernels fold scale and zero into their
    epilogues and sum in another order);
  - pool writes, the allocator, greedy tokens, and the packed codes and
    block tables of serving state after conversion (utils/convert.py):
    exact;
  - float entries of serving state (scale/zero params, bf16-cache
    values): 1e-5 relative. Float32 K/V come out of GEMMs and rotations
    that XLA and torch sum in other orders, so a scale may lie one ulp
    apart; the codes do not move;
  - logits: 1e-4 (float32 on both sides, summation order only).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flatquant_tpu.kernels import paged_kv as jpk
from flatquant_tpu.kernels.kv_cache import chunk_attention_int4_v4
from flatquant_tpu.models.config import LlamaConfig as JLlamaConfig
from flatquant_tpu.models.config import get_config as j_get_config
from flatquant_tpu.models.llama import init_params as j_init_params
from flatquant_tpu.quantize.bake import bake_model
from flatquant_tpu.quantize.spec import W4A4KV4 as J_W4A4KV4
from flatquant_tpu.quantize.state import init_model_fq
from flatquant_tpu.serving import engine as je
from flatquant_tpu.serving import paged as jpaged
from flatquant_tpu.serving.batcher import ContinuousBatcher as JBatcher
from flatquant_tpu.serving.quantized import (
    build_serving_params as j_build_serving_params,
)
from flatquant_torch.kernels import kv_cache as tkv
from flatquant_torch.kernels import paged_kv as tpk
from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.models.config import get_config
from flatquant_torch.quantize.spec import W4A4KV4
from flatquant_torch.serving import engine as te
from flatquant_torch.serving import paged as tpaged
from flatquant_torch.serving.batcher import ContinuousBatcher
from flatquant_torch.utils.convert import (
    from_jax_cache,
    from_jax_serving_params,
    to_jax_cache,
)

torch.set_num_threads(2)

MINI = dict(name="mini-128", vocab_size=128, hidden_size=256,
            intermediate_size=512, num_layers=2, num_heads=2,
            num_kv_heads=2, head_dim=128, seqlen=256)
BS = 128  # pool block size of the tiny-llama runs (JAX's smallest)


def _packed_model(jcfg, jfq):
    params = j_init_params(jcfg, seed=0)
    params["lm_head"] = params["lm_head"] * 6.0  # sharpen: no greedy ties
    bp, bfq = bake_model(jcfg, jfq, params, init_model_fq(jcfg, jfq, seed=0))
    sp = j_build_serving_params(jcfg, jfq, bp, bfq, dtype=jnp.float32,
                                merge_projections=True)
    return sp, from_jax_serving_params(jax.tree.map(np.asarray, sp),
                                       device="cpu")


@pytest.fixture(scope="module")
def tiny():
    sp, tsp = _packed_model(j_get_config("tiny-llama"), J_W4A4KV4)
    return dict(jcfg=j_get_config("tiny-llama"), jfq=J_W4A4KV4, sp=sp,
                cfg=get_config("tiny-llama"), fq=W4A4KV4, tsp=tsp)


@pytest.fixture(scope="module")
def mini():
    jcfg = JLlamaConfig(**MINI)
    jfq = dataclasses.replace(J_W4A4KV4, tpu_decompose=True)
    sp, tsp = _packed_model(jcfg, jfq)
    return dict(jcfg=jcfg, jfq=jfq, sp=sp, cfg=LlamaConfig(**MINI),
                fq=dataclasses.replace(W4A4KV4, tpu_decompose=True), tsp=tsp)


def _t(a):
    return torch.from_numpy(np.array(a))


def _token_major(a):
    """JAX's v4 layout (token index last) -> the port's token-major."""
    return _t(np.swapaxes(np.asarray(a), -1, -2)).contiguous()


# ---------------------------------------------------------------------------
# rows 9-11: plain versions against JAX's Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


def _v4_cache(rng, lead, nkv, hd, n):
    """Random packed codes [lead, nkv, hd/2, n] and params
    [lead, nkv, 2, n] (scale > 0, integer zero) in JAX's v4 layout."""
    codes = rng.integers(0, 256, (lead, nkv, hd // 2, n)).astype(np.uint8)
    params = np.stack([rng.uniform(0.01, 0.2, (lead, nkv, n)),
                       rng.integers(0, 16, (lead, nkv, n))], axis=2)
    return codes, params.astype(np.float32)


@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("kernel", ["chunk", "paged_decode", "paged_chunk"])
def test_plain_versions_match_jax_kernels(kernel, n_rep):
    rng = np.random.default_rng(n_rep)
    nkv, hd, sm = 2, 32, 1.0 / np.sqrt(32)
    nh = nkv * n_rep
    if kernel == "chunk":
        B, S, sq = 3, 256, 24
        kc, kpr = _v4_cache(rng, B, nkv, hd, S)
        vc, vpr = _v4_cache(rng, B, nkv, hd, S)
        q = rng.normal(size=(B, sq, nh, hd)).astype(np.float32)
        pos = np.array([0, 100, S - sq], np.int32)
        want = chunk_attention_int4_v4(jnp.asarray(q), kc, kpr, vc, vpr,
                                       jnp.asarray(pos), sm, interpret=True)
        port = (_t(q), _token_major(kc), _token_major(kpr), _token_major(vc),
                _token_major(vpr), _t(pos), sm)
        fns = (tkv.chunk_attention_ref, tkv.chunk_attention_int4)
    else:
        B, mb = (3, 2) if kernel == "paged_decode" else (2, 2)
        nb = 1 + B * mb
        kc, kpr = _v4_cache(rng, nb, nkv, hd, BS)
        vc, vpr = _v4_cache(rng, nb, nkv, hd, BS)
        tbl = (rng.permutation(B * mb) + 1).reshape(B, mb).astype(np.int32)
        if kernel == "paged_decode":
            q = rng.normal(size=(B, nh, hd)).astype(np.float32)
            arg = np.array([0, 129, 256], np.int32)  # valid lengths
            jfn = jpk.paged_decode_attention_int4
            fns = (tpk.paged_decode_attention_ref,
                   tpk.paged_decode_attention_int4)
        else:
            q = rng.normal(size=(B, 40, nh, hd)).astype(np.float32)
            arg = np.array([100, 200], np.int32)  # chunks straddle a block
            jfn = jpk.paged_chunk_attention_int4
            fns = (tpk.paged_chunk_attention_ref,
                   tpk.paged_chunk_attention_int4)
        want = jfn(jnp.asarray(q), kc, kpr, vc, vpr, jnp.asarray(tbl),
                   jnp.asarray(arg), sm, interpret=True)
        port = (_t(q), _token_major(kc), _token_major(kpr), _token_major(vc),
                _token_major(vpr), _t(tbl), _t(arg), sm)
    for fn in fns:  # the plain version, and the wrapper on CPU tensors
        np.testing.assert_allclose(fn(*port).numpy(), np.asarray(want),
                                   atol=2e-5, rtol=2e-5, err_msg=fn.__name__)


# ---------------------------------------------------------------------------
# the pool: writes, gather, allocator, converters
# ---------------------------------------------------------------------------


def _pools(nb, nkv, hd):
    jpool = jpk.init_paged_pool(1, nb, nkv, hd, BS)
    tpool = tpk.init_paged_pool(1, nb, nkv, hd, BS, device="cpu")
    return jpool, tpool


@pytest.mark.parametrize("write", ["prompt", "chunk", "token"])
def test_pool_writes_byte_equal_to_jax(write):
    rng = np.random.default_rng(3)
    nkv, hd, nb = 2, 16, 8
    jpool, tpool = _pools(nb, nkv, hd)
    if write == "token":
        B, S = 4, 1
        # slot 2's table is the trash block's; slot 3 writes past its table
        # (JAX clamps the gather, the port clamps the column)
        tbl = np.array([[3, 5], [1, 7], [0, 0], [2, 4]], np.int32)
        pos = np.array([5, 130, 77, 2 * BS], np.int32)
    else:
        B = 2
        tbl = np.array([[3, 6], [1, 2]], np.int32)
        S = 170 if write == "prompt" else 100  # tail / straddles 128
    k = rng.normal(size=(B, S, nkv, hd)).astype(np.float32)
    from flatquant_tpu.kernels.kv_cache import pack_kv_transposed

    jc, jp = pack_kv_transposed(jnp.asarray(k))
    tc, tp = tkv.pack_kv_token_major(_t(k))
    jt, tt = jnp.asarray(tbl), _t(tbl)
    pc, pp = tpool["kp"][0], tpool["kparam"][0]
    if write == "prompt":
        want = jpk.write_prompt_paged(jpool["kp"][0], jpool["kparam"][0], jc,
                                      jp, jt)
        tpk.write_prompt_paged(pc, pp, tc, tp, tt)
    elif write == "chunk":
        want = jpk.write_chunk_paged(jpool["kp"][0], jpool["kparam"][0], jc,
                                     jp, jt, jnp.int32(80))
        tpk.write_chunk_paged(pc, pp, tc, tp, tt, 80)
    else:
        want = jpk.write_token_paged(jpool["kp"][0], jpool["kparam"][0],
                                     jc[..., 0], jp[..., 0], jt,
                                     jnp.asarray(pos))
        tpk.write_token_paged(pc, pp, tc[:, :, 0], tp[:, :, 0], tt, _t(pos))
    got = to_jax_cache({"kp": [pc], "kparam": [pp]})
    np.testing.assert_array_equal(got["kp"][0], np.asarray(want[0]))
    np.testing.assert_array_equal(got["kparam"][0], np.asarray(want[1]))
    assert got["kp"].any()
    # the gather reads back what was written, like JAX's
    jg = jpk.gather_kv_paged(*want, jt)
    tg = tpk.gather_kv_paged(pc, pp, tt)
    np.testing.assert_array_equal(np.swapaxes(tg[0].numpy(), -1, -2),
                                  np.asarray(jg[0]))


def test_allocator_matches_jax():
    """One alloc/free sequence (frees out of order, a refused alloc)."""
    ja, ta = jpaged.BlockAllocator(9), tpaged.BlockAllocator(9)
    held = []
    for op, n in (("alloc", 3), ("alloc", 2), ("free", 0), ("alloc", 4),
                  ("alloc", 5), ("free", 1), ("alloc", 1)):
        if op == "alloc":
            got, want = ta.alloc(n), ja.alloc(n)
            assert got == want
            held += [got] if got else []
        else:
            ja.free(held[n])
            ta.free(held[n])
        assert ta.free_count == ja.free_count
    for args in ((1, 1, 128), (128, 1, 128), (100, 28, 128), (300, 24, 256)):
        assert tpaged.blocks_needed(*args) == jpaged.blocks_needed(*args)


@pytest.mark.parametrize("mode", ["int4", "paged", "bf16"])
def test_cache_converters_round_trip(tiny, mode):
    jc = je.init_cache(tiny["jcfg"], 2, 256, mode=mode, block_size=BS,
                       dtype=jnp.float32)
    rng = np.random.default_rng(1)
    jc = {k: (v if k == "tbl" else
              rng.integers(0, 255, v.shape).astype(v.dtype))
          for k, v in jax.tree.map(np.asarray, jc).items()}
    back = to_jax_cache(from_jax_cache(jc, device="cpu"))
    assert set(back) == set(jc)
    for k in jc:
        np.testing.assert_array_equal(back[k], jc[k], err_msg=k)


# ---------------------------------------------------------------------------
# the engine: the chunk phase and the paged cache
# ---------------------------------------------------------------------------


def _same_state(jcache, tcache):
    """The port's cache, converted, against JAX's: codes and the block
    table byte for byte, float entries (scale/zero params, bf16-cache
    values) to 1e-5 relative (float32 K/V from GEMMs summed in another
    order give scales one ulp apart; the codes do not move)."""
    got = to_jax_cache(tcache)
    want = jax.tree.map(np.asarray, jcache)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        if want[k].dtype.kind in "iu":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)


@pytest.mark.parametrize("mode", ["int4", "paged", "bf16"])
def test_forward_chunk_matches_jax(tiny, mode):
    """A 40-token prefill, then chunks of 24 and of 1 token at
    positions 40 and 64 (the paged chunk straddles no edge: 40 + 24 < 128;
    the second prompt's does)."""
    jcfg, jfq, sp = tiny["jcfg"], tiny["jfq"], tiny["sp"]
    cfg, fq, tsp = tiny["cfg"], tiny["fq"], tiny["tsp"]
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 140)).astype(np.int32)
    L = 256
    jc = je.init_cache(jcfg, 2, L, mode=mode, block_size=BS,
                       dtype=jnp.float32)
    tc = te.init_cache(cfg, 2, L, mode=mode, block_size=BS,
                       dtype=torch.float32, device="cpu")
    _same_state(jc, tc)
    for phase, lo, hi in (("prefill", 0, 40), ("chunk", 40, 64),
                          ("chunk", 64, 65), ("chunk", 65, 140)):
        jl, jc = je._forward(jcfg, jfq, sp, jnp.asarray(toks[:, lo:hi]), jc,
                             jnp.int32(lo), phase, False, L, jnp.float32)
        tl = te._forward(cfg, fq, tsp, torch.from_numpy(toks[:, lo:hi]).long(),
                         tc, lo, phase, False, L, torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0, err_msg=f"{phase} at {lo}")
        _same_state(jc, tc)


def test_generate_paged_matches_jax(tiny):
    """A 150-token prompt over blocks of 256 (a mid-block tail), then
    decode through the table; the slot cache gives the same tokens."""
    prompt = np.random.default_rng(6).integers(
        0, tiny["cfg"].vocab_size, (1, 150)).astype(np.int32)
    want = je.generate(tiny["jcfg"], tiny["jfq"], tiny["sp"], prompt,
                       max_new_tokens=6, max_len=384, use_kernel=False,
                       cache_mode="paged", compute_dtype=jnp.float32)
    kw = dict(max_new_tokens=6, max_len=384, use_kernel=False,
              compute_dtype=torch.float32, device="cpu")
    got = te.generate(tiny["cfg"], tiny["fq"], tiny["tsp"], prompt,
                      cache_mode="paged", **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        te.generate(tiny["cfg"], tiny["fq"], tiny["tsp"], prompt,
                    cache_mode="int4", **kw), got)


# ---------------------------------------------------------------------------
# the batcher, token for token against JAX's
# ---------------------------------------------------------------------------


def _requests(seed, lengths, cfg):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
            for n in lengths]


def _both(model, use_kernel=False, **kw):
    jb = JBatcher(model["jcfg"], model["jfq"], model["sp"],
                  use_kernel=use_kernel, compute_dtype=jnp.float32, **kw)
    tb = ContinuousBatcher(model["cfg"], model["fq"], model["tsp"],
                           use_kernel=use_kernel,
                           compute_dtype=torch.float32, device="cpu", **kw)
    return jb, tb


PREFILL = {"whole": {}, "bucket": dict(prefill_bucket=16),
           "chunk": dict(prefill_chunk=64)}


@pytest.mark.parametrize("prefill", list(PREFILL))
@pytest.mark.parametrize("mode", ["bf16", "int4", "paged"])
def test_batcher_matches_jax(tiny, mode, prefill):
    """Mixed lengths through 2 slots (max_len 256); paged over 1 trash + 3
    real blocks of 128 (the full capacity would be 4), so admissions defer.
    Tokens and the final cache state equal JAX's; every block returns."""
    kw = dict(batch_slots=2, max_len=256, cache_mode=mode, **PREFILL[prefill])
    if mode == "paged":
        kw.update(n_blocks=4, block_size=BS)
    jb, tb = _both(tiny, **kw)
    for p, n in zip(_requests(7, (5, 150, 4, 40), tiny["cfg"]), (6, 4, 5, 3)):
        assert jb.submit(p, n) == tb.submit(p, n)
    want = jb.run(max_steps=400)
    assert tb.run(max_steps=400) == want and len(want) == 4
    _same_state(jb.cache, tb.cache)
    if mode == "paged":
        assert tb.alloc.free_count == jb.alloc.free_count == 3


@pytest.mark.parametrize("case", ["eos", "slot reuse"])
def test_batcher_eos_and_slot_reuse_match_jax(tiny, case):
    cfg = tiny["cfg"]
    if case == "eos":
        p = _requests(1, (4,), cfg)[0]
        probe = je.generate(tiny["jcfg"], tiny["jfq"], tiny["sp"], p[None],
                            max_new_tokens=3, max_len=16, use_kernel=False)
        eos = int(probe[0, -1])
        stop = probe[0].tolist()[:probe[0].tolist().index(eos) + 1]
        jb, tb = _both(tiny, batch_slots=1, max_len=16)
        for b in (jb, tb):
            b.submit(p, 8, eos_id=eos)  # stops at the first eos
            b.submit(p, 3)
    else:
        jb, tb = _both(tiny, batch_slots=2, max_len=24, cache_mode="int4")
        for p in _requests(2, range(3, 8), cfg):
            jb.submit(p, 3)
            tb.submit(p, 3)
    want = jb.run(max_steps=300)
    assert tb.run(max_steps=300) == want
    if case == "eos":
        assert want[0] == stop and len(want[1]) == 3


@pytest.mark.parametrize("mode", ["int4", "paged"])
def test_chunked_prefill_interleaves_decode_like_jax(tiny, mode):
    """While a long prompt prefills chunk by chunk, the active slot emits
    one token per step; both batchers' state agrees after every step."""
    kw = dict(batch_slots=2, max_len=128, cache_mode=mode, prefill_chunk=4)
    if mode == "paged":
        kw.update(block_size=BS, n_blocks=3)  # both requests fit at once
    jb, tb = _both(tiny, **kw)
    short, long = _requests(9, (4, 16), tiny["cfg"])
    for b in (jb, tb):
        b.submit(short, 10)
    steps = 0
    for i in range(8):
        if i == 1:
            jb.submit(long, 4)
            tb.submit(long, 4)
        jb.step()
        tb.step()
        steps += 1
        assert (tb.pending is None) == (jb.pending is None)
        assert [r and r.out_tokens for r in tb.slot_req] == \
            [r and r.out_tokens for r in jb.slot_req]
        np.testing.assert_array_equal(tb.pos, jb.pos)
        if 1 <= i <= 3:  # chunks 1-3 of 4; the active slot decodes on
            assert tb.pending is not None, "long prefill should be in flight"
    assert jb.run(max_steps=100) == tb.run(max_steps=100)


@pytest.mark.parametrize("mode", ["int4", "paged"])
def test_batcher_kernel_routes_match_jax_mini128(mini, mode):
    """use_kernel=True on mini-128: chunks of 256 rows take the fused input
    and MLP routes and the chunk kernels' routes (JAX's Pallas kernels in
    interpret mode; the port's plain versions on the CPU). Paged: blocks of
    256, the default half-capacity pool (2 usable blocks against
    reservations of 3), so the second request waits."""
    kw = dict(batch_slots=2, max_len=512, cache_mode=mode, prefill_chunk=256)
    if mode == "paged":
        kw["block_size"] = 256
    jb, tb = _both(mini, use_kernel=True, **kw)
    for p, n in zip(_requests(4, (300, 40), mini["cfg"]), (3, 4)):
        jb.submit(p, n)
        tb.submit(p, n)
    want = jb.run(max_steps=100)
    assert tb.run(max_steps=100) == want and len(want) == 2
    _near_state(jb.cache, tb.cache)


def _near_state(jcache, tcache):
    """The serving state of the fused routes: they round to bf16 and to
    W4A4 codes between layers, so a one-ulp float32 difference flips a
    code at a rounding tie now and then (ROADMAP section 3), and the next
    layer's K/V of that token move by a quantization step (measured: 0.04%
    of the nibbles and 0.11% of the (scale, zero) entries, scales of 7
    tokens by up to 5%, the rest within 1e-3 relative). Codes must agree
    on all but 0.1% of their entries, params within 1e-3 relative on all
    but 0.5%."""
    got = to_jax_cache(tcache)
    want = jax.tree.map(np.asarray, jcache)
    assert set(got) == set(want)
    for k in ("kp", "vp"):
        a, b = got[k].astype(np.int32), want[k].astype(np.int32)
        moved = np.stack([(a & 15) != (b & 15), (a >> 4) != (b >> 4)])
        assert moved.mean() < 1e-3, (k, moved.mean())
    for k in ("kparam", "vparam"):
        rel = np.abs(got[k] - want[k]) / np.maximum(np.abs(want[k]), 1e-6)
        assert (rel > 1e-3).mean() < 5e-3, (k, (rel > 1e-3).mean())


def test_unported_batcher_options_raise(tiny):
    """mesh (tp) and pp_mesh serve since the parallel slice
    (tests/test_torch_serving_tp.py, test_torch_pipeline.py); what the
    batcher refuses, as JAX's asserts do: both at once, and engine hooks
    under either."""
    cfg, fq, tsp = tiny["cfg"], tiny["fq"], tiny["tsp"]
    for kw, msg in ((dict(mesh=object(), pp_mesh=object()), "separate"),
                    (dict(mesh=object(), forward_fn=len), "plain"),
                    (dict(pp_mesh=object(), forward_fn=len), "plain")):
        with pytest.raises(ValueError, match=msg):
            ContinuousBatcher(cfg, fq, tsp, device="cpu", **kw)
    # engine hooks (DeepSeek, tests/test_torch_deepseek.py) run the bf16
    # cache only, as JAX's
    with pytest.raises(ValueError, match="bf16"):
        ContinuousBatcher(cfg, fq, tsp, device="cpu", forward_fn=len,
                          cache_mode="int4")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ContinuousBatcher(cfg, fq, tsp)
        with pytest.raises(RuntimeError, match="cuda"):
            te.init_cache(cfg, 1, 256, mode="paged")
