"""Tensor-parallel real-quant serving in the port (flatquant_torch/parallel/
serving_tp.py, the engine's tp_axis, the batcher's mesh) against JAX's
(tests/test_serving_tp.py, tests/test_parallel.py:243).

JAX builds the models (tiny-llama, tiny-qwen; shard-aligned transforms
from init_model_fq(tp=2), packed at tp = 1 and tp = 2) and runs its
single-device engine and batcher in process on the CPU; the port runs the
tp = 2 layout in four gloo ranks (dp 2 x tp 2) on the CPU, one spawn for
every case (tests/_torch_par_cases.py tp_cases), each rank with its own
slice of the weights and cache. Tolerances are JAX's own: tp logits
within rtol = atol = 1e-5 of single-device (float32), greedy batcher
tokens equal. The rest runs in process: init_model_fq(tp=2) bit-equal to
JAX's, the tp = 2 packing byte-equal to JAX's from JAX's baked state, the
per-rank slices equal to JAX's PartitionSpec slices, the perm layout on
shard-aligned transforms, the launch glue's failure handling, and the
import rule for the new modules.
"""

import ast
import functools
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import _torch_par_cases as cases
from flatquant_tpu.models.config import get_config as j_get_config
from flatquant_tpu.models.llama import init_params as j_init_params
from flatquant_tpu.parallel import serving_tp as jstp
from flatquant_tpu.quantize.bake import bake_model as j_bake_model
from flatquant_tpu.quantize.spec import W4A4 as J_W4A4
from flatquant_tpu.quantize.spec import W4A4KV4 as J_W4A4KV4
from flatquant_tpu.quantize.state import init_model_fq as j_init_model_fq
from flatquant_tpu.serving.batcher import ContinuousBatcher as JBatcher
from flatquant_tpu.serving.engine import (
    init_cache as j_init_cache,
    serving_decode_step as j_decode,
    serving_prefill as j_prefill,
)
from flatquant_tpu.serving.quantized import (
    build_serving_params as j_build_serving_params,
)
from flatquant_torch.models.config import get_config
from flatquant_torch.parallel import serving_tp as tstp
from flatquant_torch.parallel.launch import RankFailure, run_ranks
from flatquant_torch.parallel.mesh import plan_mesh, shard_tree
from flatquant_torch.quantize.spec import W4A4, W4A4KV4
from flatquant_torch.quantize.state import init_model_fq
from flatquant_torch.serving import engine as te
from flatquant_torch.serving.quantized import build_serving_params
from flatquant_torch.utils.convert import (
    from_jax_fq,
    from_jax_params,
    from_jax_serving_params,
)

REPO = Path(__file__).resolve().parents[1]
RANK_TIMEOUT_S = 240.0


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _baked(cfg_name, fq_cfg, tp, seed=0):
    cfg = j_get_config(cfg_name)
    params = j_init_params(cfg, seed=seed)
    fq = j_init_model_fq(cfg, fq_cfg, seed=seed, tp=tp)
    bp, bfq = jax.jit(functools.partial(j_bake_model, cfg, fq_cfg))(
        params, fq)
    return cfg, params, fq, bp, bfq


def _packed(cfg, fq_cfg, bp, bfq, tp, merge=True, perm=False):
    return jax.jit(functools.partial(
        j_build_serving_params, cfg, fq_cfg, dtype=jnp.float32,
        merge_projections=merge, perm_transforms=perm, tp=tp))(bp, bfq)


def _single_device_run(cfg, fq_cfg, sp1, toks, cache_mode, max_len,
                       n_decode):
    cache = j_init_cache(cfg, toks.shape[0], max_len, dtype=jnp.float32,
                         mode=cache_mode)
    logits, cache = j_prefill(cfg, fq_cfg, sp1, jnp.asarray(toks), cache,
                              use_kernel=False, max_len=max_len,
                              compute_dtype=jnp.float32)
    outs = [np.asarray(logits)]
    pos = toks.shape[1]
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    for _ in range(n_decode):
        logits, cache = j_decode(cfg, fq_cfg, sp1, tok, cache,
                                 jnp.int32(pos), use_kernel=False,
                                 max_len=max_len, compute_dtype=jnp.float32)
        outs.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        pos += 1
    return outs


@pytest.fixture(scope="module")
def jax_side():
    """JAX's models (both layouts), its single-device references and the
    inputs."""
    out = {}
    for key, name, fq_cfg, merge in (
            ("llama_w4a4", "tiny-llama", J_W4A4, True),
            ("llama_w4a4kv4", "tiny-llama", J_W4A4KV4, True),
            ("qwen_w4a4", "tiny-qwen", J_W4A4, False)):
        cfg, params, fq, bp, bfq = _baked(name, fq_cfg, tp=2)
        out[key] = dict(cfg=cfg, params=params, fq=fq, bp=bp, bfq=bfq,
                        sp1=_packed(cfg, fq_cfg, bp, bfq, 1, merge),
                        sptp=_packed(cfg, fq_cfg, bp, bfq, 2, merge))
    cfg = out["llama_w4a4"]["cfg"]
    out["toks"] = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 12)).astype(np.int32)
    out["qwen_toks"] = np.random.default_rng(2).integers(
        0, out["qwen_w4a4"]["cfg"].vocab_size, (2, 10)).astype(np.int32)
    rng = np.random.default_rng(3)
    out["prompts"] = [rng.integers(0, cfg.vocab_size, (s,)).astype(np.int32)
                      for s in (5, 9, 3, 7, 4)]
    out["ref_bf16"] = _single_device_run(
        cfg, J_W4A4, out["llama_w4a4"]["sp1"], out["toks"], "bf16", 16, 2)
    out["ref_int4"] = _single_device_run(
        cfg, J_W4A4KV4, out["llama_w4a4kv4"]["sp1"], out["toks"], "int4",
        16, 2)
    out["ref_qwen"] = _single_device_run(
        out["qwen_w4a4"]["cfg"], J_W4A4, out["qwen_w4a4"]["sp1"],
        out["qwen_toks"], "bf16", 16, 1)
    b = JBatcher(cfg, J_W4A4KV4, out["llama_w4a4kv4"]["sp1"], batch_slots=2,
                 max_len=32, use_kernel=False, compute_dtype=jnp.float32,
                 cache_mode="int4")
    for p in out["prompts"]:
        b.submit(p, max_new_tokens=6)
    out["ref_batcher"] = b.run()
    return out


@pytest.fixture(scope="module")
def tp_ranks(jax_side, tmp_path_factory):
    """The port's tp cases in 4 gloo ranks (dp 2 x tp 2), one spawn."""
    payload = {key: {"sptp": _np(jax_side[key]["sptp"])}
               for key in ("llama_w4a4", "llama_w4a4kv4", "qwen_w4a4")}
    for key in ("toks", "qwen_toks", "prompts"):
        payload[key] = jax_side[key]
    return run_ranks(cases.tp_cases, 4, args=(payload,), device="cpu",
                     threads=1, timeout_s=RANK_TIMEOUT_S,
                     rendezvous_dir=str(tmp_path_factory.mktemp("rdzv")))


@pytest.mark.parametrize("cache_mode", ["bf16", "int4"])
def test_tp_serving_parity(jax_side, tp_ranks, cache_mode):
    """dp 2 x tp 2 packed serving (prefill + 2 decode steps) on every rank
    matches JAX's single-device logits to float reassociation: the int32
    GEMM partials sum over tp and the row-parallel quant scales see the
    global extrema (tests/test_serving_tp.py:91)."""
    for rank, res in enumerate(tp_ranks):
        for i, (a, b) in enumerate(zip(jax_side["ref_" + cache_mode],
                                       res["parity_" + cache_mode])):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {rank} step {i}")


def test_tp_serving_unmerged_qwen_bias(jax_side, tp_ranks):
    """Unmerged projections with the qkv bias (tiny-qwen) under tp = 2."""
    for res in tp_ranks:
        for a, b in zip(jax_side["ref_qwen"], res["qwen_bias"]):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cache_mode", ["int4", "paged"])
def test_batcher_under_mesh_bit_identical(jax_side, tp_ranks, cache_mode):
    """ContinuousBatcher(mesh=...) greedy outputs equal JAX's unsharded
    batcher's (int4 slot cache; the paged pool equals it token for
    token), mixed prompt lengths and slot reuse, on every rank; each rank
    holds half the kv heads."""
    for res in tp_ranks:
        assert res["batcher_" + cache_mode] == jax_side["ref_batcher"]
        nkv = jax_side["llama_w4a4"]["cfg"].num_kv_heads
        assert res["kv_heads"] == nkv // 2


def test_tp_local_config_and_specs():
    cfg = get_config("tiny-llama")
    lcfg = tstp.tp_local_config(cfg, 2)
    assert lcfg.num_heads == 2 and lcfg.num_kv_heads == 1
    assert lcfg.intermediate_size == 88
    with pytest.raises(ValueError, match="num_kv_heads"):
        tstp.tp_local_config(cfg, 4)  # nkv=2 not divisible
    j = jstp.tp_local_config(j_get_config("tiny-llama"), 2)
    assert (j.num_heads, j.num_kv_heads, j.intermediate_size) == (
        lcfg.num_heads, lcfg.num_kv_heads, lcfg.intermediate_size)


def test_init_model_fq_tp2_bit_equal_to_jax():
    """init_model_fq(tp=2): the o transform at num_heads // 2 and the down
    transform at intermediate // 2, every factor bit-equal to JAX's."""
    cfg = get_config("tiny-llama")
    got = init_model_fq(cfg, W4A4KV4, seed=4, tp=2, device="cpu")
    want = from_jax_fq(_np(j_init_model_fq(j_get_config("tiny-llama"),
                                           J_W4A4KV4, seed=4, tp=2)), "cpu")
    assert got[0].attn.o_trans.size == cfg.num_heads // 2
    assert got[0].mlp.down_trans.left.size * got[0].mlp.down_trans.right.size \
        == cfg.intermediate_size // 2
    for g, w in zip(got, want):
        ga, wa = jax.tree.leaves(_tree(g)), jax.tree.leaves(_tree(w))
        assert len(ga) == len(wa) > 10
        for a, b in zip(ga, wa):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def _tree(layer):
    """A LayerFQ's tensors as a nested dict of numpy arrays."""
    import dataclasses

    def walk(x):
        if dataclasses.is_dataclass(x):
            return {f.name: walk(getattr(x, f.name))
                    for f in dataclasses.fields(x)}
        if isinstance(x, (list, tuple)):
            return [walk(v) for v in x]
        return x.numpy() if torch.is_tensor(x) else x

    return walk(layer)


@pytest.mark.parametrize("key", ["llama_w4a4kv4", "qwen_w4a4"])
def test_tp_packing_byte_equal_to_jax(jax_side, key):
    """build_serving_params(tp=2) from JAX's baked state (converted) packs
    the interleaved merged rows and the per-block row-parallel nibbles
    byte for byte as JAX's, and each rank's slice (serving_param_specs)
    equals JAX's PartitionSpec slice of the same array."""
    side = jax_side[key]
    cfg = get_config(side["cfg"].name)
    fq_cfg = W4A4 if key == "qwen_w4a4" else W4A4KV4
    got = build_serving_params(cfg, fq_cfg, from_jax_params(_np(side["bp"]),
                                                            "cpu"),
                               from_jax_fq(_np(side["bfq"]), "cpu"),
                               dtype=torch.float32,
                               merge_projections=key != "qwen_w4a4", tp=2)
    # JAX's build_serving_params op by op: jitted, XLA divides the scales
    # by 7 as a reciprocal multiply (one ulp)
    jsp = j_build_serving_params(side["cfg"], J_W4A4 if key == "qwen_w4a4"
                                 else J_W4A4KV4, side["bp"], side["bfq"],
                                 dtype=jnp.float32,
                                 merge_projections=key != "qwen_w4a4", tp=2)
    want = from_jax_serving_params(_np(jsp), "cpu")
    names = ("qkv", "upgate", "o", "down") if "qkv" in want["layers"][0] \
        else ("q", "k", "v", "up", "gate", "o", "down")
    for g, w in zip(got["layers"], want["layers"]):
        for n in names:
            assert torch.equal(g[n]["wp"], w[n]["wp"]), n
            assert torch.equal(g[n]["scale"], w[n]["scale"]), n
    jspecs = jstp.serving_param_specs(jsp)
    specs = tstp.serving_param_specs(got)
    for r in range(2):
        local = shard_tree(got, specs, plan_mesh({"tp": 2}, r, "cpu"))
        for i, lt in enumerate(local["layers"]):
            for n in names:
                for sub in ("wp", "scale"):
                    arr = np.asarray(jsp["layers"][n][sub][i])
                    spec = jspecs["layers"][n][sub][1:]
                    idx = tuple(slice(r * (d // 2), (r + 1) * (d // 2))
                                if ax == "tp" else slice(None)
                                for ax, d in zip(spec, arr.shape))
                    np.testing.assert_array_equal(lt[n][sub].numpy(),
                                                  arr[idx])
        np.testing.assert_array_equal(
            local["lm_head"].numpy(),
            np.asarray(jsp["lm_head"])[r * cfg.vocab_size // 2:
                                                (r + 1) * cfg.vocab_size // 2])


def test_tp_build_refusals(jax_side):
    """As JAX's build_serving_params: the perm layout with tp > 1 is not
    combined, and tp must divide the kv heads."""
    side = jax_side["llama_w4a4"]
    cfg = get_config("tiny-llama")
    bp = from_jax_params(_np(side["bp"]), "cpu")
    bfq = from_jax_fq(_np(side["bfq"]), "cpu")
    with pytest.raises(NotImplementedError, match="perm layout"):
        build_serving_params(cfg, W4A4, bp, bfq, perm_transforms=True, tp=2)
    with pytest.raises(ValueError, match="head-granular"):
        build_serving_params(cfg, W4A4, bp, bfq, tp=4)


def test_shard_aligned_perm_serving_tp2():
    """The perm layout on shard-aligned (block-diagonal) transforms: the
    input-channel permutation applies per transform block, so the perm
    and standard layouts serve the same logits (JAX's tolerance,
    tests/test_parallel.py:243), and each equals JAX's."""
    cfg_j = j_get_config("tiny-llama")
    cfg = get_config("tiny-llama")
    _, _, _, bp_j, bfq_j = _baked("tiny-llama", J_W4A4, tp=2, seed=5)
    bp = from_jax_params(_np(bp_j), "cpu")
    bfq = from_jax_fq(_np(bfq_j), "cpu")
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 12)).astype(np.int32)

    def run(perm):
        sp = build_serving_params(cfg, W4A4, bp, bfq, dtype=torch.float32,
                                  perm_transforms=perm)
        cache = te.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
        lr, _ = te.serving_prefill(cfg, W4A4, sp, toks, cache,
                                   use_kernel=False, max_len=16,
                                   compute_dtype=torch.float32, device="cpu")
        return lr.numpy()

    a, b = run(False), run(True)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-4)
    jsp = _packed(cfg_j, J_W4A4, bp_j, bfq_j, 1, merge=False, perm=True)
    want, _ = j_prefill(cfg_j, J_W4A4, jsp, jnp.asarray(toks),
                        j_init_cache(cfg_j, 2, 16, dtype=jnp.float32),
                        use_kernel=False, max_len=16,
                        compute_dtype=jnp.float32)
    np.testing.assert_allclose(b, np.asarray(want), rtol=1e-4, atol=2e-4)


def test_run_ranks_raises_on_a_failing_rank(tmp_path):
    """A rank that raises fails the whole run with its traceback; the
    others are killed, not waited for."""
    with pytest.raises(RankFailure, match="rank one fails on purpose"):
        run_ranks(cases.raise_on_rank_one, 2, device="cpu", threads=1,
                  timeout_s=60, rendezvous_dir=str(tmp_path))


def test_run_ranks_kills_ranks_past_the_limit(tmp_path):
    """A rank past the time limit fails the run within the limit (it is
    killed, and the run does not hang)."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RankFailure, match="did not finish"):
        run_ranks(cases.sleep_past_the_limit, 2, args=(120,), device="cpu",
                  threads=1, timeout_s=8, rendezvous_dir=str(tmp_path))
    assert time.monotonic() - t0 < 60


def test_parallel_modules_keep_the_import_rule():
    """Every module of flatquant_torch/parallel/ is in the AST scan of
    tests/test_torch_serving.py (no jax, no flatquant_tpu, no package the
    card's machine lacks), and none imports them."""
    import test_torch_serving

    scanned = {p.resolve() for p in test_torch_serving._port_files()}
    mods = sorted((REPO / "flatquant_torch" / "parallel").glob("*.py"))
    names = {p.name for p in mods}
    assert {"distributed.py", "mesh.py", "serving_tp.py", "pipeline.py",
            "sequence.py", "launch.py"} <= names
    banned = ("jax", "jaxlib", "flatquant_tpu", "msgpack", "flax", "optax",
              "safetensors")
    for path in mods + [REPO / "tests" / "_torch_par_cases.py"]:
        if path.parent.name == "parallel":
            assert path.resolve() in scanned, path
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                heads = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                heads = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(heads) & set(banned), (path, heads)


def test_calibration_meshes_raise_naming_slice_20():
    """Item 9's calibration half, now ported: the calibration
    meshes' spec rules no longer raise; they name an axis and a dim per
    leaf (tests/test_torch_parallel_calib.py holds them to JAX's)."""
    from flatquant_torch.models import deepseek as ds
    from flatquant_torch.models.llama import init_params
    from flatquant_torch.parallel import mesh

    cfg = get_config("tiny-llama")
    specs = mesh.llama_param_specs(cfg, init_params(cfg, device="cpu"))
    assert specs["layers"][0]["wq"] == ("tp", 0)
    assert specs["layers"][0]["wdown"] == ("tp", 1)
    dcfg = ds.DeepSeekConfig(dim=64, inter_dim=128, moe_inter_dim=48,
                             n_layers=2, n_dense_layers=1, n_heads=4,
                             n_routed_experts=4, n_activated_experts=2,
                             kv_lora_rank=32, vocab_size=64)
    dspecs = mesh.deepseek_param_specs(
        dcfg, ds.init_ds_params(dcfg, device="cpu"))
    assert dspecs["moe_layers"][0]["e_w1"] == ("ep", 0)
    assert dspecs["head"] == ("tp", 0)


def test_init_distributed_and_backend_rule(monkeypatch):
    """One process: no group, rank 0 (JAX's no-op), from the arguments or
    FLATQUANT_NUM_PROCESSES. The backend rule: gloo on the CPU and where
    ranks outnumber the cards."""
    from flatquant_torch.parallel import distributed as pd

    monkeypatch.setenv("FLATQUANT_NUM_PROCESSES", "1")
    assert pd.init_distributed() == 0
    assert pd.init_distributed(num_processes=1) == 0
    assert not torch.distributed.is_initialized()
    assert pd.backend_for("cpu", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pd.backend_for("cuda", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert pd.backend_for("cuda", 2) == "nccl"


def test_plan_mesh_lays_ranks_out_as_make_mesh():
    """plan_mesh (a rank's axes before the ranks start) lays ranks out row
    major, as JAX's make_mesh reshapes its devices."""
    from flatquant_torch.parallel.mesh import plan_mesh

    grid = np.arange(8).reshape(2, 2, 2)
    for r in range(8):
        m = plan_mesh({"dp": 2, "pp": 2, "tp": 2}, r, "cpu")
        d, p, t = np.unravel_index(r, (2, 2, 2))
        assert (m.axis("dp").index, m.axis("pp").index,
                m.axis("tp").index) == (d, p, t)
        assert m.axis("tp").ranks == tuple(grid[d, p, :])
        assert m.axis("dp").ranks == tuple(grid[:, p, t])
        assert m.axis("tp").block(16) == slice(8 * t, 8 * t + 8)


def test_fused_mlp_declines_a_block_diagonal_down_transform():
    """A shard-aligned down transform served on one device covers one
    shard's block of the intermediate: the fused MLP routes, whose left
    factor must span it, decline (JAX's left_quant_i8_flat asserts
    there), and the composed kron_transform applies it block-diagonally
    (test_shard_aligned_perm_serving_tp2, chip_smoke.py phase 16's
    single-device reference)."""
    from flatquant_torch.serving import quantized as tq

    inter = 512
    eye = torch.eye(128)
    sl = {"upgate": {"wp": torch.zeros((2 * inter, 128), dtype=torch.uint8),
                     "scale": torch.ones(2 * inter)},
          "down": {"wp": torch.zeros((256, inter // 2), dtype=torch.uint8),
                   "scale": torch.ones(256)},
          "ug_t": (torch.eye(2), eye), "down_t": (torch.eye(2), eye),
          "ln2_w": torch.ones(256)}
    x = torch.zeros((256, 256))
    assert not tq._down_t_spans(sl)
    assert tq._quant_mlp_grouped_full(x, sl, 1e-5) is None
    assert tq._quant_mlp_grouped(x, sl) is None
    sl["down_t"] = (torch.eye(4), eye)
    assert tq._down_t_spans(sl) and tq._mlp_full_qualifies(x, sl, 7)


def test_profile_traces_a_block_per_rank(tmp_path):
    """distributed.profile: a torch.profiler Chrome trace of the block,
    one file per rank (rank 0 without a group); a no-op without a
    directory."""
    from flatquant_torch.parallel import distributed as pd

    with pd.profile(None) as prof:
        assert prof is None
    with pd.profile(str(tmp_path / "trace")):
        torch.ones(8).sum()
    assert (tmp_path / "trace" / "rank0.json").stat().st_size > 0
