"""The HF DeepSeek loader (models/ds_loader.py) and the host conversions
under it (native/__init__.py, native/safetensors_io.py) against the JAX
package, on the CPU, on TINY_DEEPSEEK fixtures in the official HF layout.

Tolerances, and why:
  - the decodes (all 256 e4m3 codes, all 65,536 bf16 and f16 patterns),
    the block dequant with ragged edge tiles, the planar int4 pack: bit
    for bit against JAX's native module (NaN as NaN), whichever of its
    C++ and numpy paths it takes.
  - SafetensorsFile: every tensor of JAX's fixture decoded as JAX's
    reader decodes it, bit for bit.
  - write_hf_deepseek_fixture on the CPU: the file equals JAX's writer's
    tensor for tensor (the same torch.Generator draws in the same
    order), and config.json equal.
  - load_hf_deepseek, dequantized and keep_fp8: bit for bit against
    JAX's load of the same file (the same float32 products; float8 codes
    are the file's bytes).
  - keep_fp8 at a K that 128 does not tile and one block does not hold:
    refused by both packages, as JAX's expand_fp8_scales refuses it.
  - the keep_fp8 and dequantized loads' forwards (float32): within 0.1,
    JAX's own bound (bf16 products against float32 ones).
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flatquant_tpu import native as jnative
from flatquant_tpu.models import deepseek as jds
from flatquant_tpu.models import ds_loader as jdl
from flatquant_tpu.native import safetensors_io as jst
from flatquant_torch import native as tnative
from flatquant_torch.models import deepseek as tds
from flatquant_torch.models import ds_loader as tdl
from flatquant_torch.native import safetensors_io as tst
from flatquant_torch.utils.convert import from_jax_ds_serving_params
from flatquant_torch.utils.safetensors_io import read_safetensors

torch.set_num_threads(2)

SHARD = "model-00001-of-00001.safetensors"
CFG_KW = dict(name="tiny-deepseek", seqlen=32, max_seq_len=256,
              original_seq_len=64)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _same_bits(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan], want[~nan])


# ---------------------------------------------------------------------------
# native/
# ---------------------------------------------------------------------------


def test_decodes_match_jax_bit_for_bit():
    raw = np.arange(256, dtype=np.uint8)
    got = tnative.fp8_e4m3_to_f32(raw)
    assert got.dtype == torch.float32
    _same_bits(got.numpy(), jnative.fp8_e4m3_to_f32(raw))
    assert int(torch.isnan(got).sum()) == 2
    u16 = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    _same_bits(tnative.bf16_to_f32(u16).numpy(), jnative.bf16_to_f32(u16))
    _same_bits(tnative.f16_to_f32(u16).numpy(), jnative.f16_to_f32(u16))


def test_block_dequant_and_planar_pack_match_jax():
    rng = np.random.default_rng(1)
    w8 = rng.integers(0, 256, (300, 260), dtype=np.uint8)
    w8[(w8 & 0x7F) == 0x7F] = 0
    sc = rng.standard_normal((3, 3)).astype(np.float32)
    got = tnative.fp8_block_dequant(torch.as_tensor(w8), torch.as_tensor(sc))
    np.testing.assert_array_equal(got.numpy(),
                                  jnative.fp8_block_dequant_np(w8, sc))
    q = rng.integers(-8, 8, (96, 256), dtype=np.int8)
    pk = tnative.pack_int4_planar(q)
    np.testing.assert_array_equal(pk.numpy(), jnative.pack_int4_planar(q))
    np.testing.assert_array_equal(tnative.unpack_int4_planar(pk).numpy(), q)


# ---------------------------------------------------------------------------
# fixtures and the loader
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """TINY_DEEPSEEK in fp8 by both writers, and the port's bf16-free
    float32 variant with a multi-token-prediction layer beside it."""
    out = {}
    for key, write, fp8 in (("t", tdl.write_hf_deepseek_fixture, True),
                            ("j", jdl.write_hf_deepseek_fixture, True),
                            ("t32", tdl.write_hf_deepseek_fixture, False)):
        d = str(tmp_path_factory.mktemp(key))
        kw = {"device": "cpu"} if key.startswith("t") else {}
        write(d, tds.TINY_DEEPSEEK, seed=0, fp8=fp8, **kw)
        out[key] = d
    mtp = tds.TINY_DEEPSEEK.n_layers
    tst.write_safetensors(os.path.join(out["t32"], "model-mtp.safetensors"), {
        f"model.layers.{mtp}.self_attn.q_proj.weight": np.zeros(
            (4, 4), np.float32),
        f"model.layers.{mtp}.input_layernorm.weight": np.ones(
            (4,), np.float32)})
    return out


def test_fixture_equals_jax_writer(fixtures):
    got, _ = read_safetensors(os.path.join(fixtures["t"], SHARD))
    want, _ = read_safetensors(os.path.join(fixtures["j"], SHARD))
    assert set(got) == set(want)  # safetensors.torch sorts its keys
    assert any(k.endswith("e_score_correction_bias") for k in got)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert _bytes(got[k]) == _bytes(w), k
    configs = []
    for d in ("t", "j"):
        with open(os.path.join(fixtures[d], "config.json")) as f:
            configs.append(json.load(f))
    assert configs[0] == configs[1]
    tc = tdl.ds_config_from_hf_json(fixtures["t"], **CFG_KW)
    jc = jdl.ds_config_from_hf_json(fixtures["t"], **CFG_KW)
    for f in ("vocab_size", "dim", "inter_dim", "moe_inter_dim", "n_layers",
              "n_dense_layers", "n_heads", "n_routed_experts",
              "n_shared_experts", "n_activated_experts", "n_expert_groups",
              "n_limited_groups", "score_func", "route_scale", "gate_bias",
              "q_lora_rank", "kv_lora_rank", "qk_nope_head_dim",
              "qk_rope_head_dim", "v_head_dim", "rope_factor", "beta_fast",
              "mscale", "rms_eps"):
        assert getattr(tc, f) == getattr(jc, f) == getattr(
            tds.TINY_DEEPSEEK, f), f


def test_safetensors_file_decodes_as_jax(fixtures):
    path = os.path.join(fixtures["j"], SHARD)
    with tst.SafetensorsFile(path, "cpu") as sf, jst.SafetensorsFile(
            path) as jf:
        assert list(sf.keys()) == list(jf.keys())
        for name in jf.keys():
            assert sf.dtype_of(name) == jf.dtype_of(name)
            _same_bits(sf.tensor_f32(name).numpy(), jf.tensor_f32(name))
            raw, tag = sf.raw(name)
            assert tag == jf.raw(name)[1]
            # JAX's raw is a view into its map: copied out, never held
            assert _bytes(raw) == jf.raw(name)[0].tobytes()
        keys = list(jf.keys())
    assert [n for n, _ in tst.iter_safetensors(path, "cpu")] == keys


def _bytes(t):
    return t.contiguous().view(torch.uint8).numpy().tobytes()


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _same_tree(got, want):
    """Every leaf of two param trees: the same keys, dtype, shape, bits."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys(), set(g) ^ set(w)
    for k, wv in w.items():
        assert g[k].dtype == wv.dtype and g[k].shape == wv.shape, k
        assert _bytes(g[k]) == _bytes(wv), k


@pytest.mark.parametrize("keep_fp8", [False, True])
def test_load_matches_jax_bit_for_bit(fixtures, keep_fp8):
    cfg = tdl.ds_config_from_hf_json(fixtures["t"], **CFG_KW)
    jcfg = jdl.ds_config_from_hf_json(fixtures["t"], **CFG_KW)
    got = tdl.load_hf_deepseek(fixtures["t"], cfg, keep_fp8=keep_fp8,
                               device="cpu")
    _same_tree(got, from_jax_ds_serving_params(_np(jdl.load_hf_deepseek(
        fixtures["t"], jcfg, keep_fp8=keep_fp8)), "cpu"))
    if keep_fp8:
        lp = got["dense_layers"][0]
        assert isinstance(lp["wq_a"], dict) and not isinstance(lp["wkv_b"],
                                                               dict)
        assert got["moe_layers"][0]["e_w1"]["w8"].dim() == 3
        with tst.SafetensorsFile(os.path.join(fixtures["t"], SHARD),
                                 "cpu") as sf:
            raw, _ = sf.raw("model.layers.0.self_attn.q_a_proj.weight")
        assert torch.equal(lp["wq_a"]["w8"].view(torch.uint8), raw)


def test_keep_fp8_refuses_a_ragged_k_as_jax():
    """A K that 128 does not tile and that is wider than one block
    (V2-Lite's dense down projection, K = 10944) is refused by both
    packages; one within a block keeps its one scale row in both."""
    from flatquant_tpu.kernels.fp8_matmul import expand_fp8_scales

    rng = np.random.default_rng(2)
    n = 200
    for k, ragged in ((320, True), (96, False)):  # 2 x 128 + 64; < 128
        raw = rng.integers(0, 0x7E, (n, k), dtype=np.uint8)
        sc = (rng.random((2, -(-k // 128))) + 0.5).astype(np.float32)
        if ragged:
            with pytest.raises(ValueError, match=f"K={k}"):
                tdl._fp8_linear_dict(torch.as_tensor(raw),
                                     torch.as_tensor(sc))
            with pytest.raises(AssertionError):
                expand_fp8_scales(jnp.asarray(sc), n, k)
        else:
            lin = tdl._fp8_linear_dict(torch.as_tensor(raw),
                                       torch.as_tensor(sc))
            assert torch.equal(lin["w8"].view(torch.uint8),
                               torch.as_tensor(raw))
            np.testing.assert_array_equal(
                lin["se"].numpy(), np.asarray(expand_fp8_scales(
                    jnp.asarray(sc), n, k)))


def test_float32_checkpoint_and_mtp_layer(fixtures):
    """A float32 checkpoint (no scale tensors) loads as JAX's does, and
    the multi-token-prediction layer past n_layers is skipped."""
    cfg = tdl.ds_config_from_hf_json(fixtures["t32"], **CFG_KW)
    got = tdl.load_hf_deepseek(fixtures["t32"], cfg, device="cpu")
    assert len(got["dense_layers"]) == cfg.n_dense_layers
    _same_tree(got, from_jax_ds_serving_params(_np(jdl.load_hf_deepseek(
        fixtures["t32"], jdl.ds_config_from_hf_json(fixtures["t32"],
                                                    **CFG_KW))), "cpu"))


def test_keep_fp8_forward_close_to_dequantized(fixtures):
    cfg = tdl.ds_config_from_hf_json(fixtures["t"], **CFG_KW)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 16))
    outs = [tds.deepseek_forward(
        cfg, tdl.load_hf_deepseek(fixtures["t"], cfg, keep_fp8=k,
                                  device="cpu"), toks,
        compute_dtype=torch.float32, device="cpu") for k in (False, True)]
    assert torch.isfinite(outs[1]).all()
    np.testing.assert_allclose(outs[1].float().numpy(),
                               outs[0].float().numpy(), rtol=0.1, atol=0.1)
