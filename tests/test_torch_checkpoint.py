"""The port's checkpoints and exports (flatquant_torch/utils/checkpoint.py,
its msgpack and safetensors codecs, models/loader.py,
utils/reference_convert.py) against the JAX package's, on the CPU.

Each artifact written by one package loads in the other. Tolerances: none
— bytes and values are compared for equality (the port's msgpack is
flax's byte for byte; stacked per-layer leaves, bf16 bits and the
uint16 + manifest safetensors form cross unchanged).
"""

import dataclasses
import json

import numpy as np
import pytest

import jax
import torch

from flatquant_tpu.models import deepseek as jds
from flatquant_tpu.models import loader as jloader
from flatquant_tpu.models.config import get_config as j_get_config
from flatquant_tpu.models.llama import init_params as j_init_params
from flatquant_tpu.quantize.bake import bake_model as j_bake_model
from flatquant_tpu.quantize.spec import W4A4 as J_W4A4
from flatquant_tpu.quantize.spec import W4A4KV4 as J_W4A4KV4
from flatquant_tpu.quantize.state import bake_layer_fq as j_bake_layer_fq
from flatquant_tpu.quantize.state import init_model_fq as j_init_model_fq
from flatquant_tpu.serving.quantized import (
    build_serving_params as j_build_serving_params,
)
from flatquant_tpu.utils import checkpoint as jck
from flatquant_tpu.utils import reference_convert as jrc
from flatquant_torch.models import deepseek as tds
from flatquant_torch.models import loader as tloader
from flatquant_torch.models.config import get_config
from flatquant_torch.quantize.spec import W4A4, W4A4KV4
from flatquant_torch.quantize.state import bake_layer_fq, init_model_fq
from flatquant_torch.utils import checkpoint as tck
from flatquant_torch.utils import msgpack_io
from flatquant_torch.utils import reference_convert as trc
from flatquant_torch.utils.convert import (
    from_jax_fq,
    from_jax_params,
    from_jax_serving_params,
)
from flatquant_torch.utils.tree import tree_leaves

torch.set_num_threads(2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flax_bytes(tree):
    return jck.serialization.to_bytes(_np(tree))


def _same_leaves(got, want):
    a, b = tree_leaves(got), tree_leaves(want)
    assert len(a) == len(b) and a
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_msgpack_codec_matches_msgpack_python():
    msgpack = pytest.importorskip("msgpack")
    objs = [None, True, False, 0, 127, 128, 65536, 2**32, -1, -33, -129,
            -2**31 - 1, 1.5, "", "a" * 31, "b" * 32, "c" * 70000, b"x" * 300,
            list(range(20)), {"a": 1, "b": [1, None]},
            {str(i): i for i in range(20)}]
    for o in objs:
        raw = msgpack.packb(o, use_bin_type=True)
        assert msgpack_io.packb(o) == raw
        assert msgpack_io.unpackb(raw) == msgpack.unpackb(raw, raw=False)
    for n in (1, 2, 4, 8, 16, 17, 300, 70000):
        e = msgpack.ExtType(1, b"z" * n)
        raw = msgpack.packb(e, use_bin_type=True)
        assert msgpack_io.packb(msgpack_io.ExtType(1, e.data)) == raw
        assert msgpack_io.unpackb(raw) == msgpack_io.ExtType(1, e.data)


@pytest.mark.parametrize("baked", [False, True])
def test_llama_fq_state_msgpack_byte_equal(baked):
    """init_model_fq (flat_parameters) and its frozen form
    (flat_matrices): the same bytes as flax, and each loads the other's."""
    cfg = get_config("tiny-llama")
    jst = j_init_model_fq(j_get_config("tiny-llama"), J_W4A4KV4, seed=3)
    tst = init_model_fq(cfg, W4A4KV4, seed=3, device="cpu")
    jtmpl = j_init_model_fq(j_get_config("tiny-llama"), J_W4A4KV4, seed=9)
    ttmpl = init_model_fq(cfg, W4A4KV4, seed=9, device="cpu")
    if baked:
        jst, jtmpl = (jax.vmap(j_bake_layer_fq)(t) for t in (jst, jtmpl))
        tst = from_jax_fq(_np(jst), "cpu")
        ttmpl = [bake_layer_fq(t) for t in ttmpl]
    data = tck.to_bytes(tst)
    assert data == _flax_bytes(jst)
    _same_leaves(tck.from_bytes(ttmpl, data), tst)
    back = jck.serialization.from_bytes(_np(jtmpl), data)
    _same_leaves(from_jax_fq(_np(back), "cpu"), tst)


def test_deepseek_fq_state_msgpack_byte_equal(tmp_path):
    """The (dense, moe) tuple of init_ds_fq through save_flat_parameters:
    the port's file is flax's byte for byte and loads both ways."""
    kw = dict(lwc=True, lac=True, add_diag=True)
    jst = jds.init_ds_fq(jds.TINY_DEEPSEEK,
                         dataclasses.replace(J_W4A4, **kw), seed=2)
    tst = tds.init_ds_fq(tds.TINY_DEEPSEEK, dataclasses.replace(W4A4, **kw),
                         seed=2, device="cpu")
    path = tck.save_flat_parameters(str(tmp_path), tst)
    with open(path, "rb") as f:
        data = f.read()
    assert data == _flax_bytes(jst)
    tmpl = tds.init_ds_fq(tds.TINY_DEEPSEEK,
                          dataclasses.replace(W4A4, **kw), seed=8,
                          device="cpu")
    _same_leaves(tck.load_flat_parameters(str(tmp_path), tmpl), tst)
    jck.save_flat_parameters(str(tmp_path / "j"), jst)
    _same_leaves(tck.load_flat_parameters(str(tmp_path / "j"), tmpl), tst)


def test_flax_chunked_leaf_is_refused():
    big = {"__msgpack_chunked_array__": True, "shape": {"0": 1},
           "chunks": {}}
    with pytest.raises(ValueError, match="chunked"):
        tck._decode({"a": big})


@pytest.fixture(scope="module")
def packed():
    jcfg = j_get_config("tiny-llama")

    def build(seed):
        bp, bf = j_bake_model(jcfg, J_W4A4KV4, j_init_params(jcfg, seed=seed),
                              j_init_model_fq(jcfg, J_W4A4KV4, seed=seed))
        return j_build_serving_params(jcfg, J_W4A4KV4, bp, bf)

    jsp, jtmpl = build(0), build(5)
    return dict(jsp=jsp, jtmpl=jtmpl,
                tsp=from_jax_serving_params(_np(jsp), "cpu"),
                ttmpl=from_jax_serving_params(_np(jtmpl), "cpu"))


@pytest.mark.parametrize("sharded", [False, True])
def test_packed_safetensors_load_both_ways(tmp_path, packed, sharded):
    """bf16 embed / head through the uint16 manifest, planar codes,
    scales and the a_clip pairs; sharded at 64 KiB shards."""
    qc = {"w_bits": 4}
    if sharded:
        tpath = tck.save_packed_safetensors_sharded(
            str(tmp_path / "t"), packed["tsp"], qc, max_shard_bytes=1 << 16)
        jpath = jck.save_packed_safetensors_sharded(
            str(tmp_path / "j"), packed["jsp"], qc, max_shard_bytes=1 << 16)
        assert tpath.endswith(".index.json")
        with open(tpath) as f, open(jpath) as g:
            assert json.load(f)["weight_map"] == json.load(g)["weight_map"]
        tload, jload = (tck.load_packed_safetensors_sharded,
                        jck.load_packed_safetensors_sharded)
    else:
        tpath = tck.save_packed_safetensors(str(tmp_path / "t"),
                                            packed["tsp"], qc)
        jpath = jck.save_packed_safetensors(str(tmp_path / "j"),
                                            packed["jsp"], qc)
        tload, jload = tck.load_packed_safetensors, jck.load_packed_safetensors
    want = packed["tsp"]
    assert want["embed"].dtype == torch.bfloat16
    _same_leaves(tload(jpath, packed["ttmpl"]), want)
    _same_leaves(tload(tpath, packed["ttmpl"]), want)
    _same_leaves(from_jax_serving_params(
        _np(jload(tpath, packed["jtmpl"])), "cpu"), want)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_hf_loader_reads_both_fixtures(tmp_path, writer):
    """Both packages' write_hf_llama_fixture draw the same BF16 tensors;
    each loader reads each writer's directory to the same params."""
    jcfg = j_get_config("tiny-llama")
    cfg = get_config("tiny-llama")
    path = str(tmp_path / writer)
    (jloader if writer == "jax" else tloader).write_hf_llama_fixture(
        path, jcfg if writer == "jax" else cfg, seed=4)
    got = tloader.load_hf_llama(path, tloader.config_from_hf_json(path),
                                device="cpu")
    want = from_jax_params(_np(jloader.load_hf_llama(
        path, jloader.config_from_hf_json(path))), "cpu")
    assert got.keys() == want.keys()
    for k in ("embed", "final_norm_w", "lm_head"):
        if k in want:
            assert torch.equal(got[k], want[k]), k
    for g, w in zip(got["layers"], want["layers"]):
        assert g.keys() == w.keys()
        for k in w:
            assert torch.equal(g[k], w[k]), k
    assert dataclasses.asdict(tloader.config_from_hf_json(path)) == \
        dataclasses.asdict(jloader.config_from_hf_json(path))


def test_hf_fixtures_equal_across_packages(tmp_path):
    cfg = get_config("tiny-llama")
    jloader.write_hf_llama_fixture(str(tmp_path / "j"),
                                   j_get_config("tiny-llama"), seed=1)
    tloader.write_hf_llama_fixture(str(tmp_path / "t"), cfg, seed=1)
    a = tloader.load_hf_llama(str(tmp_path / "j"), cfg, device="cpu")
    b = tloader.load_hf_llama(str(tmp_path / "t"), cfg, device="cpu")
    _same_leaves(a, b)


def _reference_dict(lfq):
    """A baked LayerFQ in the reference's flat_matrices key schema."""
    d = {}

    def dec(prefix, t):
        if t is not None:
            for k, v in (("matrix_left", t.left), ("matrix_right", t.right),
                         ("matrix_left_inv", t.left_inv),
                         ("matrix_right_inv", t.right_inv),
                         ("diag_scale", t.diag_scale)):
                if v is not None:
                    d[f"{prefix}.{k}"] = v.clone()

    def single(prefix, t):
        if t is not None:
            d[f"{prefix}.matrix"] = t.matrix.clone()
            d[f"{prefix}.matrix_inv_t"] = t.matrix_inv_t.clone()

    def lin(prefix, st):
        for k, v in (("clip_factor_w_max", st.clip_w_max),
                     ("clip_factor_w_min", st.clip_w_min),
                     ("act_quantizer.clip_factor_a_max", st.clip_a_max),
                     ("act_quantizer.clip_factor_a_min", st.clip_a_min)):
            if v is not None:
                d[f"{prefix}.{k}"] = v.clone()

    a, m = lfq.attn, lfq.mlp
    dec("self_attn.ln_trans", a.ln_trans)
    single("self_attn.o_trans", a.o_trans)
    single("self_attn.kcache_trans", a.kcache_trans)
    single("self_attn.vcache_trans", a.vcache_trans)
    for nm, st in (("q", a.q_lin), ("k", a.k_lin), ("v", a.v_lin),
                   ("o", a.o_lin)):
        lin(f"self_attn.{nm}_proj", st)
    for nm, cq in (("q", a.q_cache), ("k", a.k_cache), ("v", a.v_cache)):
        for k, v in (("clip_factor_a_max", cq.clip_a_max),
                     ("clip_factor_a_min", cq.clip_a_min)):
            if v is not None:
                d[f"self_attn.{nm}_cache_quantizer.{k}"] = v.clone()
    dec("mlp.up_gate_trans", m.up_gate_trans)
    dec("mlp.down_trans", m.down_trans)
    for nm, st in (("up", m.up_lin), ("gate", m.gate_lin),
                   ("down", m.down_lin)):
        lin(f"mlp.{nm}_proj", st)
    return d


def test_flat_matrices_pth_equal_in_both_packages(tmp_path):
    cfg = get_config("tiny-llama")
    fq = dataclasses.replace(W4A4KV4, lwc=True, lac=True, add_diag=True)
    frozen = trc.matrices_state(init_model_fq(cfg, fq, seed=6, device="cpu"))
    path = str(tmp_path / "flat_matrices.pth")
    torch.save({i: _reference_dict(l) for i, l in enumerate(frozen)}, path)
    got = trc.fq_from_flat_matrices(trc.load_reference_flat_matrices(path),
                                    cfg, device="cpu")
    want = from_jax_fq(_np(jrc.fq_from_flat_matrices(
        jrc.load_reference_flat_matrices(path), j_get_config("tiny-llama"))),
        "cpu")
    _same_leaves(got, want)
    _same_leaves(got, frozen)
    tmpl = trc.matrices_fq_template(cfg, fq, seed=1, device="cpu")
    assert len(tree_leaves(tmpl)) == len(tree_leaves(got))
