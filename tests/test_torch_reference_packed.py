"""The reference-deploy packed checkpoint format (the deploy-packed half
of utils/reference_convert.py) against the JAX package, on the CPU, on
`tiny-llama` W4A4KV4 with LAC clips (so the clip logits are in the file)
and JAX's baked model in both packages.

Tolerances, and why:
  - the interleaved nibble pack: bit for bit on every code.
  - save_reference_packed: the two packages' files equal tensor by tensor
    (key, dtype, shape and bytes; JAX writes through safetensors.numpy,
    which orders the data differently, so the files are not compared as
    wholes). Each package loads the other's file.
  - load_reference_packed: codes, scales, biases, norms, embed and head
    byte for byte against the port's build_serving_params (unmerged) and
    against JAX's load; the activation and cache clip ratios equal to
    build_serving_params' (the same torch.sigmoid) and within 2 float32
    ulps of JAX's (XLA's logistic; measured equal); the cache transforms'
    inverses, recomputed from the stored matrices in float32
    (torch.linalg.inv against numpy's LAPACK), within 1e-5 of JAX's and
    of the analytic inverse that build_serving_params takes (measured
    3.0e-7 and 1.3e-6); in bf16 the two loads' inverses differ in no
    element (a float32 ulp can move a bf16 rounding only at a tie; none
    here).
  - serving: the loaded model's int4-cache prefill logits (float32,
    plain versions) within 2e-4 of the directly built model's (JAX's own
    bound: only the recomputed inverses differ) and of JAX's loaded
    model's; with the direct build's inverses swapped in, equal to the
    direct build's bit for bit.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from flatquant_tpu.models import llama as jl
from flatquant_tpu.models.config import get_config as j_get_config
from flatquant_tpu.quantize.bake import bake_model as j_bake_model
from flatquant_tpu.quantize.spec import FQConfig as JFQConfig
from flatquant_tpu.quantize.state import init_model_fq as j_init_model_fq
from flatquant_tpu.serving import engine as je
from flatquant_tpu.utils import reference_convert as jrc
from flatquant_torch.core.packing import pack_int4, unpack_int4
from flatquant_torch.models.config import get_config
from flatquant_torch.quantize.spec import FQConfig
from flatquant_torch.serving import engine as te
from flatquant_torch.serving.quantized import build_serving_params
from flatquant_torch.utils import reference_convert as trc
from flatquant_torch.utils.convert import (
    from_jax_fq,
    from_jax_params,
    from_jax_serving_params,
)
from flatquant_torch.utils.safetensors_io import read_safetensors

torch.set_num_threads(2)

FQ = dict(w_bits=4, a_bits=4, k_bits=4, v_bits=4, k_asym=True, v_asym=True,
          lac=True)
LINEARS = ("q", "k", "v", "o", "up", "gate", "down")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    d = tmp_path_factory.mktemp("deploy")
    jcfg, cfg = j_get_config("tiny-llama"), get_config("tiny-llama")
    jfq, fq = JFQConfig(**FQ), FQConfig(**FQ)
    jp = jl.init_params(jcfg, seed=0)
    jp["lm_head"] = jp["lm_head"] * 6.0
    jbp, jbf = jax.jit(lambda p, s: j_bake_model(jcfg, jfq, p, s))(
        jp, j_init_model_fq(jcfg, jfq, seed=0))
    tbp = from_jax_params(_np(jbp), "cpu")
    tbf = from_jax_fq(_np(jbf), "cpu")
    jpath = jrc.save_reference_packed(str(d / "j.safetensors"), jcfg, jfq,
                                      jbp, jbf)
    tpath = trc.save_reference_packed(str(d / "t.safetensors"), cfg, fq,
                                      tbp, tbf)
    return dict(jcfg=jcfg, cfg=cfg, jfq=jfq, fq=fq, tbp=tbp, tbf=tbf,
                jpath=jpath, tpath=tpath)


def test_i4_interleave_matches_jax():
    q = np.random.default_rng(0).integers(-8, 8, (6, 64)).astype(np.int8)
    got = pack_int4(torch.as_tensor(q))
    want = jrc._pack_i4_interleaved(q)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(unpack_int4(got).numpy(),
                                  jrc._unpack_i4_interleaved(want))
    np.testing.assert_array_equal(unpack_int4(got).numpy(), q)


def test_saved_files_equal_tensor_by_tensor(packed):
    got, _ = read_safetensors(packed["tpath"])
    want, _ = read_safetensors(packed["jpath"])
    assert list(got) != [] and set(got) == set(want)
    assert any(k.endswith("act_quantizer.clip_factor_a_max") for k in got)
    assert any(k.endswith("v_cache_quantizer.clip_factor_a_min")
               for k in got)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.numpy().tobytes() == w.numpy().tobytes(), k


CLIPS = ("kc_clip", "vc_clip")
INVERSES = ("k_t_inv", "v_t_inv")


def _check_layers(got, want, clip_rtol):
    """Every tensor but the recomputed inverses byte for byte (clip ratios
    within clip_rtol), the top-level ones too."""
    def same(a, b, key):
        assert a.dtype == b.dtype and torch.equal(a, b), key

    def close(a, b, key):
        for x, y in zip(a, b):
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=clip_rtol,
                                       atol=0, err_msg=key)

    assert set(got) == set(want), set(got) ^ set(want)
    for key in ("embed", "final_norm_w", "lm_head"):
        same(got[key], want[key], key)
    for g, w in zip(got["layers"], want["layers"]):
        assert set(g) == set(w), set(g) ^ set(w)
        assert all(k in g for k in CLIPS)
        for key, v in g.items():
            if key in INVERSES:
                continue
            if key in LINEARS:
                assert set(v) == set(w[key]) and "a_clip" in v, key
                for part, t in v.items():
                    (close if part == "a_clip" else same)(t, w[key][part],
                                                          f"{key} {part}")
            elif key in CLIPS:
                close(v, w[key], key)
            elif isinstance(v, tuple):
                for a, b in zip(v, w[key]):
                    same(a, b, key)
            else:
                same(v, w[key], key)


def test_load_equals_build_and_jax_load(packed):
    """The port loads its own file and JAX's: equal to its unmerged
    build_serving_params, and to JAX's load of the same file."""
    cfg, fq = packed["cfg"], packed["fq"]
    direct = build_serving_params(cfg, fq, packed["tbp"], packed["tbf"],
                                  dtype=torch.float32)
    jload = from_jax_serving_params(_np(jrc.load_reference_packed(
        packed["jpath"], packed["jcfg"], packed["jfq"], dtype=jnp.float32)),
        "cpu")
    for path in ("tpath", "jpath"):
        got = trc.load_reference_packed(packed[path], cfg, fq,
                                        dtype=torch.float32, device="cpu")
        _check_layers(got, direct, clip_rtol=0)
        _check_layers(got, jload, clip_rtol=2.4e-7)
        for g, d, j in zip(got["layers"], direct["layers"],
                           jload["layers"]):
            for key in INVERSES:
                np.testing.assert_allclose(g[key].numpy(), j[key].numpy(),
                                           atol=1e-5)
                np.testing.assert_allclose(g[key].numpy(), d[key].numpy(),
                                           atol=1e-5)
        bf = trc.load_reference_packed(packed[path], cfg, fq, device="cpu")
        jbf = jrc.load_reference_packed(packed[path], packed["jcfg"],
                                        packed["jfq"])
        for i, g in enumerate(bf["layers"]):
            for key in INVERSES:
                want = np.asarray(jbf["layers"][key][i], np.float32)
                diff = int((g[key].float().numpy() != want).sum())
                assert diff == 0, f"{key} layer {i}: {diff} elements differ"


def test_jax_loads_the_ports_file(packed):
    jgot = jrc.load_reference_packed(packed["tpath"], packed["jcfg"],
                                     packed["jfq"], dtype=jnp.float32)
    jwant = jrc.load_reference_packed(packed["jpath"], packed["jcfg"],
                                      packed["jfq"], dtype=jnp.float32)
    for a, b in zip(jax.tree.leaves(jgot), jax.tree.leaves(jwant)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_round_trip_serves_as_the_direct_build(packed):
    cfg, fq, jcfg = packed["cfg"], packed["fq"], packed["jcfg"]
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16))
    direct = build_serving_params(cfg, fq, packed["tbp"], packed["tbf"],
                                  dtype=torch.float32)
    loaded = trc.load_reference_packed(packed["tpath"], cfg, fq,
                                       dtype=torch.float32, device="cpu")
    # the loaded model with the direct build's inverses: nothing else
    # differs, so its logits are the direct build's bit for bit
    swapped = dict(loaded, layers=[dict(g, **{k: d[k] for k in INVERSES})
                                   for g, d in zip(loaded["layers"],
                                                   direct["layers"])])
    outs = []
    for sp in (direct, loaded, swapped):
        cache = te.init_cache(cfg, 2, 16, mode="int4", device="cpu")
        outs.append(te.serving_prefill(cfg, fq, sp, toks, cache,
                                       use_kernel=False, max_len=16,
                                       compute_dtype=torch.float32,
                                       device="cpu")[0].numpy())
    jsp = jrc.load_reference_packed(packed["tpath"], jcfg, packed["jfq"],
                                    dtype=jnp.float32)
    jl_, _ = je.serving_prefill(jcfg, packed["jfq"], jsp, jnp.asarray(toks),
                                je.init_cache(jcfg, 2, 16, dtype=jnp.float32,
                                              mode="int4"),
                                use_kernel=False, max_len=16,
                                compute_dtype=jnp.float32)
    np.testing.assert_array_equal(outs[2], outs[0])
    np.testing.assert_allclose(outs[1], outs[0], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(outs[1], np.asarray(jl_), rtol=2e-4,
                               atol=2e-4)
