"""The port's CLI (python -m flatquant_torch.main) against JAX's main.py,
both in process on the CPU, with the argv of tests/test_persistence.py's
CLI smoke test (tiny-llama, W4A4, --cali_trans --lwc, 1 epoch of 4
samples, seqlen 16, PPL, packed export, a 4-token demo, the perm layout)
plus --hf_path: both packages load the same HF fixture (the port's
write_hf_llama_fixture), so they start from the same weights; the FQ
state (init_model_fq) and the data (get_loaders) are bit-equal by
construction. Both packages' get_loaders are wrapped to cut the held-out
stream to 4096 tokens (256 chunks of 16; the default 524,288 would take
JAX's per-chunk loop about a minute), and both ppl_eval to compute in
float32: in the CLI's bf16 the two forwards round apart (a float32 sum
in another order moves a bf16 rounding, then an activation-quant code),
measured 1.5e-4 to 1.7e-3 relative on these models, while in float32
the same weights give PPLs within 1e-6.

Tolerances, and why:
  - RTN only (no calibration flags): PPL within 1e-4 relative; the two
    bakes' float32 Cayley solves round apart (PR 16), which moves a
    weight's RTN code at a tie now and then.
  - calibrated: PPL within 15% (the trainer's trajectory band,
    tests/test_torch_trainer.py).
  - exports: each package's packed safetensors and flat_parameters load
    into the other's structure with every tensor present and finite.
  - tiny-deepseek (no --hf_path for DeepSeek yet: the port's CLI runs on
    JAX's init_ds_params, converted; both forwards in float32): RTN-only
    PPL within 1e-4 relative (the two bakes round apart by float32 ulps,
    1.3e-6 here); JAX's exports in the port against the port's own bake
    and pack with the bounds of tests/test_torch_ds_calib.py, the matrices
    at 1e-5; the port's calibrated exports in JAX equal, leaf for leaf,
    to the objects they were saved from.
"""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

import jax
import torch

from flatquant_tpu.calib import data as jdata
from flatquant_tpu.evals import ppl as jppl
from flatquant_tpu.models.config import get_config as j_get_config
from flatquant_tpu.models.llama import init_params as j_init_params
from flatquant_tpu.quantize.bake import bake_model as j_bake_model
from flatquant_tpu.quantize.spec import FQConfig as JFQConfig
from flatquant_tpu.quantize.state import init_model_fq as j_init_model_fq
from flatquant_tpu.serving.quantized import (
    build_serving_params as j_build_serving_params,
)
from flatquant_tpu.utils import checkpoint as jck
from flatquant_torch import main as tmain
from flatquant_torch.calib import data as tdata
from flatquant_torch.evals import ppl as tppl
from flatquant_torch.models.config import get_config
from flatquant_torch.models.llama import init_params
from flatquant_torch.models.loader import write_hf_llama_fixture
from flatquant_torch.quantize.bake import bake_model
from flatquant_torch.quantize.spec import FQConfig
from flatquant_torch.quantize.state import init_model_fq
from flatquant_torch.serving.quantized import build_serving_params
from flatquant_torch.utils import checkpoint as tck
from flatquant_torch.utils.tree import tree_leaves

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent

ARGV = ["--platform", "cpu", "--model", "tiny-llama", "--w_bits", "4",
        "--a_bits", "4", "--cali_trans", "--lwc", "--epochs", "1",
        "--nsamples", "4", "--cali_bsz", "2", "--seqlen", "16",
        "--eval_ppl", "--quantized_save", "--generate_demo", "4",
        "--perm_transforms"]
RTN_ARGV = [a for a in ARGV if a not in ("--cali_trans", "--lwc")]
TEST_TOKENS = 4096


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_main():
    spec = importlib.util.spec_from_file_location("jax_cli_main",
                                                  REPO / "main.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("hf"))
    write_hf_llama_fixture(path, get_config("tiny-llama"), seed=0)
    return path


@pytest.fixture
def short_stream(monkeypatch):
    """Both packages' get_loaders with a 4096-token held-out stream, both
    ppl_eval in float32; JAX's PPLs recorded."""
    for mod in (jdata, tdata):
        orig = mod.get_loaders

        def cut(*a, _orig=orig, **k):
            k.setdefault("n_test_tokens", TEST_TOKENS)
            return _orig(*a, **k)

        monkeypatch.setattr(mod, "get_loaders", cut)
    seen = []
    orig_ppl, orig_tppl = jppl.ppl_eval, tppl.ppl_eval

    def ppl(*a, **k):
        seen.append(orig_ppl(*a, compute_dtype=jax.numpy.float32, **k))
        return seen[-1]

    monkeypatch.setattr(jppl, "ppl_eval", ppl)
    monkeypatch.setattr(tppl, "ppl_eval", lambda *a, **k: orig_tppl(
        *a, compute_dtype=torch.float32, **k))
    return seen


def _run(argv, out, hf_dir, short_stream):
    argv = argv + ["--hf_path", hf_dir, "--output_dir"]
    got = tmain.main(argv + [str(out / "t")])
    _jax_main()(argv + [str(out / "j")])
    assert len(short_stream) == 1 and set(got["ppl"]) == {"wikitext2"}
    return got, short_stream[0], [out / w / "tiny-llama" / "w4a4" / "exp"
                                  for w in ("t", "j")]


def test_cli_rtn_ppl_matches_jax(tmp_path, hf_dir, short_stream):
    got, want, _ = _run(RTN_ARGV, tmp_path, hf_dir, short_stream)
    assert abs(got["ppl"]["wikitext2"] - want) <= 1e-4 * want
    assert np.asarray(got["tokens"]).shape == (1, 4)


def _templates(fq_kw):
    """Structure templates of the tiny-llama export in both packages."""
    cfg, jcfg = get_config("tiny-llama"), j_get_config("tiny-llama")
    fq, jfq = FQConfig(**fq_kw), JFQConfig(**fq_kw)
    tbp, tbf = bake_model(cfg, fq, init_params(cfg, seed=7, device="cpu"),
                          init_model_fq(cfg, fq, seed=7, device="cpu"))
    jbp, jbf = j_bake_model(jcfg, jfq, j_init_params(jcfg, seed=7),
                            j_init_model_fq(jcfg, jfq, seed=7))
    return (build_serving_params(cfg, fq, tbp, tbf, perm_transforms=True),
            j_build_serving_params(jcfg, jfq, jbp, jbf,
                                   perm_transforms=True),
            init_model_fq(cfg, fq, seed=7, device="cpu"),
            j_init_model_fq(jcfg, jfq, seed=7))


def _finite(tree):
    leaves = tree_leaves(tree)
    assert leaves
    for t in leaves:
        assert torch.isfinite(t.float()).all()


def test_cli_calibrated_ppl_and_exports_cross(tmp_path, hf_dir,
                                              short_stream):
    got, want, (tdir, jdir) = _run(ARGV, tmp_path, hf_dir, short_stream)
    assert abs(got["ppl"]["wikitext2"] - want) <= 0.15 * want
    tsp, jsp, tfq, jfq = _templates(dict(w_bits=4, a_bits=4,
                                         cali_trans=True, lwc=True,
                                         add_diag=False, lac=False))
    name = "model_packed_int4.safetensors"
    # the JAX export in the port, the port's export in JAX
    _finite(tck.load_packed_safetensors(str(jdir / name), tsp))
    back = jck.load_packed_safetensors(str(tdir / name), jsp)
    assert all(np.isfinite(np.asarray(a, np.float32)).all()
               for a in jax.tree.leaves(back))
    _finite(tck.load_flat_parameters(str(jdir), tfq))
    jck.load_flat_parameters(str(tdir), jfq)
    trained = tck.load_flat_parameters(str(tdir), tfq)
    for a, b in zip(tree_leaves(trained), tree_leaves(got["fq"])):
        assert torch.equal(a, b)


DS_ARGV = ["--platform", "cpu", "--model", "tiny-deepseek", "--w_bits", "4",
           "--a_bits", "4", "--epochs", "1", "--nsamples", "2",
           "--cali_bsz", "1", "--seqlen", "16", "--eval_ppl",
           "--save_matrix", "--quantized_save"]


@pytest.fixture
def ds_float32(monkeypatch):
    """Both packages' deepseek_forward (the DeepSeek CLIs' PPL forward) in
    float32, as short_stream does for ppl_eval."""
    from flatquant_tpu.models import deepseek as jds
    from flatquant_torch.models import deepseek as tds

    for mod, dt in ((jds, jax.numpy.float32), (tds, torch.float32)):
        def f32(*a, _orig=mod.deepseek_forward, _dt=dt, **k):
            k["compute_dtype"] = _dt
            return _orig(*a, **k)

        monkeypatch.setattr(mod, "deepseek_forward", f32)


@pytest.fixture
def ds_jax_weights(monkeypatch):
    """The port's CLI on JAX's random DeepSeek weights: init_ds_params of
    the two packages draw from different generators."""
    from flatquant_tpu.models import deepseek as jds
    from flatquant_torch.models import deepseek as tds
    from flatquant_torch.utils.convert import from_jax_ds_serving_params

    def jax_params(cfg, seed=0, dtype=torch.float32, device="cuda"):
        return from_jax_ds_serving_params(_np(jds.init_ds_params(
            jds.TINY_DEEPSEEK, seed=seed)), device)

    monkeypatch.setattr(tds, "init_ds_params", jax_params)


def _logged_ppl(exp):
    """The PPL that JAX's DeepSeek branch logs (it returns nothing)."""
    (path,) = exp.glob("log_*.txt")
    return float(re.search(r"deepseek synthetic PPL: ([0-9.]+)",
                           path.read_text()).group(1))


def _ds_exp(root):
    return root / "tiny-deepseek" / "w4a4" / "exp"


def _ds_templates(fq_kw):
    """JAX's tiny-deepseek state and packed serving params, structure
    templates for its loaders."""
    from flatquant_tpu.models import deepseek as jds

    jfq = JFQConfig(w_bits=4, a_bits=4, **fq_kw)
    state = jds.init_ds_fq(jds.TINY_DEEPSEEK, jfq, seed=0)
    baked = jax.jit(jds.bake_ds_fq)(*state)
    sp, _ = jax.jit(lambda p, d, m: jds.build_ds_serving_params(
        jds.TINY_DEEPSEEK, jfq, p, d, m))(
            jds.init_ds_params(jds.TINY_DEEPSEEK, seed=3), *state)
    return state, baked, sp


def test_cli_deepseek_rtn_ppl_matches_jax(tmp_path, short_stream,
                                          ds_float32, ds_jax_weights):
    """tiny-deepseek, RTN only, through both CLIs from the same seed and
    JAX's weights: the PPL within 1e-4 relative; JAX's flat_matrices and
    packed export load into the port and match the port's own bake (1e-5
    absolute) and pack (codes but at rounding ties, share at most 1e-3;
    scales 1e-5 relative; activation clips equal). Measured: PPL 1.7e-5
    apart, matrices 1.3e-6, scales 1.5e-6, no code apart."""
    from flatquant_torch.kernels.int4_matmul import unpack_weight_planar
    from flatquant_torch.models.deepseek import bake_ds_fq
    from flatquant_torch.utils.checkpoint import flatten_with_keys

    got = tmain.main(DS_ARGV + ["--output_dir", str(tmp_path / "t")])
    _jax_main()(DS_ARGV + ["--output_dir", str(tmp_path / "j")])
    want = _logged_ppl(_ds_exp(tmp_path / "j"))
    assert abs(got["ppl"]["synthetic"] - want) <= 1e-4 * want
    jexp = str(_ds_exp(tmp_path / "j"))
    baked = bake_ds_fq(*got["fq"])
    for a, b in zip(tree_leaves(tck.load_flat_matrices(jexp, baked)),
                    tree_leaves(baked)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    back = flatten_with_keys(tck.load_packed_safetensors(
        jexp + "/ds_packed_int4.safetensors", got["serving"]))
    mine = flatten_with_keys(got["serving"])
    assert back.keys() == mine.keys()
    flips = total = 0
    for k, w in mine.items():
        g = back[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k.endswith("/wp"):
            d = unpack_weight_planar(g).int() - unpack_weight_planar(w).int()
            assert d.abs().max() <= 1, k
            flips += int((d != 0).sum())
            total += d.numel()
        elif k.endswith("/scale"):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                       err_msg=k)
        else:
            assert torch.equal(g, w), k
    assert flips <= 1e-3 * total, f"{flips} of {total} codes differ"


def test_cli_deepseek_runs_and_exports_load_in_jax(tmp_path, short_stream):
    """tiny-deepseek through the port's whole DeepSeek sequence on the CPU:
    calibration, bake, flat_parameters, flat_matrices, the packed export,
    PPL. JAX reads the three artifacts, and each equals, leaf for leaf,
    the port's object it was saved from."""
    from flatquant_torch.models.deepseek import bake_ds_fq
    from flatquant_torch.utils.checkpoint import flatten_with_keys
    from flatquant_torch.utils.convert import (
        from_jax_ds_fq,
        from_jax_ds_serving_params,
    )

    out = tmain.main(DS_ARGV + ["--lwc", "--lac", "--output_dir",
                                str(tmp_path)])
    ppl = out["ppl"]["synthetic"]
    assert np.isfinite(ppl) and 1.0 < ppl < 10 * 256
    exp = str(_ds_exp(tmp_path))
    state, baked, sp = _ds_templates(dict(lwc=True, lac=True,
                                          cali_trans=False, add_diag=False))

    def same(jtree, mine):
        got = tree_leaves(from_jax_ds_fq(_np(jtree), "cpu"))
        want = tree_leaves(mine)
        assert len(got) == len(want)
        assert all(torch.equal(a, b) for a, b in zip(got, want))

    same(jck.load_flat_parameters(exp, state), out["fq"])
    same(jck.load_flat_matrices(exp, baked), bake_ds_fq(*out["fq"]))
    back = jck.load_packed_safetensors(exp + "/ds_packed_int4.safetensors",
                                       sp)
    got = flatten_with_keys(from_jax_ds_serving_params(_np(back), "cpu"))
    want = flatten_with_keys(out["serving"])
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("extra,match", [
    (["--lm_eval", "piqa"], "item 7"),
    (["--plot_flatness", "x.png"], "item 7"),
    (["--model", "tiny-deepseek", "--hf_path", "x"], "item 5"),
])
def test_cli_unported_flags_raise(extra, match):
    with pytest.raises(NotImplementedError, match=match):
        tmain.main(["--platform", "cpu"] + extra)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cli_without_platform_cpu_needs_a_card():
    with pytest.raises(RuntimeError, match="--platform cpu"):
        tmain.main(["--model", "tiny-llama"])
