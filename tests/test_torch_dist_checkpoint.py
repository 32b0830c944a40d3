"""The port's topology-free sharded checkpoints
(flatquant_torch/utils/dist_checkpoint.py) and its two-process
calibration step, against JAX's (tests/test_parallel.py:272 and :302,
tests/test_distributed_2proc.py).

Four gloo ranks write tiny-llama's params sharded at {dp 2, tp 2} (with a
vocab-parallel embedding) and a replicated FQ state, and read them back at
{tp 4} under the head-granular specs; this process reads them whole.
Both must be bit-equal. Two processes joined by init_distributed run one
calibration step whose dp gradient sum crosses the process boundary and
write it sharded; this process restores it.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import _torch_calib_cases as cases
from _dist_step import make_step_inputs, one_calib_step
from flatquant_tpu.models.config import get_config as j_get_config
from flatquant_tpu.models.llama import init_params as j_init_params
from flatquant_tpu.quantize.spec import W4A4KV4 as J_W4A4KV4
from flatquant_tpu.quantize.state import init_model_fq as j_init_model_fq
from flatquant_torch.calib import trainer as tt
from flatquant_torch.models.config import get_config
from flatquant_torch.models.llama import causal_mask, llama_layer, rope_tables
from flatquant_torch.parallel.launch import run_ranks
from flatquant_torch.quantize.spec import W4A4KV4
from flatquant_torch.utils.convert import from_jax_fq, from_jax_params
from flatquant_torch.utils.dist_checkpoint import load_sharded, save_sharded
from flatquant_torch.utils.tree import tree_leaves

REPO = Path(__file__).resolve().parents[1]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def tiny():
    cfg = j_get_config("tiny-llama")
    return dict(params=_np(j_init_params(cfg, seed=0)),
                fq={tp: _np(j_init_model_fq(cfg, J_W4A4KV4, seed=0, tp=tp))
                    for tp in (1, 2)})


@pytest.fixture(scope="module")
def resharded(tiny, tmp_path_factory):
    """(the checkpoint's directory, what each of 4 ranks read at {tp 4})."""
    path = str(tmp_path_factory.mktemp("ckpt") / "llama")
    res = run_ranks(cases.checkpoint_cases, 4, args=(tiny, path),
                    device="cpu", threads=1, timeout_s=240.0,
                    rendezvous_dir=str(tmp_path_factory.mktemp("rdzv")))
    return path, res


def _whole(tiny):
    return {"params": from_jax_params(tiny["params"], "cpu"),
            "fq": from_jax_fq(tiny["fq"][1], "cpu")}


def test_reshard_to_tp4_bit_equal(tiny, resharded):
    """Written at {dp 2, tp 2}, read at {tp 4}: every rank's block of every
    leaf equals the block cut from the whole tree, bit for bit (wq and
    the vocab at a quarter, wk / wv whole by the head-granular rule)."""
    _, res = resharded
    cfg = get_config("tiny-llama")
    n = len(tree_leaves(_whole(tiny)))
    for r, got in enumerate(res):
        assert len(got["equal"]) == n and all(got["equal"]), r
    shapes = res[0]["shapes"]
    assert (cfg.q_dim // 4, cfg.hidden_size) in shapes
    assert (cfg.kv_dim, cfg.hidden_size) in shapes  # wk replicated


def test_reshard_to_one_process_bit_equal(tiny, resharded):
    """The same checkpoint read whole in one process, without a mesh: the
    original tree bit for bit, dtypes kept; only the owners wrote (one
    rank per block: dp rank 0 of each tp pair)."""
    path, _ = resharded
    whole = _whole(tiny)
    got = load_sharded(path, whole)
    for a, b in zip(tree_leaves(whole), tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    files = sorted(os.listdir(path))
    assert files == ["shard-00000.json", "shard-00000.safetensors",
                     "shard-00001.json", "shard-00001.safetensors"]


def test_replicated_roundtrip(tmp_path, tiny):
    """No mesh: a plain tree (the FQ state, a bf16 tensor, a nested list)
    round-trips bit for bit; a second save to the same directory
    replaces the first; a wrong template shape refuses."""
    fq = from_jax_fq(tiny["fq"][2], "cpu")
    tree = {"fq": fq, "w": [torch.randn(3, 5).to(torch.bfloat16)],
            "step": torch.tensor(7)}
    path = save_sharded(str(tmp_path / "fq"), tree)
    got = load_sharded(path, tree)
    for a, b in zip(tree_leaves(tree), tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    save_sharded(path, {"w": [tree["w"][0]]})
    with pytest.raises(KeyError):
        load_sharded(path, tree)
    with pytest.raises(ValueError, match="stored shape"):
        load_sharded(path, {"w": [torch.zeros(5, 3)]})


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _port_step(inp):
    """The port's single-device step on the same inputs, in process."""
    cfg, fq_cfg = inp["cfg"], inp["fq_cfg"]
    S = inp["x"].shape[1]
    cos, sin = rope_tables(cfg, torch.arange(S))
    mask = causal_mask(S, "cpu")
    state = tt._master(inp["fq"])
    opt = tt.make_optimizer(fq_cfg, state, tt.build_labels(state), 1)
    tt.calib_step(opt, lambda f, lp, xx: llama_layer(
        cfg, fq_cfg, "calib", lp, f, xx, cos, sin, mask), state, inp["lp"],
        inp["x"], inp["teacher"])
    return state


# The one leaf of the two-process step farther than 2e-5 from JAX's
# one_calib_step: one row's LWC clip (1.6e-4 apart), whose gradient,
# 3.4e-9, is float noise that AdamW's first step follows; the port's
# single-device step is as far from JAX's there
NOISE_GRADIENT_CLIP = ".mlp.up_lin.clip_w_min"


def test_two_process_distributed_calib_step(tmp_path):
    """Two processes joined by init_distributed (FLATQUANT_* variables)
    run one step on {dp 2}, each on half the batch, and write it sharded;
    restored here in one process, the state equals the port's in-process
    single-device step within 2e-5 (tests/test_distributed_2proc.py's
    bound: distribution changes only the order of sums), and JAX's
    one_calib_step within 2e-5 on every leaf but one element of
    NOISE_GRADIENT_CLIP, which is held to the step tolerance of 5e-4
    (tests/test_parallel.py:184; every leaf is); each process's rows of
    the batch come back bit for bit."""
    cfg, fq_cfg, lp, fq_l, x, teacher = make_step_inputs()
    inp = dict(
        cfg=get_config("tiny-llama"),
        fq_cfg=dataclasses.replace(W4A4KV4, deactive_amp=True),
        lp={k: torch.tensor(np.asarray(v)) for k, v in lp.items()},
        fq=from_jax_fq(jax.tree.map(lambda a: np.asarray(a)[None], fq_l),
                       "cpu")[0],
        x=torch.tensor(x), teacher=torch.tensor(teacher))
    torch.save(inp, tmp_path / "inputs.pt")
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ, FLATQUANT_NUM_PROCESSES="2",
                   FLATQUANT_COORDINATOR=f"localhost:{port}",
                   FLATQUANT_PROCESS_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "_torch_dist_worker.py"),
             str(tmp_path)], env=env, cwd=str(REPO), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a distributed worker timed out")
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0 and "WORKER_OK" in out, (rc, out, err[-2000:])

    got = load_sharded(str(tmp_path / "fq_step"),
                       {"fq": inp["fq"], "x": inp["x"]})
    assert torch.equal(got["x"], inp["x"])
    own = [t.detach().numpy() for t in tree_leaves(_port_step(inp))]
    ref, _ = one_calib_step(cfg, fq_cfg, fq_l, lp, jnp.asarray(x),
                            jnp.asarray(teacher))
    leaves = [t.numpy() for t in tree_leaves(got["fq"])]
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(ref)[0]]
    ref = [np.asarray(a) for a in jax.tree.leaves(ref)]
    assert len(leaves) == len(own) == len(ref)
    for i, (a, b, c) in enumerate(zip(own, ref, leaves)):
        np.testing.assert_allclose(c, a, rtol=2e-5, atol=2e-5,
                                   err_msg=f"leaf {i} vs the port's step")
        np.testing.assert_allclose(c, b, rtol=5e-4, atol=5e-4,
                                   err_msg=f"leaf {i} vs JAX's step")
        if paths[i] != NOISE_GRADIENT_CLIP:
            np.testing.assert_allclose(c, b, rtol=2e-5, atol=2e-5,
                                       err_msg=f"{paths[i]} vs JAX's step")
        else:
            # one element, whose gradient is float noise, may step the
            # other way
            assert (np.abs(c - b) > 2e-5 + 2e-5 * np.abs(b)).sum() <= 1
