"""chip_smoke.py phase 17 (calibration under a mesh) rehearsed on the CPU:
the parent's single-device references, the rank work inside phase 16's
spawn of two gloo ranks (calibrate under {tp 2} and {dp 2}, float32 and
bf16; the sharded checkpoint; DeepSeek under {ep 2} and {tp 2}), the
checks against the single device, the checkpoint read whole and the
served model with every launch held to its plain version, at small widths
(hidden 256, 2 layers, 2 heads of 128; DeepSeek dim 256 with 8 experts).
On the CPU the wrappers run the plain versions and launch no kernel; the
checked wrappers still count every call they hold to its plain version,
and the phase's own checks run as on the card.
"""

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def phase17():
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from flatquant_torch.models.config import LlamaConfig
    from flatquant_torch.models.deepseek import DeepSeekConfig

    cfg = LlamaConfig(name="p17-small", vocab_size=256, hidden_size=256,
                      intermediate_size=512, num_layers=2, num_heads=2,
                      num_kv_heads=2)
    ds_cfg = DeepSeekConfig(dim=256, inter_dim=320, moe_inter_dim=256,
                            n_heads=2, n_routed_experts=8,
                            n_activated_experts=2, kv_lora_rank=128,
                            vocab_size=256, n_layers=2, n_dense_layers=1)
    sizes = dict(samples=4, seq=64, bsz=4, ds_samples=2, ds_seq=32, S=2048,
                 new=3)
    mp = pytest.MonkeyPatch()
    try:
        for name in ("synchronize", "empty_cache", "reset_peak_memory_stats",
                     "ipc_collect"):
            mp.setattr(torch.cuda, name, lambda *a: None)
        for name in ("memory_allocated", "max_memory_allocated"):
            mp.setattr(torch.cuda, name, lambda *a: 0)
        results = {}
        paths = cs.run_parallel_path(
            torch, torch.device("cpu"), results, "cpu", phases=("17",),
            p17=dict(cfg=cfg, ds_cfg=ds_cfg, sizes=sizes))
    finally:
        mp.undo()
    return cs, cfg, ds_cfg, results, paths


def test_phase17_runs_every_mesh_on_both_ranks(phase17):
    """Both ranks ran calibrate under {tp 2} and {dp 2} in float32 and bf16,
    the shard-aligned state under {tp 2} in float32, and DeepSeek under
    {ep 2} and {tp 2}, talking over gloo. In float32 every layer's step
    holds JAX's tolerances or four times the single device's own noise
    floor, its state but for first-step sign flips, and every layer's
    first-step gradient agrees with the single device's leaf by leaf (the
    phase raises otherwise)."""
    cs, cfg, _, results, paths = phase17
    rec = results["mesh_calib_path"]
    assert len(rec["ranks"]) == cs.P16_WORLD
    floor = rec["noise_floor"]
    for r in rec["ranks"]:
        assert set(r["transport"]) == {"gloo"} and r["transport"]["gloo"] > 0
        for key, want in cs._p17_keys():
            run = r[key]
            assert len(run["mses"]) == (2 if key.startswith("ds")
                                        else cfg.num_layers)
            assert len(run["step_s"]) == sum(len(m) for m in run["mses"])
            if key.endswith("bf16") or key.startswith("fault_"):
                continue
            assert run["failed"] == [], key
            for c, f in zip(run["layers"], floor[want]):
                assert len(c["grad_rel"]) == len(f["grad_rel"]) > 0
                assert cs._p17_limits(c, f)[3] == [], (key, c["failed"])
    assert "phase17_s" in results and set(paths) == {"mesh_calib_serve"}


def test_phase17_planted_faults_fail_the_gradient_gate(phase17):
    """Each planted fault (the dp gradient sum left out, a rank's partial
    sum added twice in copy-to's backward, reduce-from's all-reduce
    removed) fails the gradient gate on both ranks; the removed
    all-reduce fails the MSE gate too, and the doubled partial sum, which
    the forward cannot see, leaves the MSE gate passing."""
    cs, _, _, results, _ = phase17
    for r in results["mesh_calib_path"]["ranks"]:
        for fault, _ in cs.P17_FAULTS:
            assert "grad" in r[f"fault_{fault}"]["failed"], fault
        assert "mse" in r["fault_reduce_from_removed"]["failed"]
        assert "mse" not in r["fault_partial_sum_doubled"]["failed"]


def test_phase17_deepseek_forward_and_experts(phase17):
    """(c): the fp forward under each mesh within JAX's 3e-4 of the single
    device's logits, the calib forward within its relative limit (3e-4,
    or four times its noise floor, at most P17_DS_CALIB_CAP); under ep
    each rank holds half the experts."""
    cs, _, ds_cfg, results, _ = phase17
    for r in results["mesh_calib_path"]["ranks"]:
        for key in ("ds_ep", "ds_tp"):
            fwd = r[key]["forward"]
            assert fwd["fp"]["excess"] <= cs.P17_DS_FWD_TOL
            assert fwd["calib"]["rel"] <= r[key]["calib_forward_limit"] \
                <= cs.P17_DS_CALIB_CAP
        assert r["ds_ep"]["experts"] == ds_cfg.n_routed_experts // 2
        assert r["ds_tp"]["experts"] == ds_cfg.n_routed_experts


def test_phase17_checkpoint_served_with_every_call_checked(phase17):
    """(b): the sharded checkpoint read whole (the phase raises unless
    bit-equal to the weights and the ranks' state), then the prefill and
    the decode steps with every call of the kernels' wrappers held to its
    plain version."""
    cs, cfg, _, results, _ = phase17
    b = results["mesh_calib_path"]["b"]
    assert b["params"] > 0 and b["state"] > 0
    chk = b["per_launch_checks"]
    assert chk["prefill"]["w4a4_matmul_i8"] > 0
    assert chk["steps"]["decode_attention_int4"] == 3 * cfg.num_layers
    assert chk["max_abs_err"]["w4a4_matmul_i8"] == 0.0
    assert not list((REPO / ".chipscratch").glob("phase17_*"))


def test_p17_close_flags_a_drifted_state():
    """_p17_close, layer by layer: an MSE past rtol 1e-5 and a state element
    past 5e-4 of the single device's are counted; one within two first
    steps of its rate is a possible sign flip, one beyond it is
    unexplained; each leaf's gradient difference is relative to its norm;
    equal runs count nothing. _p17_limits: JAX's tolerances, or four
    times the noise floor where that is looser."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    g = [[torch.ones(4)], [torch.ones(2)]]
    want = dict(mses=[[1.0], [0.5]], leaves=[torch.zeros(4), torch.zeros(2)],
                grads=g)
    same = cs._p17_close(want, want, "same", [[5e-3], [5e-3]])
    assert [(c["mse_rel"], c["outside"], c["unexplained"], c["elements"],
             c["grad_rel"]) for c in same] == [(0.0, 0, 0, 4, [0.0]),
                                               (0.0, 0, 0, 2, [0.0])]
    got = dict(mses=[[1.0], [0.5 * (1 + 2e-5)]],
               leaves=[torch.zeros(4), torch.tensor([9e-3, 2e-2])],
               grads=[[torch.ones(4)], [torch.tensor([1.0, 1.05])]])
    first, second = cs._p17_close(got, want, "drift", [[5e-3], [5e-3]])
    assert first["outside"] == 0 and second["mse_rel"] > cs.P17_MSE_RTOL
    assert second["state_max_abs"] == pytest.approx(2e-2)
    assert (second["outside"], second["unexplained"]) == (2, 1)
    assert second["grad_rel"] == [pytest.approx(0.05 / 2 ** 0.5)]
    assert cs._p17_limits(first, same[0]) == (
        cs.P17_MSE_RTOL, cs.P17_FLIP_SHARE * 4, [cs.P17_GRAD_RTOL], [])
    assert cs._p17_limits(dict(second, unexplained=0), same[1])[3] == [
        "mse", "state", "grad"]
    # a looser floor passes the MSE and the gradient; the state's 2 of 2
    # elements outside pass the count cap (half of them) all the same
    noisy = dict(same[1], mse_rel=1e-5, outside=1, grad_rel=[0.01])
    assert cs._p17_limits(dict(second, unexplained=0), noisy)[3] == [
        "state"]
    assert cs._p17_limits(dict(second, outside=1, unexplained=0),
                          noisy)[3] == []
    assert cs._p17_limits(dict(second, outside=1), noisy)[3] == ["state"]


def test_p17_limits_cap_the_state_count_and_hold_every_gradient_leaf():
    """The state count limit never passes half a layer's elements, however
    loud the floor; every gradient leaf is held to 2% of its norm or four
    times its floor, and a leaf whose limit passes P17_GRAD_CAP is counted
    as loose."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    c = dict(mse_rel=0.0, outside=60, unexplained=0, elements=100,
             grad_rel=[0.01, 3.9, 0.01])
    floor = dict(mse_rel=0.0, outside=50, grad_rel=[0.0, 1.0, 0.0])
    _, out_lim, glims, failed = cs._p17_limits(c, floor)
    assert out_lim == cs.P17_COUNT_CAP * 100 and failed == ["state"]
    assert glims == [cs.P17_GRAD_RTOL, 4.0, cs.P17_GRAD_RTOL]
    assert cs._p17_grad_worst(c, glims)[3:] == (0, 1)
    c = dict(c, outside=0, grad_rel=[0.01, 4.1, 0.03])
    assert cs._p17_limits(c, floor)[3] == ["grad"]
    assert cs._p17_grad_worst(c, glims)[3:] == (2, 1)
