"""chip_smoke.py phase 18 (configurations under a mesh) rehearsed on the
CPU at small widths: (a) pp 2 x dp 2 serving on four gloo ranks (hidden
256, 4 layers, 2 heads of 128; 8 prompts of 256 tokens, so each dp rank
feeds 512 rows a microbatch through the fused routes), the int4 slot
cache and the paged pool, every rank's greedy tokens against the
single-device engine's and every call of a prefill and two steps held to
its plain version; (b) DeepSeek generation and (c) GPTQ under tp = 2
inside phase 16's spawn of two ranks (DeepSeek dim 256 with 8 experts; a
one-layer hidden-256 Llama), the planted GPTQ fault failing the gates.
(d) needs a card's trace and is left out here. On the CPU the wrappers
run the plain versions and launch no kernel; the checked wrappers still
count every call they hold to its plain version, and the phase's own
checks run as on the card.
"""

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


def _p18():
    from flatquant_torch.models.config import LlamaConfig
    from flatquant_torch.models.deepseek import DeepSeekConfig

    return dict(
        cfg=LlamaConfig(name="p18-small", vocab_size=256, hidden_size=256,
                        intermediate_size=512, num_layers=4, num_heads=2,
                        num_kv_heads=2),
        ds_cfg=DeepSeekConfig(dim=256, inter_dim=320, moe_inter_dim=256,
                              n_heads=2, n_routed_experts=8,
                              n_activated_experts=2, kv_lora_rank=128,
                              vocab_size=256, n_layers=2, n_dense_layers=1),
        gptq_cfg=LlamaConfig(name="p18-gptq", vocab_size=256,
                             hidden_size=256, intermediate_size=512,
                             num_layers=1, num_heads=2, num_kv_heads=2),
        sizes=dict(new=3, max_len=272, ds_S=32, ds_new=4, ds_max_len=64,
                   gptq_samples=4, gptq_seq=64),
        timers=False)


@pytest.fixture(scope="module")
def phase18():
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    mp = pytest.MonkeyPatch()
    try:
        for name in ("synchronize", "empty_cache", "ipc_collect"):
            mp.setattr(torch.cuda, name, lambda *a: None)
        results = {}
        paths = cs.run_parallel_path(torch, torch.device("cpu"), results,
                                     "cpu", phases=("18",), p18=_p18())
        paths.update(cs.run_mesh_serving_path(
            torch, torch.device("cpu"), results, "cpu", p18=_p18()))
    finally:
        mp.undo()
    return cs, results, paths


def test_phase18_pp_dp_serving_on_four_ranks(phase18):
    """(a): each of the four ranks ran its stage's 2 layers for its dp
    rows over gloo; its tokens equal the single device's in both cache
    modes (the phase raises otherwise); every call of the int4 prefill
    and of two steps was held to its plain version: the fused routes'
    launches per layer and microbatch, and a decode step's four GEMMs,
    its attention and its token write."""
    cs, results, paths = phase18
    rec = results["mesh_serving_path"]
    assert sorted((r["dp"], r["pp"]) for r in rec["ranks"]) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    per = 2 * cs.P18_MICRO  # the stage's layers x microbatches
    for r in rec["ranks"]:
        assert set(r["transport"]) == {"gloo"}
        chk = r["int4"]["checked"]
        assert chk["prefill"] == cs._rows({k: v * per for k, v in
                                           cs.PREFILL_LAUNCHES.items()})
        assert chk["steps"] == cs._rows({k: v * per * 2 for k, v in
                                         cs.P18_STEP.items()})
        paged = r["paged"]["checked"]["steps"]
        assert paged[cs.P16_ROW["paged_decode_attention_int4"]] == per * 2
        for mode in ("int4", "paged"):
            assert r[mode]["tokens"] == rec["reference_tokens"][mode]
    assert set(paths) == {"pp_dp_prefill", "pp_dp_decode",
                          "pp_dp_paged_decode"}


def test_phase18_deepseek_generation_under_tp(phase18):
    """(b): both ranks' tokens equal the single device's, each step's
    logits within the limit (JAX's 3e-4, or four times the noise floor,
    at most P17_DS_CALIB_CAP)."""
    cs, results, _ = phase18
    rec = results["mesh_configs_path"]
    ref = rec["reference"]
    assert len(ref["ds_tokens"]) == _p18()["sizes"]["ds_new"]
    assert ref["ds_limit"] <= cs.P17_DS_CALIB_CAP
    for r in rec["ranks"]:
        assert r["b"]["tokens"] == ref["ds_tokens"]
        assert len(r["b"]["logits_rel"]) == len(ref["ds_tokens"])
        assert max(r["b"]["logits_rel"]) <= ref["ds_limit"]


def test_phase18_gptq_under_tp_and_its_planted_fault(phase18):
    """(c): on both ranks gptq_model under tp = 2 meets every gate against
    the single device's (the share of codes a step apart, the value grid,
    the layer's output error: JAX's tolerances or four times the noise
    floor), and the planted fault (a row-parallel weight quantized from
    its own block of K) fails the grid gate: its rows take their own
    scales."""
    cs, results, _ = phase18
    for r in results["mesh_configs_path"]["ranks"]:
        c = r["c"]
        assert c["passed"] and c["failed"] == []
        assert not c["fault_passed"] and "grid" in c["fault_failed"]
        assert c["tp"]["rest"] == 0.0 < c["fault"]["rest"]
        assert c["tp"]["total"] == c["fault"]["total"] > 0
    assert "phase18bc_s" in results


def test_p18_gptq_limits_take_the_looser_bound():
    """JAX's tolerances (1e-3 of the codes a step apart, the rest within
    1e-3 of a step, the output error within 1%) unless four times the
    noise floor is looser; each gate named when it fails."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    quiet = dict(share=0.0, rest=0.0, out_rel=0.0)
    assert cs._p18_gptq_limits(dict(share=1e-3, rest=0.0, out_rel=0.01),
                               quiet) == (1e-3, 1e-3, 1e-2, [])
    assert cs._p18_gptq_limits(dict(share=2e-3, rest=2e-3, out_rel=0.02),
                               quiet)[3] == ["share", "grid", "output"]
    loud = dict(share=1e-3, rest=5e-4, out_rel=5e-3)
    assert cs._p18_gptq_limits(dict(share=3e-3, rest=2e-3, out_rel=0.02),
                               loud) == (4e-3, 2e-3, 2e-2, [])
    assert cs._p18_gptq_limits(dict(share=3e-3, rest=3e-3, out_rel=0.0),
                               loud)[3] == ["grid"]
