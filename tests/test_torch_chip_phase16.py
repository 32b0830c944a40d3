"""chip_smoke.py phase 16 (parallel serving) rehearsed on the CPU: the
parent's build and single-device references, the slices it hands each
rank, the rank launch glue (two spawned gloo ranks) and the five runs of
every rank (tp = 2, the batcher under tp and pp, sp = 2, DeepSeek under
ep = 2), at small widths (hidden 256, 2 layers, 2 heads of 128; DeepSeek
dim 256 with 8 experts). On the CPU the wrappers run the plain versions
and launch no kernel, so the launch counts are empty; the checked
wrappers still count every call they hold to its plain version, and the
phase's own checks (pp and ep tokens equal to the single-device
batchers', the paged pool's equal to the slot cache's under tp, the sp
handoff's layer 0 bit-equal to the single device's, every ring attention
held to a dense causal softmax, the logits tripwires, each rank's
experts) run as on the card.
"""

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def phase16():
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from flatquant_torch.models.config import LlamaConfig
    from flatquant_torch.models.deepseek import DeepSeekConfig

    cfg = LlamaConfig(name="p16-small", vocab_size=256, hidden_size=256,
                      intermediate_size=512, num_layers=2, num_heads=2,
                      num_kv_heads=2)
    ds_cfg = DeepSeekConfig(dim=256, inter_dim=320, moe_inter_dim=256,
                            n_heads=2, n_routed_experts=8,
                            n_activated_experts=2, kv_lora_rank=128,
                            vocab_size=256, n_layers=2)
    sizes = dict(S=1024, new=3, sp_new=3, max_len=1040, batch_max_len=256,
                 requests=((40, 4), (70, 3), (20, 4), (130, 2), (50, 3)),
                 ds_requests=((30, 3), (60, 3), (20, 3), (40, 3)))
    mp = pytest.MonkeyPatch()
    try:
        for name in ("synchronize", "empty_cache"):
            mp.setattr(torch.cuda, name, lambda *a: None)
        mp.setattr(torch.cuda, "memory_allocated", lambda *a: 0)
        results = {}
        paths = cs.run_parallel_path(torch, torch.device("cpu"), results,
                                     "cpu", cfg=cfg, ds_cfg=ds_cfg,
                                     sizes=sizes)
    finally:
        mp.undo()
    return cs, cfg, ds_cfg, sizes, results["parallel_path"], paths


def test_phase16_ranks_talk_over_gloo(phase16):
    """Two ranks, each on the CPU here (on one card: both on cuda:0), over
    gloo; every rank's collectives counted by transport."""
    cs, _, _, _, rec, paths = phase16
    assert rec["backend"] == "gloo" and rec["devices"] == ["cpu", "cpu"]
    assert len(rec["ranks"]) == cs.P16_WORLD
    for r in rec["ranks"]:
        assert set(r["transport"]) == {"gloo"} and r["transport"]["gloo"] > 0
    assert set(paths) == {"tp_prefill", "tp_decode", "tp_batcher",
                          "pp_batcher", "sp_prefill", "ep_batcher"}


def test_phase16_tp_checks_every_launch(phase16):
    """(a): every call of a prefill and two decode steps held to its plain
    version, counted by row as P16_TP_PREFILL / P16_TP_STEP give them
    per layer (rows 1, 13, 15; rows 1, 2, 3)."""
    cs, cfg, _, _, rec, _ = phase16
    L = cfg.num_layers
    for r in rec["ranks"]:
        chk = r["a"]["checked"]
        assert chk["prefill"] == {cs.ROW_OF[k]: v * L for k, v in
                                  cs.P16_TP_PREFILL.items()}
        assert chk["steps"] == {cs.ROW_OF[k]: v * L * 2 for k, v in
                                cs.P16_TP_STEP.items()}


def test_phase16_pp_and_sp_equal_single_device(phase16):
    """(c): the pp = 2 batcher's tokens are the single-device batcher's;
    (d): the sp = 2 prefill's continuation is the single-device bf16
    one's (here on the plain versions; on the card a tripwire)."""
    _, _, _, sizes, rec, _ = phase16
    for r in rec["ranks"]:
        assert r["c_pp_int4"]["tokens"] == rec["reference"]["batcher_tokens"]
        assert r["b_paged"]["tokens"] == r["b_int4"]["tokens"]
        assert r["d"]["tokens"] == rec["reference"]["bf16_tokens"]
        assert len(r["d"]["tokens"]) == sizes["sp_new"]


def test_phase16_ep_splits_the_experts(phase16):
    """(e): each rank holds half the routed experts and every row-1 call of
    the checked prefill was held to its plain version."""
    _, _, ds_cfg, _, rec, _ = phase16
    for r in rec["ranks"]:
        assert r["e"]["experts"] == ds_cfg.n_routed_experts // 2
        assert r["e"]["checked_w4a4"] > 0


def test_phase16_batchers_check_every_call(phase16):
    """(b), (c): each batcher ran a second time with every call held to its
    plain version, its tokens unchanged: the GEMMs, the decode attention
    and writes of the slot cache, the paged decode attention of the
    pool; the GEMMs and writes bit-exact."""
    cs, _, _, _, rec, _ = phase16
    for r in rec["ranks"]:
        for name, attn in (("b_int4", {2, 3}), ("b_paged", {10}),
                           ("c_pp_int4", {2, 3})):
            chk = r[name]["checked"]
            assert chk.get(1, 0) > 0 and attn <= set(chk), (name, chk)
            err = r[name]["max_abs_err"]
            assert err["w4a4_matmul_i8"] == 0.0
            assert err.get("write_token", 0.0) == 0.0


def test_phase16_sp_handoff_and_ring_are_gated(phase16):
    """(d): the handoff cache's layer-0 K / V are bit-equal to the
    single-device prefill's, and the checked prefill held every layer's
    ring attention to the dense causal softmax and every GEMM to its
    plain version."""
    _, cfg, _, _, rec, _ = phase16
    for r in rec["ranks"]:
        assert all(x["equal"] and x["max_abs"] == 0.0
                   for x in r["d"]["kv0"].values())
        chk = r["d"]["checked"]
        assert chk["prefill"]["ring_attention"] == cfg.num_layers
        assert chk["prefill"][1] > 0 and chk["steps"][1] > 0


def test_phase16_ep_tokens_equal_single_device(phase16):
    """(e): the ep = 2 batcher's greedy tokens are the single-device
    batcher's."""
    _, _, _, _, rec, _ = phase16
    for r in rec["ranks"]:
        assert r["e"]["tokens"] == rec["reference"]["ds_batcher_tokens"]


def _ring_inputs(seed=0, S=64, nh=4, nkv=2, hd=16):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(1, S, nh, hd, generator=g).to(torch.bfloat16)
    k = torch.randn(1, S, nkv, hd, generator=g).to(torch.bfloat16)
    v = torch.randn(1, S, nkv, hd, generator=g).to(torch.bfloat16)
    return q, k, v


def test_checked_ring_passes_the_ring_and_fails_without_its_mask():
    """_checked_ring (phase 16 (d)) on one rank: the ring attention holds
    to the dense causal softmax; a ring without its causal mask fails."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from flatquant_torch.parallel import sequence
    from flatquant_torch.parallel.mesh import Axis

    axis = Axis("sp", 1, 0, (0,))
    q, k, v = _ring_inputs()
    n = dict.fromkeys(cs.P16_CHECKED, 0)
    worst = dict.fromkeys(cs.P16_CHECKED, 0.0)
    with cs.patched(cs._checked_ring(torch, n, worst)):
        sequence.ring_attention(q, k, v, 0.25, axis)
    assert n["ring_attention"] == 1

    def unmasked(q, k, v, sm_scale, axis):
        kf = k.repeat_interleave(2, dim=2).float()
        vf = v.repeat_interleave(2, dim=2).float()
        p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk",
                                       q.float() * sm_scale, kf), -1)
        return torch.einsum("bhqk,bkhd->bqhd", p, vf).to(q.dtype)

    saved = sequence.ring_attention
    sequence.ring_attention = unmasked
    try:
        with cs.patched(cs._checked_ring(torch, n, worst)):
            with pytest.raises(AssertionError, match="ring_attention"):
                sequence.ring_attention(q, k, v, 0.25, axis)
    finally:
        sequence.ring_attention = saved


def test_p16_transport_follows_backend_for(monkeypatch):
    """The phase's ranks: on the CPU every rank on the CPU over gloo; on
    one card both on cuda:0 over gloo; with a card per rank, one rank a
    card over NCCL (distributed.backend_for decides)."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    assert cs.p16_transport(torch, "cpu", 2) == ("gloo", ["cpu", "cpu"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cs.p16_transport(torch, "cuda", 2) == ("gloo",
                                                  ["cuda:0", "cuda:0"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert cs.p16_transport(torch, "cuda", 2) == ("nccl",
                                                  ["cuda:0", "cuda:1"])


def test_p16_same_fails_an_unchecked_launch_on_the_card():
    """_p16_same: on the card a checked run must hold as many launches by
    row as its timed run made; on the CPU (no launch counted) it passes."""
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    cs._p16_same(torch, "cuda", {1: 4, "ring_attention": 2}, {1: 4}, "x")
    with pytest.raises(AssertionError, match="launches checked"):
        cs._p16_same(torch, "cuda", {1: 4}, {1: 4, 2: 1}, "x")
    cs._p16_same(torch, "cpu", {1: 4}, {}, "x")
