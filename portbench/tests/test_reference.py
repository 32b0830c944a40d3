"""At tiny widths on the CPU the plain float32 reference agrees with the
port's plain versions (use_kernel=False, float32 compute, the transforms
served in float32), step for step: prefill, then decode through the
cache."""

import numpy as np
import torch

from portbench.harness import catalog, check, serve
from portbench.reference.common import identity

DEV = torch.device("cpu")


def _greedy(step, S, n):
    """Logits rows of a prefill and n - 1 decode steps, feeding argmax."""
    rows = [step(None, 0)]
    for i in range(n - 1):
        rows.append(step(int(rows[-1].argmax()), S + i))
    return torch.stack(rows)


def _compare(cfg, seed, prompt, prog):
    served = prog.argmax(-1).numpy().astype(np.int32)
    seq = np.concatenate([prompt, served[:-1]])
    ref = catalog.load_module("reference", cfg["family"])
    r = ref.logits(cfg, seed, [(seq, len(prompt))], DEV, rnd=identity)[0]
    assert torch.allclose(prog, r, atol=1e-5 * float(r.abs().max())), \
        float((prog - r).abs().max())


def test_llama_family_agrees_with_the_plain_port():
    from flatquant_torch.serving import engine

    torch.set_num_threads(2)
    cell = catalog.cell("tiny-qwen.prefill-heavy")
    cfg = cell["cfg"]
    fam = catalog.load_module("families", "llama")
    for seed in (1, 2):
        m = fam.build(cfg, seed, DEV, torch.float32)
        prompt = np.random.default_rng(seed).integers(
            0, cfg["vocab_size"], 37).astype(np.int32)
        cache = engine.init_cache(m["cfg"], 1, 128, mode="int4", device=DEV)

        def step(tok, pos):
            if tok is None:
                lg, _ = engine.serving_prefill(
                    m["cfg"], m["fq"], m["sp"],
                    torch.as_tensor(prompt[None]).long(), cache, False, 128,
                    torch.float32, DEV)
            else:
                lg, _ = engine.serving_decode_step(
                    m["cfg"], m["fq"], m["sp"], torch.tensor([[tok]]), cache,
                    pos, False, 128, torch.float32, DEV)
            return lg[0]

        _compare(cfg, seed, prompt, _greedy(step, len(prompt), 6))


def test_deepseek_family_agrees_with_the_plain_port():
    from flatquant_torch.models import deepseek as ds

    torch.set_num_threads(2)
    cell = catalog.cell("tiny-deepseek.chat")
    cfg = cell["cfg"]
    fam = catalog.load_module("families", "deepseek")
    for seed in (1, 2):
        m = fam.build(cfg, seed, DEV)
        prompt = np.random.default_rng(seed).integers(
            0, cfg["vocab_size"], 29).astype(np.int32)
        cache = ds.ds_init_batch_cache(m["cfg"], 1, 128,
                                       dtype=torch.float32, device=DEV)

        def step(tok, pos):
            toks = prompt[None] if tok is None else np.array([[tok]])
            return ds.ds_batch_forward(
                m["cfg"], m["fq"], m["sp"], torch.as_tensor(toks).long(),
                cache, pos, "prefill" if tok is None else "decode", False,
                128, torch.float32)[0]

        _compare(cfg, seed, prompt, _greedy(step, len(prompt), 6))


def test_batcher_in_float32_serves_the_references_tokens():
    """Through the batcher (paged int4 cache, bucketed prefills, four
    slots) in float32, every served token is the reference's best."""
    torch.set_num_threads(2)
    cell = catalog.cell("tiny-qwen.prefill-heavy")
    cfg = cell["cfg"]
    fam = catalog.load_module("families", "llama")
    ref = catalog.load_module("reference", "llama")
    m = fam.build(cfg, 3, DEV, torch.float32)
    b = fam.batcher(m, cell["batcher"], DEV)
    b.compute_dtype = torch.float32
    t = catalog.load_module("traffic", "closed_loop").Traffic(
        cell["traffic"], 3, cfg["vocab_size"])
    win = serve.window(b, t, serve.fill(b, t), 0.5)
    picks = check.sample(win["done"], 3, 30)
    lg = ref.logits(cfg, 3, check.sequences(picks), DEV)
    g = check.gaps(lg, [r.req.out_tokens for r in picks])
    assert g.size >= 20 and g.max() == 0.0
