"""Zero-shot QA evaluation, the lm-eval integration (port of
flatquant_tpu/evals/tasks.py).

Batched (context, continuation) loglikelihood on both paths:

  - fake-quant: llama_forward(mode="fp" / "eval") on baked params
  - real-quant: serving_all_logits over packed int4 weights (pass
    serving_params=...; with use_kernel on a card it launches the serving
    kernels)

generation (`generate_until`) through the continuous batcher, and an
`lm_eval.api.model.LM` adapter when the lm-eval package and its task data
are there (it raises a clear ImportError where they are not). There is
no jit: every forward runs eagerly under torch.no_grad(), on the device
that holds the model.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.models.llama import llama_forward


def _make_forward(cfg, params, fq, fq_cfg, mode, serving_params, use_kernel,
                  compute_dtype, dev):
    """tokens [B, S] -> float32 logits [B, S, V] on the selected path."""
    if serving_params is not None:
        from flatquant_torch.serving.engine import serving_all_logits

        def fwd(toks):
            return serving_all_logits(cfg, fq_cfg, serving_params, toks,
                                      use_kernel=use_kernel,
                                      compute_dtype=compute_dtype,
                                      device=dev)
    else:
        def fwd(toks):
            return llama_forward(cfg, params, toks, fq=fq, fq_cfg=fq_cfg,
                                 mode=mode, compute_dtype=compute_dtype)
    return fwd


@torch.no_grad()
def batched_loglikelihood(
    cfg: LlamaConfig,
    params,
    fq,
    fq_cfg,
    mode: str,
    pairs: Sequence[Tuple[List[int], List[int]]],
    batch_size: int = 8,
    max_len: Optional[int] = None,
    compute_dtype=torch.bfloat16,
    serving_params: Optional[dict] = None,
    use_kernel: bool = False,
) -> List[Tuple[float, bool]]:
    """For each (context_tokens, continuation_tokens): (sum of the
    continuation's log-probabilities, whether it is the greedy
    continuation), the lm-eval loglikelihood contract. Every batch is
    padded to max_len (default cfg.seqlen); the log-softmax runs on the
    scored rows only. With serving_params the scores come from the
    real-quant serving stack."""
    max_len = max_len or cfg.seqlen
    dev = (serving_params if serving_params is not None
           else params)["embed"].device
    fwd = _make_forward(cfg, params, fq, fq_cfg, mode, serving_params,
                        use_kernel, compute_dtype, dev)
    results = []
    for i in range(0, len(pairs), batch_size):
        chunk = pairs[i:i + batch_size]
        toks = np.zeros((len(chunk), max_len), np.int32)
        meta = []
        for j, (ctx, cont) in enumerate(chunk):
            ctx, cont = list(ctx), list(cont)
            if not ctx:
                # lm-eval can issue empty-context requests: score from a
                # BOS-like token, so logits[start - 1] never wraps around
                ctx = [0]
            seq = (ctx + cont)[-max_len:]
            start = len(seq) - len(cont)
            if start < 1:
                raise ValueError(
                    f"continuation of {len(cont)} tokens leaves no context "
                    f"within max_len={max_len}; raise max_len")
            toks[j, :len(seq)] = seq
            meta.append((start, len(seq)))
        logits = fwd(toks)
        toks_dev = torch.as_tensor(toks, device=dev).to(torch.long)
        for j, (start, end) in enumerate(meta):
            lp = torch.log_softmax(logits[j, start - 1:end - 1], dim=-1)
            cont = toks_dev[j, start:end]
            token_lp = lp.gather(-1, cont[:, None])[:, 0]
            greedy = bool((lp.argmax(dim=-1) == cont).all())
            results.append((float(token_lp.sum()), greedy))
    return results


def batched_generate(
    cfg: LlamaConfig,
    fq_cfg,
    serving_params: dict,
    prompts: Sequence[List[int]],
    max_new_tokens: int = 32,
    max_len: Optional[int] = None,
    use_kernel: bool = False,
    eos_id: Optional[int] = None,
    stop_token_sets: Optional[Sequence[Sequence[int]]] = None,
) -> List[List[int]]:
    """Greedy generation for token prompts through the continuous batcher
    (the generate_until capability), with JAX's arguments: min(4, n)
    slots, float32 compute, prefill buckets of 16, the default cache. Each
    output is cut before the first occurrence of any of its stop
    sequences."""
    from flatquant_torch.serving.batcher import ContinuousBatcher

    batcher = ContinuousBatcher(
        cfg, fq_cfg, serving_params, batch_slots=min(4, max(1, len(prompts))),
        max_len=max_len or cfg.seqlen, use_kernel=use_kernel,
        compute_dtype=torch.float32, prefill_bucket=16,
        device=serving_params["embed"].device)
    rids = [batcher.submit(np.asarray(p, np.int32), max_new_tokens,
                           eos_id=eos_id) for p in prompts]
    done = batcher.run()
    outs = [done[r] for r in rids]
    if stop_token_sets:
        trimmed = []
        for toks, stops in zip(outs, stop_token_sets):
            cut = len(toks)
            for s in stops or ():
                s = list(s)
                for k in range(len(toks) - len(s) + 1):
                    if toks[k:k + len(s)] == s:
                        cut = min(cut, k)
                        break
            trimmed.append(toks[:cut])
        outs = trimmed
    return outs


def make_lm_eval_adapter(cfg, params, fq, fq_cfg, mode, tokenizer,
                         batch_size=8, serving_params=None, use_kernel=False,
                         max_gen_tokens=64):
    """An lm_eval LM adapter over the model (needs the lm-eval package)."""
    try:
        from lm_eval.api.model import LM
    except ImportError as e:
        raise ImportError(
            "lm-eval is not installed in this environment; "
            "batched_loglikelihood()/batched_generate() provide the same "
            "capability for custom task data") from e

    class FlatQuantLM(LM):
        def __init__(self):
            super().__init__()
            self.tokenizer = tokenizer

        def _encode_pair(self, context: str, continuation: str):
            whole = self.tokenizer.encode(context + continuation)
            ctx = self.tokenizer.encode(context)
            return ctx, whole[len(ctx):]

        def loglikelihood(self, requests):
            pairs = [self._encode_pair(r.args[0], r.args[1])
                     for r in requests]
            return batched_loglikelihood(
                cfg, params, fq, fq_cfg, mode, pairs, batch_size=batch_size,
                serving_params=serving_params, use_kernel=use_kernel)

        def loglikelihood_rolling(self, requests):
            out = []
            for r in requests:
                toks = self.tokenizer.encode(r.args[0])
                res = batched_loglikelihood(
                    cfg, params, fq, fq_cfg, mode, [([toks[0]], toks[1:])],
                    batch_size=1, serving_params=serving_params,
                    use_kernel=use_kernel)
                out.append((res[0][0],))
            return out

        def generate_until(self, requests):
            if serving_params is None:
                raise ValueError(
                    "generate_until needs serving_params (the packed "
                    "serving model drives generation)")
            prompts, stop_sets, gen_lens = [], [], []
            for r in requests:
                ctx, gen_kwargs = r.args[0], (r.args[1] or {})
                prompts.append(self.tokenizer.encode(ctx))
                stops = gen_kwargs.get("until") or []
                stop_sets.append([self.tokenizer.encode(s) for s in stops])
                gen_lens.append(gen_kwargs.get("max_gen_toks",
                                               max_gen_tokens))
            eos = getattr(self.tokenizer, "eos_token_id", None)
            outs = batched_generate(
                cfg, fq_cfg, serving_params, prompts,
                max_new_tokens=max(gen_lens), use_kernel=use_kernel,
                eos_id=eos, stop_token_sets=stop_sets)
            # one batched run at the longest request's budget, each
            # request then cut to its own max_gen_toks
            outs = [t[:n] for t, n in zip(outs, gen_lens)]
            return [self.tokenizer.decode(t) for t in outs]

    return FlatQuantLM()


def run_lm_eval(cfg, params, fq, fq_cfg, tasks, tokenizer, batch_size=8,
                log: Callable[[str], None] = print, serving_params=None,
                use_kernel=False):
    """lm_eval.simple_evaluate over the model (needs lm-eval and its task
    data); serving_params routes everything through the real-quant
    stack."""
    import lm_eval

    mode = "eval" if fq is not None else "fp"
    lm = make_lm_eval_adapter(cfg, params, fq, fq_cfg, mode, tokenizer,
                              batch_size, serving_params, use_kernel)
    results = lm_eval.simple_evaluate(model=lm, tasks=list(tasks))
    summary = {t: results["results"][t] for t in tasks
               if t in results.get("results", {})}
    log(f"lm-eval results: {summary}")
    return summary
