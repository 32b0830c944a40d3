"""Perplexity evaluation (port of flatquant_tpu/evals/ppl.py).

Parity target: flatquant/eval_utils.py:4-30 — stride-seqlen NLL over the
concatenated test stream: split into floor(N / seqlen) chunks, mean NLL
per chunk times seqlen summed in chunk order, ppl = exp(total / (nchunks
* seqlen)). One chunk per forward, as JAX's loop.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.models.llama import llama_forward


def chunk_nll(logits, chunk) -> float:
    """Mean next-token NLL of chunk [1, S] from its logits [1, S, V]."""
    logp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    tgt = chunk[:, 1:].to(torch.long)
    return float(-torch.gather(logp, -1, tgt[..., None]).mean())


@torch.no_grad()
def stream_ppl(forward, test_tokens: np.ndarray, seqlen: int,
               device) -> float:
    """Perplexity of the stream [1, N] at stride seqlen, forward(chunk
    [1, seqlen]) -> logits [1, seqlen, V]."""
    n = test_tokens.shape[1] // seqlen
    if n <= 0:
        raise ValueError("test stream shorter than one seqlen chunk")
    tokens = torch.as_tensor(np.asarray(test_tokens)[:, :n * seqlen],
                             device=device).long()
    total = 0.0
    for i in range(n):
        chunk = tokens[:, i * seqlen:(i + 1) * seqlen]
        total += chunk_nll(forward(chunk), chunk) * seqlen
    return float(np.exp(total / (n * seqlen)))


@torch.no_grad()
def ppl_eval(cfg: LlamaConfig, params, test_tokens: np.ndarray, fq=None,
             fq_cfg=None, mode: str = "fp", seqlen: Optional[int] = None,
             compute_dtype=torch.bfloat16) -> float:
    """Perplexity of the concatenated stream [1, N] at stride seqlen, on
    the device that holds params."""
    def forward(chunk):
        return llama_forward(cfg, params, chunk, fq=fq, fq_cfg=fq_cfg,
                             mode=mode, compute_dtype=compute_dtype)

    return stream_ppl(forward, test_tokens, seqlen or cfg.seqlen,
                      params["embed"].device)
