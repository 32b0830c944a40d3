"""Continuous batching over the quantized serving engine (port of
flatquant_tpu/serving/batcher.py).

  - a fixed pool of B batch slots shares one KV cache (bf16, int4 slot
    cache, or the paged block pool)
  - every decode step advances ALL slots in one `_forward` call with a
    per-slot position vector
  - when a slot finishes (EOS / max_new_tokens) the next queued request
    is prefilled into it, whole, bucketed, or chunk by chunk with decode
    steps in between, while other slots' state is untouched

Greedy results equal single-request generation, and the paged pool's
equal the int4 slot cache's token for token. The engine hooks
`forward_fn` / `init_cache_fn` serve another model family through the
same scheduler (models/deepseek.py ds_batch_forward and
ds_init_batch_cache: DeepSeek over its latent caches; under expert
parallelism the bundle of parallel/mesh.py `shard_ds_serving_params`).
`mesh` runs every call tensor-parallel (parallel/serving_tp.py) and
`pp_mesh` pipelines the layers over stages (parallel/pipeline.py): each
rank runs this same scheduler on the same requests with its own shard of
the weights and the cache, and gets the full logits back, so every rank
takes the same tokens.

What differs from JAX: there is no jit and no program cache. Prefill,
decode and chunk are direct calls of the forward function, and every
cache updates in place where JAX donates it (a hook's forward returns
only the logits, as `_forward` does).

Tracing (utils/tracing.py, off by default): `step` is the root span,
with `admit`, a `queued` span per admitted request (submit -> admission,
`rid`), the model calls `prefill`, `chunk` and `decode` (attributes
`rids`, `rows_true`, `rows_computed`, `start`), `seat`, `first_token`
and `sample`; counters `prefill.rows_true` / `prefill.rows_computed`
(prefill and chunk calls, padding in computed), `decode.calls`,
`decode.slot_rows` and `pool.deferred` (an admission stopped because
the paged reservation does not fit). Every site where the host waits for
the device is a `sync` span: the H2D copies of tokens, last_idx, the
decode positions and the block table (pageable numpy, not
non-blocking), and the D2H reads of the first token and of the decode
argmax. Each request is stamped with its submit time (one clock read a
request) whether or not tracing is on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from flatquant_torch.kernels.common import resolve_device
from flatquant_torch.models.config import LlamaConfig
from flatquant_torch.quantize.spec import FQConfig
from flatquant_torch.serving.engine import _forward, init_cache
from flatquant_torch.serving.paged import BlockAllocator, blocks_needed
from flatquant_torch.utils import tracing


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    out_tokens: Optional[List[int]] = None
    submit_t: float = 0.0  # tracing.now() at submit


class ContinuousBatcher:
    def __init__(
        self,
        cfg: LlamaConfig,
        fq_cfg: FQConfig,
        serving_params: dict,
        batch_slots: int = 4,
        max_len: int = 2048,
        use_kernel: bool = False,
        compute_dtype=torch.float32,
        cache_mode: str = "bf16",
        prefill_bucket: int = 0,
        prefill_chunk: int = 0,
        mesh=None,
        tp_axis: str = "tp",
        n_blocks: int = 0,
        block_size: int = 256,
        forward_fn=None,
        init_cache_fn=None,
        pp_mesh=None,
        pp_microbatches: int = 2,
        device="cuda",
    ):
        """cache_mode: "bf16" (dequantized values), "int4" (the packed slot
        cache; per-slot positions feed the decode kernel's valid_len) or
        "paged" (the block pool: n_blocks sizes it, by default HALF the
        slots x max_len worst case plus the trash block; admission defers
        a request until its reservation of ceil((S + max_new) /
        block_size) blocks fits). prefill_bucket > 0 pads each prompt up
        to a multiple of the bucket (pad rows write cache entries past the
        true length, which decode overwrites before valid_len covers
        them). prefill_chunk > 0 prefills a prompt `prefill_chunk` tokens
        per step, active slots decoding one token between chunks; chunk
        attention reads the quantized cache for history (decode
        semantics).

        use_kernel defaults to False, as JAX's batcher does: the same
        call takes the same route in both packages (the composed chain at
        every row count). use_kernel=True runs the fused routes and
        launches every kernel of the path on a CUDA device; CPU tensors
        run the plain versions either way. device: where the cache and
        the calls run (default "cuda"; a host without a card raises).

        forward_fn / init_cache_fn: engine hooks with the signatures of
        engine._forward and engine.init_cache (cache updated in place,
        the forward returning the logits), e.g. ds_batch_forward and
        ds_init_batch_cache for DeepSeek; they run the bf16-cache
        scheduler only.

        mesh: a parallel/mesh.py Mesh with a `tp_axis` axis runs every
        call tensor-parallel (serving_params: build_serving_params(tp=tp)
        from shard-aligned transforms, or this rank's slice of it from
        serving_tp.shard_serving_params); the cache holds the rank's kv
        heads. pp_mesh: a Mesh with a "pp" axis pipelines the layers
        (serving_params: all layers or this stage's,
        pipeline.stage_serving_params); the cache holds the stage's
        layers, decode runs pp_microbatches microbatches, a prefill or
        chunk one. Greedy outputs equal the unsharded batcher's (pp: the
        same numbers; tp: up to the order of the partial sums)."""
        if mesh is not None and pp_mesh is not None:
            raise ValueError("mesh (tp) and pp_mesh are separate program "
                             "sets, as in JAX")
        if forward_fn is not None and cache_mode != "bf16":
            raise ValueError("engine hooks run the bf16-cache scheduler; "
                             f"cache_mode {cache_mode!r} is the Llama "
                             "engine's")
        if forward_fn is not None and (mesh is not None
                                       or pp_mesh is not None):
            raise ValueError("engine hooks run the plain scheduler; tp and "
                             "pp run the Llama engine's layers")
        self._forward = forward_fn if forward_fn is not None else _forward
        self._init_cache = (init_cache_fn if init_cache_fn is not None
                            else init_cache)
        self.cfg = cfg
        self.fq_cfg = fq_cfg
        self.sp = serving_params
        self._cache_cfg = cfg
        if mesh is not None:
            from flatquant_torch.parallel import serving_tp as stp

            self.sp = stp.shard_serving_params(serving_params, mesh,
                                               tp_axis)
            self._cache_cfg = stp.tp_local_config(cfg, mesh.shape[tp_axis])
            self._forward = stp.tp_forward(cfg, mesh, tp_axis)
        elif pp_mesh is not None:
            from flatquant_torch.parallel import pipeline as pl

            if batch_slots % pp_microbatches:
                raise ValueError(f"batch_slots {batch_slots} % "
                                 f"pp_microbatches {pp_microbatches} != 0")
            self.sp = pl.stage_serving_params(serving_params, pp_mesh)
            self._cache_cfg = pl.stage_config(cfg, pp_mesh)
            self._forward = pl.pipeline_forward_fn(pp_mesh, pp_microbatches)
        self.B = batch_slots
        self.max_len = max_len
        self.use_kernel = use_kernel
        self.compute_dtype = compute_dtype
        self.cache_mode = cache_mode
        self.prefill_bucket = prefill_bucket
        self.prefill_chunk = prefill_chunk
        if prefill_chunk > 0:
            # chunk-multiple padding must never extend past the cache
            assert max_len % prefill_chunk == 0, (max_len, prefill_chunk)
        self.pending = None  # in-flight chunked prefill state
        self.block_size = block_size
        self.dev = resolve_device(device)
        if cache_mode == "paged":
            self._mb = -(-max_len // block_size)
            if n_blocks <= 0:
                n_blocks = 1 + max(1, (batch_slots * self._mb + 1) // 2)
            pool = init_cache(self._cache_cfg, batch_slots, max_len,
                              mode="paged",
                              n_blocks=n_blocks, block_size=block_size,
                              device=self.dev)
            pool.pop("tbl")  # the batcher manages tables host-side
            self.cache = pool
            self.alloc = BlockAllocator(n_blocks)
            self.tbl = np.zeros((batch_slots, self._mb), np.int32)
            self.slot_blocks = [[] for _ in range(batch_slots)]
        else:
            self.cache = self._new_cache(batch_slots)
        self.pos = np.zeros(batch_slots, np.int32)  # current length per slot
        self.remaining = np.zeros(batch_slots, np.int32)
        self.slot_req: List[Optional[Request]] = [None] * batch_slots
        self.next_tok = np.zeros((batch_slots, 1), np.int32)
        self.queue: List[Request] = []
        self.finished: Dict[int, List[int]] = {}
        self._rid = 0

    # -- public API ---------------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               eos_id=None) -> int:
        rid = self._rid
        self._rid += 1
        self.queue.append(Request(rid, np.asarray(prompt, np.int32),
                                  max_new_tokens, eos_id, [],
                                  tracing.now()))
        return rid

    @property
    def idle(self) -> bool:
        return (not self.queue and self.pending is None
                and all(r is None for r in self.slot_req))

    def run(self, max_steps: int = 10**6) -> Dict[int, List[int]]:
        steps = 0
        while not self.idle and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    # -- the three programs -------------------------------------------------

    @torch.no_grad()
    def _call(self, tokens, cache, pos, phase, last_idx=None):
        with tracing.sync("h2d.tokens"):
            tokens = torch.as_tensor(tokens, device=self.dev).to(torch.long)
        if last_idx is not None:
            with tracing.sync("h2d.last_idx"):
                last_idx = torch.as_tensor(last_idx, device=self.dev)
        return self._forward(self.cfg, self.fq_cfg, self.sp, tokens, cache,
                             pos, phase, self.use_kernel, self.max_len,
                             self.compute_dtype, last_idx=last_idx)

    def _prefill_one(self, tokens, cache1, last_idx):
        return self._call(tokens, cache1, 0, "prefill", last_idx)

    def _decode_multi(self, toks, cache, pos_vec):
        with tracing.sync("h2d.pos"):
            # a copy of the host's
            pos = torch.tensor(pos_vec, device=self.dev)
        return self._call(toks, cache, pos, "decode")

    def _chunk_one(self, tokens, cache1, pos, last_idx):
        return self._call(tokens, cache1, int(pos), "chunk", last_idx)

    # -- internals ----------------------------------------------------------

    def _new_cache(self, batch):
        return self._init_cache(self._cache_cfg, batch, self.max_len,
                                dtype=self.compute_dtype,
                                mode=self.cache_mode, device=self.dev)

    def _new_cache1(self):
        """A zeroed single-slot staging cache for one prefill."""
        return self._new_cache(1)

    def _paged_cache(self, tbl):
        """The pool with a device copy of a host block table."""
        with tracing.sync("h2d.tbl"):
            return dict(self.cache,
                        tbl=torch.as_tensor(tbl, device=self.dev))

    def _seat(self, slot, cache1):
        """Copy a staging cache's whole row into the slot, in place (stale
        entries of the slot's last request are cleared with it)."""
        with tracing.span("seat"):
            for key, layers in self.cache.items():
                for dst, src in zip(layers, cache1[key]):
                    dst[slot].copy_(src[0])

    def _reserve(self, slot, req):
        """Paged: allocate the request's reservation and point the slot's
        table at it (entries past it at the trash block 0)."""
        need = blocks_needed(len(req.prompt), req.max_new_tokens,
                             self.block_size)
        blocks = self.alloc.alloc(need)
        assert blocks is not None, "admission checked the reservation"
        self.slot_blocks[slot] = blocks
        self.tbl[slot, :] = 0
        self.tbl[slot, :need] = blocks

    def _admit(self):
        pending_slot = self.pending["slot"] if self.pending else None
        for slot in range(self.B):
            if slot == pending_slot or self.slot_req[slot] is not None:
                continue
            if not self.queue:
                break
            if self.cache_mode == "paged":
                need = blocks_needed(len(self.queue[0].prompt),
                                     self.queue[0].max_new_tokens,
                                     self.block_size)
                if need > self.alloc.free_count:
                    tracing.count("pool.deferred")
                    break  # FIFO: wait until the reservation fits
            if self.prefill_chunk > 0:
                if self.pending is not None:
                    break  # one in-flight chunked prefill at a time
                self._start_pending(slot, self._dequeue())
                pending_slot = slot
            else:
                self._prefill_into_slot(slot, self._dequeue())

    def _dequeue(self) -> Request:
        """The queue's head, admitted now (its `queued` span)."""
        req = self.queue.pop(0)
        if tracing.ON:
            tracing.record("queued", req.submit_t, tracing.now(), rid=req.rid)
        return req

    @staticmethod
    def _prefill_counts(rows_true, rows_computed):
        tracing.count("prefill.rows_true", rows_true)
        tracing.count("prefill.rows_computed", rows_computed)

    def _start_pending(self, slot: int, req: Request):
        S = len(req.prompt)
        assert S + req.max_new_tokens <= self.max_len
        C = self.prefill_chunk
        S_pad = min(-(-S // C) * C, self.max_len)
        toks = np.pad(req.prompt, (0, S_pad - S))
        if self.cache_mode == "paged":
            # chunks write straight into the pool through this slot's
            # table; padding past the reservation lands in the trash block
            self._reserve(slot, req)
            cache1 = None
        else:
            cache1 = self._new_cache1()
        self.pending = {"slot": slot, "req": req, "toks": toks, "S": S,
                        "cache1": cache1, "ci": 0, "n": S_pad // C}

    def _advance_pending(self):
        """Run ONE chunk of the in-flight prefill (decode interleaves
        between calls)."""
        p = self.pending
        C = self.prefill_chunk
        start = p["ci"] * C
        chunk = p["toks"][start:start + C]
        final = p["ci"] == p["n"] - 1
        last = (p["S"] - 1 - start) if final else (C - 1)
        slot = p["slot"]
        attrs = {}
        if tracing.ON:
            rows = min(C, p["S"] - start)
            attrs = dict(rids=[p["req"].rid], rows_true=rows,
                         rows_computed=C, start=start)
            self._prefill_counts(rows, C)
        with tracing.span("chunk", **attrs):
            if self.cache_mode == "paged":
                cache = self._paged_cache(self.tbl[slot:slot + 1])
            else:
                cache = p["cache1"]
            logits = self._chunk_one(chunk[None, :], cache, start, [last])
        p["ci"] += 1
        if not final:
            return
        req, S = p["req"], p["S"]
        if self.cache_mode != "paged":
            self._seat(slot, p["cache1"])
        self._activate(slot, req, S, logits)
        self.pending = None
        self._maybe_finish(slot)

    def _prefill_into_slot(self, slot: int, req: Request):
        S = len(req.prompt)
        assert S + req.max_new_tokens <= self.max_len
        toks = req.prompt
        if self.prefill_bucket > 0:
            S_pad = -(-S // self.prefill_bucket) * self.prefill_bucket
            S_pad = min(S_pad, self.max_len)
            toks = np.pad(toks, (0, S_pad - S))
        attrs = {}
        if tracing.ON:
            attrs = dict(rids=[req.rid], rows_true=S,
                         rows_computed=len(toks), start=0)
            self._prefill_counts(S, len(toks))
        if self.cache_mode == "paged":
            # the prompt writes straight into the pool through the table
            self._reserve(slot, req)
            with tracing.span("prefill", **attrs):
                logits = self._prefill_one(
                    toks[None, :], self._paged_cache(self.tbl[slot:slot + 1]),
                    [S - 1])
        else:
            cache1 = self._new_cache1()
            with tracing.span("prefill", **attrs):
                logits = self._prefill_one(toks[None, :], cache1, [S - 1])
            self._seat(slot, cache1)
        self._activate(slot, req, S, logits)
        self._maybe_finish(slot)

    def _activate(self, slot, req, S, logits):
        """Seat a prefilled request: its first token from the prompt's
        last logits."""
        with tracing.span("first_token"), tracing.sync("d2h.first_token"):
            tok = int(torch.argmax(logits[0]))
        req.out_tokens.append(tok)
        self.slot_req[slot] = req
        self.pos[slot] = S
        self.remaining[slot] = req.max_new_tokens - 1
        self.next_tok[slot, 0] = tok

    def _maybe_finish(self, slot: int):
        req = self.slot_req[slot]
        if req is None:
            return
        done = self.remaining[slot] <= 0 or (
            req.eos_id is not None and req.out_tokens
            and req.out_tokens[-1] == req.eos_id)
        if done:
            self.finished[req.rid] = req.out_tokens
            self.slot_req[slot] = None
            self.remaining[slot] = 0
            if self.cache_mode == "paged" and self.slot_blocks[slot]:
                self.alloc.free(self.slot_blocks[slot])
                self.slot_blocks[slot] = []
                self.tbl[slot, :] = 0

    def step(self):
        with tracing.span("step"):
            self._step()

    def _step(self):
        with tracing.span("admit"):
            self._admit()
        if self.pending is not None:
            self._advance_pending()
        active = [s for s in range(self.B) if self.slot_req[s] is not None]
        if not active:
            return
        attrs = {}
        if tracing.ON:
            attrs = dict(rids=[self.slot_req[s].rid for s in active],
                         rows_true=len(active), rows_computed=self.B,
                         start=None)
            tracing.count("decode.calls")
            tracing.count("decode.slot_rows", len(active))
        with tracing.span("decode", **attrs):
            cache = self.cache
            if self.cache_mode == "paged":
                # inactive slots (no request, or a chunked prefill in
                # flight) decode garbage tokens; their writes go to the
                # trash block, or they would clobber a pending slot's
                # freshly written chunks (the slot cache instead overwrites
                # the whole row when the staged prefill is seated)
                mask = np.array([r is not None for r in self.slot_req])
                cache = self._paged_cache(
                    np.where(mask[:, None], self.tbl, 0).astype(np.int32))
            logits = self._decode_multi(self.next_tok, cache, self.pos)
        with tracing.span("sample"), tracing.sync("d2h.sample"):
            toks = torch.argmax(logits, dim=-1).cpu().numpy()
        for slot in active:
            req = self.slot_req[slot]
            tok = int(toks[slot])
            req.out_tokens.append(tok)
            self.pos[slot] += 1
            self.remaining[slot] -= 1
            self.next_tok[slot, 0] = tok
            self._maybe_finish(slot)
