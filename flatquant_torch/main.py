"""flatquant-torch CLI: calibrate -> quantize -> eval -> (export | serve
demo); run as `python -m flatquant_torch.main` (port of main.py).

The reference's main.py / args_utils.py analog (main.py:12-91,
args_utils.py:28-161), driving the same pipeline on one CUDA card:

  get model -> calibration data -> apply FlatQuant -> layer-wise calibrate
  -> save flat_parameters -> bake (reparameterize) -> save flat_matrices
  -> GPTQ|RTN weight quant -> PPL eval -> [packed int4 export, generation]

It takes the JAX CLI's flags; --platform cpu runs everything on the CPU
(the plain versions), and without it a host with no card raises. Works
offline: --model tiny-llama with synthetic data exercises the whole
pipeline; --hf_path loads a local HF Llama/Qwen checkpoint directory.
--hf_path with a DeepSeek model loads an HF DeepSeek checkpoint
(models/ds_loader.py, fp8 tiles dequantized). Artifacts are written in
the JAX package's formats, so each package loads the other's. --lm_eval
needs the lm-eval package and its task data, --plot_flatness matplotlib
(each imported only when its flag is given, as JAX's CLI does).
"""

from __future__ import annotations

import argparse
import os
import time


def parser_gen():
    p = argparse.ArgumentParser("flatquant-torch")
    p.add_argument("--model", default="tiny-llama", help="config name (models.config registry)")
    p.add_argument("--hf_path", default=None, help="local HF checkpoint dir (safetensors)")
    p.add_argument("--hf_token", default=None, help="accepted for reference-CLI compatibility; unused (no network access)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--platform", default=None, choices=[None, "cpu", "gpu"],
                   help="cpu runs the plain PyTorch versions on the CPU; the "
                        "default (gpu) is the CUDA card")
    # bits
    p.add_argument("--w_bits", type=int, default=16)
    p.add_argument("--a_bits", type=int, default=16)
    p.add_argument("--q_bits", type=int, default=16)
    p.add_argument("--k_bits", type=int, default=16)
    p.add_argument("--v_bits", type=int, default=16)
    p.add_argument("--w_asym", action="store_true")
    p.add_argument("--a_asym", action="store_true")
    p.add_argument("--q_asym", action="store_true")
    p.add_argument("--k_asym", action="store_true")
    p.add_argument("--v_asym", action="store_true")
    p.add_argument("--a_groupsize", type=int, default=-1)
    p.add_argument("--w_groupsize", type=int, default=-1)
    p.add_argument("--q_groupsize", type=int, default=-1)
    p.add_argument("--k_groupsize", type=int, default=-1)
    p.add_argument("--v_groupsize", type=int, default=-1)
    # learnables
    p.add_argument("--cali_trans", action="store_true", help="train transforms")
    p.add_argument("--add_diag", action="store_true")
    p.add_argument("--lwc", action="store_true")
    p.add_argument("--lac", action="store_true")
    p.add_argument("--direct_inv", action="store_true")
    p.add_argument("--separate_vtrans", action="store_true")
    p.add_argument("--diag_init", default="sq_style", choices=["sq_style", "one_style"])
    p.add_argument("--diag_alpha", type=float, default=0.3)
    # calibration
    p.add_argument("--epochs", type=int, default=15)
    p.add_argument("--nsamples", type=int, default=128)
    p.add_argument("--cali_bsz", type=int, default=4)
    p.add_argument("--flat_lr", type=float, default=5e-3)
    p.add_argument("--warmup", action="store_true")
    p.add_argument("--deactive_amp", action="store_true")
    p.add_argument("--cali_dataset", default="synthetic",
                   help="wikitext2|c4|ptb|pile|synthetic, or a LOCAL "
                        "corpus file path (.txt/.jsonl/.json; needs "
                        "--tokenizer_path) — the zero-egress route")
    p.add_argument("--seqlen", type=int, default=None)
    # weight quant pass
    p.add_argument("--v3_not_last", type=int, default=0, metavar="N",
                   help="DeepSeek: leave the last N MoE layers unquantized "
                        "(main_dpskv3.py:456-459 analog)")
    p.add_argument("--tpu_decompose", action="store_true",
                   help="(n/128, 128) Kronecker decomposition for every "
                        "transform dim divisible by 128 (the rn128 split)")
    p.add_argument("--gptq", action="store_true", help="GPTQ instead of RTN")
    p.add_argument("--act_order", action="store_true")
    p.add_argument("--percdamp", type=float, default=0.01)
    p.add_argument("--gptq_mse", action="store_true",
                   help="MSE grid search for weight clip (quant_utils.py:177-202)")
    # artifacts / resume
    p.add_argument("--output_dir", default="./outputs")
    p.add_argument("--exp_name", default="exp")
    p.add_argument("--resume", action="store_true", help="reload flat_parameters")
    p.add_argument("--reload_matrix", action="store_true", help="reload flat_matrices")
    p.add_argument("--matrix_path", default=None)
    p.add_argument("--save_matrix", action="store_true")
    p.add_argument("--quantized_save", action="store_true", help="export packed int4 safetensors")
    p.add_argument("--perm_transforms", action="store_true",
                   help="serving layout: one-copy transposed-output online "
                        "transforms with weight input channels permuted to "
                        "match (identical results, less prefill glue)")
    # eval
    p.add_argument("--eval_ppl", action="store_true")
    p.add_argument("--eval_datasets", nargs="+", default=["wikitext2"])
    p.add_argument("--lm_eval", nargs="*", default=None, help="lm-eval task names")
    p.add_argument("--lm_eval_batch_size", type=int, default=8)
    p.add_argument("--generate_demo", type=int, default=0, help="decode N tokens as a smoke test")
    p.add_argument("--plot_flatness", default=None, metavar="PNG",
                   help="save per-channel flatness curves (plot_flatness.py analog)")
    p.add_argument("--flatness_layers", type=int, nargs="+", default=[0])
    p.add_argument("--tokenizer_path", default=None)
    return p


def _device(platform):
    import torch

    if platform == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card (torch.cuda.is_available() is "
                           "False); pass --platform cpu to run on the CPU")
    return torch.device("cuda")


def main(argv=None) -> dict:
    """Run the pipeline; returns a summary: "exp_dir", "cfg", "fq_cfg",
    "seconds" by stage, "ppl" by dataset, the demo's "prompt" and
    "tokens", the "lm_eval" summary, the "flatness" norms, and the
    model's "params" / "fq" / "serving" objects where they were made."""
    args = parser_gen().parse_args(argv)
    is_deepseek = "deepseek" in args.model
    dev = _device(args.platform)

    import numpy as np
    import torch

    from flatquant_torch.calib.data import get_loaders
    from flatquant_torch.calib.gptq import gptq_model
    from flatquant_torch.calib.trainer import calibrate
    from flatquant_torch.evals.ppl import ppl_eval, stream_ppl
    from flatquant_torch.models.config import get_config
    from flatquant_torch.models.llama import init_params
    from flatquant_torch.models.loader import (
        config_from_hf_json,
        load_hf_llama,
    )
    from flatquant_torch.quantize.bake import bake_model, rtn_quantize_params
    from flatquant_torch.quantize.spec import FQConfig
    from flatquant_torch.quantize.state import init_model_fq
    from flatquant_torch.utils import checkpoint as ckpt
    from flatquant_torch.utils.logging_utils import create_logger

    fq_cfg = FQConfig(
        w_bits=args.w_bits, a_bits=args.a_bits, q_bits=args.q_bits,
        k_bits=args.k_bits, v_bits=args.v_bits,
        w_asym=args.w_asym, a_asym=args.a_asym, q_asym=args.q_asym,
        k_asym=args.k_asym, v_asym=args.v_asym,
        w_groupsize=args.w_groupsize, a_groupsize=args.a_groupsize,
        q_groupsize=args.q_groupsize,
        k_groupsize=args.k_groupsize, v_groupsize=args.v_groupsize,
        cali_trans=args.cali_trans, add_diag=args.add_diag,
        lwc=args.lwc, lac=args.lac, direct_inv=args.direct_inv,
        separate_vtrans=args.separate_vtrans,
        diag_init=args.diag_init, diag_alpha=args.diag_alpha,
        epochs=args.epochs, nsamples=args.nsamples, cali_bsz=args.cali_bsz,
        flat_lr=args.flat_lr, warmup=args.warmup,
        deactive_amp=args.deactive_amp, tpu_decompose=args.tpu_decompose,
        gptq=args.gptq, gptq_percdamp=args.percdamp,
        gptq_act_order=args.act_order, gptq_mse=args.gptq_mse,
    )

    exp_dir = os.path.join(args.output_dir, args.model,
                           f"w{args.w_bits}a{args.a_bits}", args.exp_name)
    log = create_logger(exp_dir)
    log.info(f"args: {vars(args)}")
    log.info(f"device: {dev}" + (f" ({torch.cuda.get_device_name(dev)})"
                                 if dev.type == "cuda" else ""))
    out = {"exp_dir": exp_dir, "fq_cfg": fq_cfg, "seconds": {}, "ppl": {}}
    calibrated = fq_cfg.cali_trans or fq_cfg.lwc or fq_cfg.lac \
        or fq_cfg.add_diag

    def timed(stage, fn, *a, **kw):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        r = fn(*a, **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["seconds"][stage] = time.perf_counter() - t0
        return r

    # --- model ---
    if is_deepseek:
        from flatquant_torch.models.deepseek import (
            DEEPSEEK_V3,
            TINY_DEEPSEEK,
            init_ds_params,
        )

        if args.hf_path:
            from flatquant_torch.models.ds_loader import (
                ds_config_from_hf_json,
                load_hf_deepseek,
            )

            cfg = ds_config_from_hf_json(args.hf_path, name=args.model)
            params = timed("load", load_hf_deepseek, args.hf_path, cfg,
                           device=dev)
            log.info(f"loaded HF DeepSeek checkpoint from {args.hf_path}")
        else:
            cfg = {"deepseek-v3": DEEPSEEK_V3,
                   "tiny-deepseek": TINY_DEEPSEEK}[args.model]
            params = init_ds_params(cfg, seed=args.seed, device=dev)
            log.info(f"random-init DeepSeek model {args.model}")
    elif args.hf_path:
        cfg = config_from_hf_json(args.hf_path, name=args.model)
        params = load_hf_llama(args.hf_path, cfg, device=dev)
        log.info(f"loaded HF checkpoint from {args.hf_path}")
    else:
        cfg = get_config(args.model)
        params = init_params(cfg, seed=args.seed, device=dev)
        log.info(f"random-init model {args.model} (no --hf_path)")
    seqlen = args.seqlen or cfg.seqlen
    out.update(cfg=cfg, params=params)

    # --- data ---
    tokenizer = None
    if args.tokenizer_path:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.tokenizer_path)
    data = get_loaders(
        args.cali_dataset, cfg.vocab_size, nsamples=args.nsamples,
        seqlen=seqlen, seed=args.seed, tokenizer=tokenizer,
    )
    log.info(f"calibration data source: {data.source}, train "
             f"{data.train.shape}")

    quantize = fq_cfg.quantize
    eval_params, eval_fq = params, None
    if quantize and is_deepseek:
        from flatquant_torch.models.deepseek import (
            bake_ds_fq,
            build_ds_serving_params,
            calibrate_deepseek,
            deepseek_forward,
            init_ds_fq,
        )

        dense_fq, moe_fq = init_ds_fq(cfg, fq_cfg, seed=args.seed,
                                      device=dev)
        if calibrated:
            dense_fq, moe_fq = timed(
                "calibrate", calibrate_deepseek, cfg, fq_cfg, params,
                dense_fq, moe_fq, data.train, log=log.info,
                save_cb=lambda i, st: ckpt.save_flat_parameters(exp_dir, st),
                skip_last=args.v3_not_last)
        eval_fq = bake_ds_fq(dense_fq, moe_fq)
        out["fq"] = (dense_fq, moe_fq)
        if args.save_matrix:
            ckpt.save_flat_matrices(exp_dir, eval_fq)
            log.info("saved flat_matrices")
        if args.quantized_save:
            sp, _ = build_ds_serving_params(cfg, fq_cfg, params, dense_fq,
                                            moe_fq)
            path = ckpt.save_packed_safetensors(exp_dir, sp, {
                "model": args.model, "w_bits": fq_cfg.w_bits,
                "a_bits": fq_cfg.a_bits, "v3_not_last": args.v3_not_last,
            }, filename="ds_packed_int4.safetensors")
            out["serving"] = sp
            log.info(f"saved packed DeepSeek serving params -> {path}")
        if args.eval_ppl:
            d = get_loaders("synthetic", cfg.vocab_size, nsamples=2,
                            seqlen=seqlen)

            def forward(t):
                return deepseek_forward(
                    cfg, params, t, fq=eval_fq, fq_cfg=fq_cfg, mode="calib",
                    n_fp_tail=args.v3_not_last, device=dev)

            ppl = timed("ppl_synthetic", stream_ppl, forward, d.test, seqlen,
                        dev)
            out["ppl"]["synthetic"] = ppl
            log.info(f"deepseek synthetic PPL: {ppl:.4f}")
        log.info("done")
        return out
    if quantize:
        fq_state = init_model_fq(cfg, fq_cfg, seed=args.seed, device=dev)
        if args.reload_matrix:
            # a reference-zoo .pth (flat_utils.py:65-93 schema) or the
            # msgpack matrices artifact: load eval matrices, then bake
            # fresh fp weights against them (main.py:30-38 analog)
            from flatquant_torch.utils.reference_convert import (
                fq_from_flat_matrices,
                load_reference_flat_matrices,
                matrices_fq_template,
            )

            src = args.matrix_path or exp_dir
            pth = src if src.endswith(".pth") else os.path.join(
                src, "flat_matrices.pth")
            if os.path.exists(pth):
                fq_state = fq_from_flat_matrices(
                    load_reference_flat_matrices(pth), cfg, device=dev)
                log.info(f"reloaded reference flat_matrices from {pth}")
            else:
                template = matrices_fq_template(cfg, fq_cfg, seed=args.seed,
                                                device=dev)
                fq_state = ckpt.load_flat_matrices(src, template)
                log.info(f"reloaded flat_matrices from {src}")
        elif args.resume and os.path.exists(
                os.path.join(exp_dir, "flat_parameters.msgpack")):
            fq_state = ckpt.load_flat_parameters(exp_dir, fq_state)
            log.info("resumed flat_parameters")
        elif calibrated:
            fq_state = timed(
                "calibrate", calibrate, cfg, fq_cfg, params, fq_state,
                data.train, log=log.info,
                save_cb=lambda i, st: ckpt.save_flat_parameters(exp_dir, st))
        baked_params, baked_fq = timed("bake", bake_model, cfg, fq_cfg,
                                       params, fq_state)
        if args.save_matrix:
            # the pre-fold form (diag scales intact): reloadable onto raw
            # weights, like the reference's save-before-reparameterize
            from flatquant_torch.utils.reference_convert import (
                matrices_state,
            )

            ckpt.save_flat_matrices(exp_dir, matrices_state(fq_state))
            log.info("saved flat_matrices")
        if args.gptq:
            eval_params = timed("gptq", gptq_model, cfg, fq_cfg,
                                baked_params, baked_fq, data.train,
                                log=log.info)
        else:
            eval_params = rtn_quantize_params(fq_cfg, baked_params)
        eval_fq = baked_fq
        out["fq"] = fq_state

        if args.quantized_save:
            from flatquant_torch.serving.quantized import (
                build_serving_params,
            )

            sp = build_serving_params(cfg, fq_cfg, baked_params, baked_fq,
                                      eval_params=eval_params,
                                      perm_transforms=args.perm_transforms)
            path = ckpt.save_packed_safetensors(
                exp_dir, sp,
                quantization_config={
                    "w_bits": fq_cfg.w_bits, "a_bits": fq_cfg.a_bits,
                    "k_bits": fq_cfg.k_bits, "v_bits": fq_cfg.v_bits,
                    "model": args.model, "format": "packed_int4_planar",
                    "layout": "perm" if args.perm_transforms else "standard",
                },
            )
            out["serving"] = sp
            log.info(f"exported packed int4 weights to {path}")

    # --- evals ---
    if args.eval_ppl:
        for ds in args.eval_datasets:
            d = get_loaders(ds, cfg.vocab_size, nsamples=2, seqlen=seqlen,
                            tokenizer=tokenizer)
            mode = "eval" if quantize else "fp"
            ppl = timed(f"ppl_{ds}", ppl_eval, cfg, eval_params, d.test,
                        fq=eval_fq, fq_cfg=fq_cfg, mode=mode, seqlen=seqlen)
            out["ppl"][ds] = ppl
            log.info(f"{ds} ({d.source}) PPL: {ppl:.4f}")

    if args.lm_eval is not None:
        from flatquant_torch.evals.tasks import run_lm_eval

        out["lm_eval"] = timed(
            "lm_eval", run_lm_eval, cfg, eval_params, eval_fq, fq_cfg,
            tasks=args.lm_eval, tokenizer=tokenizer,
            batch_size=args.lm_eval_batch_size, log=log.info)
        log.info(f"lm-eval: {out['lm_eval']}")

    if args.plot_flatness and not is_deepseek:
        from flatquant_torch.evals.flatness import (
            model_flatness,
            plot_flatness,
        )

        toks = data.train[:1, :min(seqlen, 128)]
        fqs = fq_state if quantize else None
        out["flatness"] = timed("flatness", model_flatness, cfg, params, fqs,
                                toks, layers=tuple(args.flatness_layers))
        path = plot_flatness(out["flatness"], args.plot_flatness)
        log.info(f"flatness plot saved to {path}")

    if args.generate_demo > 0 and quantize:
        from flatquant_torch.serving.engine import generate
        from flatquant_torch.serving.quantized import build_serving_params

        sp = build_serving_params(cfg, fq_cfg, baked_params, baked_fq,
                                  eval_params=eval_params,
                                  perm_transforms=args.perm_transforms)
        out["serving"] = sp
        prompt = data.test[:, :16].astype(np.int32)
        out["prompt"] = prompt
        toks = timed("generate", generate, cfg, fq_cfg, sp, prompt,
                     max_new_tokens=args.generate_demo, max_len=64,
                     use_kernel=dev.type == "cuda", device=dev)
        out["tokens"] = toks.tolist()
        log.info(f"generated tokens: {toks.tolist()}")

    log.info("done")
    return out


if __name__ == "__main__":
    main()
