"""End-to-end training on the PyTorch port: a ~100M-parameter
qwen2-family model for a few hundred steps with checkpointing (port of
``examples/train_lm.py``).

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 300]
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu

The reference's purpose-built ~100M config (scaled-up smoke: 8 layers,
d_model 512, vocab 32k, float32) instead of the 0.5B full config, with
the same flags, checkpoint cadence and printed lines; it runs on ``cuda``
unless ``--device cpu`` is given.  The checkpoints are in the reference's
format, so either example resumes the other's run.
"""
import argparse
import json
import os
import sys
import tempfile
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.data import TokenStream
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.transformer import ModelConfig, uniform_pattern
from repro_torch.train.optimizer import cosine_schedule, make_optimizer
from repro_torch.train.train_step import init_opt_state, make_train_step

CFG_100M = ModelConfig(
    name="qwen2-100m", family="dense",
    num_layers=8, d_model=512, num_heads=8, num_kv_heads=2, d_ff=1536,
    vocab_size=32_000, patterns=uniform_pattern("attn", 8),
    qkv_bias=True, tie_embeddings=True, activation="silu", glu=True,
    param_dtype="float32",
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_train_lm_torch"))
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "host")
    dev = resolve_device(args.device)

    cfg = CFG_100M
    print(f"params: {T.param_count(cfg)/1e6:.1f}M")
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         batch=args.batch, seed=0)
    opt = make_optimizer("adamw", lr=cosine_schedule(
        3e-4, warmup=30, total=args.steps), state_dtype="float32")
    step_fn = make_train_step(cfg, opt)

    params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    opt_state = init_opt_state(cfg, opt, params)

    start = 0
    st0, restored = ckpt.load_latest(args.ckpt,
                                     {"params": params, "opt": opt_state},
                                     device=dev)
    if st0 is not None:
        params, opt_state = restored["params"], restored["opt"]
        start = st0 + 1
        print(f"resumed from step {st0}")

    t_start, tok = time.time(), args.batch * args.seq
    for step in range(start, args.steps):
        batch = stream.make_batch(step, device=dev)
        t0 = time.time()
        params, opt_state, m = step_fn(params, opt_state, batch, step)
        if step % 25 == 0 or step == args.steps - 1:
            print(json.dumps({"step": step,
                              "loss": round(float(m["loss"]), 4),
                              "tok_per_s": round(tok / (time.time() - t0))}),
                  flush=True)
        if (step + 1) % 100 == 0:
            ckpt.save(args.ckpt, step, {"params": params, "opt": opt_state})
    print(f"done in {time.time()-t_start:.0f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
