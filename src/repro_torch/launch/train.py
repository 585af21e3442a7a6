"""Training launcher (port of ``repro/launch/train.py``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
        --full --steps 6 --batch 4 --seq 512 --ckpt /path/to/ckpt

Runs the smoke (reduced) configuration unless ``--full`` is given, on
``cuda`` unless ``--device cpu`` is given (without a card it stops):

* resume from the latest committed checkpoint (``checkpoint/store.py``,
  the reference's format: either package resumes the other's run)
* straggler / failure handling: the batch and the step itself are retried
  up to ``--max-retries`` times with the same inputs (``TokenStream`` is
  stateless, so a retry is bit-identical); a step that keeps failing is
  skipped and logged
* heartbeat: a JSON line per logged step (step, loss, t_step, tokens/s) to
  stdout and ``<ckpt>/heartbeat.jsonl``
* ``--crash-at N`` exits hard (code 42) at step N, for restart drills

The weights are drawn from a ``torch.Generator`` seeded with ``--seed``.
``--remesh`` is accepted and read nowhere, as in the reference: this
launcher builds no mesh and resumes every leaf whole, so a run with the
flag resumes exactly as one without it.  A restore onto a mesh is
``checkpoint.load(..., sharding=(specs, mesh))`` with ``specs`` the
parameters' ``param_specs`` and the optimizer's ``init_specs`` of them:
each rank then holds its block of every leaf, as
``make_train_step(rules=, mesh=)`` takes them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import torch

from repro_torch import checkpoint as ckpt_mod
from repro_torch import configs as C
from repro_torch.data import TokenStream
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as O
from repro_torch.train.train_step import init_opt_state, make_train_step


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(C.ARCH_IDS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced config (the default)")
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--remesh", action="store_true",
                    help="restore onto the current mesh regardless of the "
                         "mesh the checkpoint was saved under")
    ap.add_argument("--max-retries", type=int, default=2)
    ap.add_argument("--crash-at", type=int, default=-1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    return ap.parse_args(argv)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "host")
    dev = resolve_device(args.device)
    arch = C.get_arch(args.arch)
    cfg = arch.smoke if args.smoke else arch.model

    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         batch=args.batch, seed=args.seed)
    opt = O.make_optimizer(arch.optimizer, lr=O.cosine_schedule(
        args.lr, warmup=min(20, args.steps // 10 + 1), total=args.steps))
    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches,
                              grad_compression=args.grad_compression)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_params(cfg, gen, dev)
    opt_state = init_opt_state(cfg, opt, params,
                               grad_compression=args.grad_compression)

    start = 0
    hb_file = None
    if args.ckpt:
        ckpt_dir = Path(args.ckpt)
        state_like = {"params": params, "opt": opt_state}
        step0, restored = ckpt_mod.load_latest(ckpt_dir, state_like,
                                               device=dev)
        if step0 is not None:
            params, opt_state = restored["params"], restored["opt"]
            start = step0 + 1
            print(f"resumed from step {step0}", flush=True)
        hb_file = ckpt_dir / "heartbeat.jsonl"
        ckpt_dir.mkdir(parents=True, exist_ok=True)

    tokens_per_step = args.batch * args.seq
    for step in range(start, args.steps):
        if step == args.crash_at:
            print(f"CRASH injected at step {step}", flush=True)
            sys.stdout.flush()
            os._exit(42)

        t0 = time.time()
        loss = None
        for attempt in range(args.max_retries + 1):
            try:
                batch = stream.make_batch(step, device=dev)   # idempotent
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     batch, step)
                loss = float(metrics["loss"])
                break
            except Exception as e:                       # noqa: BLE001
                print(f"step {step} attempt {attempt} failed: "
                      f"{type(e).__name__}: {e}", flush=True)
                if attempt == args.max_retries:
                    print(f"step {step} SKIPPED after retries", flush=True)
        _sync(dev)
        dt = time.time() - t0

        if loss is not None and (step % args.log_every == 0
                                 or step == args.steps - 1):
            hb = {"step": step, "loss": round(loss, 4),
                  "t_step_s": round(dt, 3),
                  "tokens_per_s": round(tokens_per_step / max(dt, 1e-9))}
            line = json.dumps(hb)
            print(line, flush=True)
            if hb_file is not None:
                with open(hb_file, "a") as f:
                    f.write(line + "\n")

        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt_mod.save(args.ckpt, step,
                          {"params": params, "opt": opt_state})
    if args.ckpt:
        ckpt_mod.save(args.ckpt, args.steps - 1,
                      {"params": params, "opt": opt_state})
    return 0


if __name__ == "__main__":
    sys.exit(main())
