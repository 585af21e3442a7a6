"""Serving launcher: batched prefill + greedy decode on an assigned
architecture (port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
        --device cpu

Runs the smoke (reduced) configuration, as the reference's launcher does:
prefill the prompt batch, then greedy-decode ``--gen`` tokens with the KV
cache, reporting per-phase latency and tokens/s.  It runs on ``cuda``
unless ``--device cpu`` is given, and without a card it stops.  Prompts
come from the port's bit-exact ``randint(PRNGKey(seed), ...)``, so both
packages serve the same prompts; the weights are drawn from a
``torch.Generator`` seeded with ``--seed``.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch import configs as C
from repro_torch import random as jr
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.train.serve_step import make_decode_step, make_prefill_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def prompt_tokens(cfg: T.ModelConfig, batch: int, prompt_len: int,
                  seed: int, device=None) -> torch.Tensor:
    """The reference launcher's prompts, ``randint(PRNGKey(seed), (batch,
    prompt_len), 0, V)``, as int32 on ``device``."""
    toks = jr.randint(jr.PRNGKey(seed), (batch, prompt_len), 0,
                      cfg.vocab_size)
    return toks.to(device=resolve_device(device), dtype=torch.int32)


def serve(cfg: T.ModelConfig, *, batch: int, prompt_len: int, gen: int,
          seed: int = 0, device=None, params: dict | None = None) -> dict:
    """Prefill ``batch`` prompts of ``prompt_len`` tokens, then decode
    ``gen`` tokens greedily.  ``params=None`` draws the weights from
    ``seed``.  Returns ``tokens`` (int32 [batch, gen + 1]: the prefill's
    argmax, then one per decode step), the final ``logits`` ([batch, V]
    float32) and the phases' seconds (``prefill_s``, ``decode_s``, host
    clock around work that ends in a device synchronise)."""
    dev = resolve_device(device)
    if params is None:
        params = T.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    tokens = prompt_tokens(cfg, batch, prompt_len, seed, dev)
    prefill = make_prefill_step(cfg, max_seq=prompt_len + gen)
    decode = make_decode_step(cfg)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, tokens)
    cur = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out = [cur]
    t0 = time.perf_counter()
    for i in range(gen):
        nxt, logits, cache = decode(params, cache, cur, prompt_len + i)
        cur = nxt[:, None]
        out.append(cur)
    _sync(dev)
    t_decode = time.perf_counter() - t0
    return {"tokens": torch.cat(out, dim=1), "logits": logits,
            "prefill_s": t_prefill, "decode_s": t_decode}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=list(C.ARCH_IDS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback between them")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "host")

    cfg = C.get_arch(args.arch).smoke
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, seed=args.seed, device=args.device)
    print(f"prefill[{args.batch}x{args.prompt_len}]: "
          f"{res['prefill_s']:.2f}s")
    print(f"decode {args.gen} steps: {res['decode_s']:.2f}s "
          f"({args.gen * args.batch / max(res['decode_s'], 1e-9):.1f} "
          "tok/s)")
    print("sample:", res["tokens"][0, :16].tolist())
    if not bool(torch.isfinite(res["logits"]).all()):
        raise SystemExit("non-finite logits")
    return 0


if __name__ == "__main__":
    sys.exit(main())
