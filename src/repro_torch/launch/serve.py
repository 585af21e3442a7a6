"""Serving launcher: batched prefill + greedy decode on any assigned
architecture (port of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch falcon-mamba-7b --device cpu

Runs the smoke (reduced) configuration, as the reference's launcher does:
prefill the prompt batch, then greedy-decode ``--gen`` tokens with the
KV / SSM cache, reporting per-phase latency and tokens/s.  It runs on
``cuda`` unless ``--device cpu`` is given, and without a card it stops.
Prompts come from the port's bit-exact ``randint(PRNGKey(seed), ...)``, so
both packages serve the same prompts; the weights, and for whisper and
llama-vision the cross-attention source (frames, patches), are drawn from
a ``torch.Generator`` seeded with ``--seed``.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch import configs as C
from repro_torch import random as jr
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from repro_torch.models.layers import NO_SHARD
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


def cross_source(cfg: T.ModelConfig, batch: int, seed: int,
                 device=None) -> torch.Tensor | None:
    """The cross-attention source the reference launcher draws for a
    model with cross layers (whisper's frames, llama-vision's patches):
    standard normals [batch, cross_seq, d_model] in ``cfg.dtype``, here
    from a ``torch.Generator`` seeded with ``seed`` (not JAX's stream);
    None for the other models."""
    if not cfg.cross_seq:
        return None
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((batch, cfg.cross_seq, cfg.d_model), generator=gen,
                       device=dev).to(cfg.dtype)


def serve(cfg: T.ModelConfig, *, batch: int, prompt_len: int, gen: int,
          seed: int = 0, device=None, params: dict | None = None,
          cross_src: torch.Tensor | None = None, mesh=None) -> dict:
    """Prefill ``batch`` prompts of ``prompt_len`` tokens, then decode
    ``gen`` tokens greedily.  ``params=None`` draws the weights from
    ``seed``, and ``cross_src=None`` draws the source of a model with
    cross layers (``cross_source``).  Returns ``tokens`` (int32 [batch,
    gen + 1]: the prefill's argmax, then one per decode step), the final
    ``logits`` ([batch, V] float32) and the phases' seconds
    (``prefill_s``, ``decode_s``, host clock around work that ends in a
    device synchronise).

    ``mesh`` (a ``launch.mesh.Mesh``): serve through it with the rules of
    ``make_rules`` for prefill and decode; this rank takes its rows of the
    prompts and the source and its block of every leaf by ``param_specs``
    (``shard_tree``; ``params`` whole), gathers a leaf's blocks where a
    layer uses it, holds its block of the decode caches, and returns its
    rows, the logits whole."""
    dev = resolve_device(device)
    if params is None:
        params = T.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), dev)
    if cross_src is None:
        cross_src = cross_source(cfg, batch, seed, dev)
    tokens = prompt_tokens(cfg, batch, prompt_len, seed, dev)
    rules_p = rules_d = NO_SHARD
    if mesh is not None:
        rules_p = M.make_rules(mesh, kind="prefill", global_batch=batch,
                               cfg=cfg)
        rules_d = M.make_rules(mesh, kind="decode", global_batch=batch,
                               cfg=cfg)
        params = M.shard_tree(params, T.param_specs(cfg), mesh)
        data = {"tokens": tokens, "cross": cross_src}
        if cross_src is None:
            del data["cross"]
        data = M.shard_tree(data, M.batch_specs(mesh, rules_p, data), mesh)
        tokens, cross_src = data["tokens"], data.get("cross")
    prefill = make_prefill_step(cfg, rules=rules_p, mesh=mesh,
                                max_seq=prompt_len + gen)
    decode = make_decode_step(cfg, rules=rules_d, mesh=mesh)

    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, tokens, cross_src)
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
