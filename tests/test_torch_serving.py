"""The port's LM serving path against the reference on the CPU:
``TokenStream`` bit for bit, the ten architecture configurations field for
field, parameter counts on the meta device, ``NotImplementedError`` for
the stage kinds not ported yet, and ``launch.serve`` (greedy tokens equal
to the reference's prefill-and-decode loop with the same weights and
prompts)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro import configs as RC
from repro.data import TokenStream as RefTokenStream
from repro.models import transformer as RT
from repro.train.serve_step import make_decode_step, make_prefill_step
from repro_torch import configs as PC
from repro_torch import interop
from repro_torch.data import TokenStream
from repro_torch.launch import serve as serve_mod
from repro_torch.models import transformer as PT

DENSE = ("qwen2-0.5b", "qwen1.5-0.5b", "gemma-2b", "gemma3-1b")
NOT_PORTED = tuple(a for a in RC.ARCH_IDS if a not in DENSE)


@pytest.mark.parametrize("seed", (0, 3, 20260))
def test_token_stream_bit_equal(seed):
    for vocab, seq, batch, shards in ((101, 16, 4, 1), (151_936, 33, 3, 2)):
        ref = RefTokenStream(vocab, seq, batch, seed, shards)
        port = TokenStream(vocab, seq, batch, seed, shards)
        for step in (0, 5, 1000):
            for shard in range(shards):
                got = port.make_batch(step, shard, device="cpu")["tokens"]
                assert got.dtype == torch.int32
                np.testing.assert_array_equal(
                    got.numpy(), np.asarray(ref.make_batch(step, shard)
                                            ["tokens"]))
            np.testing.assert_array_equal(
                port.global_batch(step, device="cpu")["tokens"].numpy(),
                np.asarray(ref.global_batch(step)["tokens"]))


def _model_fields(cfg):
    d = dataclasses.asdict(cfg)
    d["hd"] = cfg.hd
    d["dtype"] = str(cfg.dtype).removeprefix("torch.")
    return d


@pytest.mark.parametrize("arch_id", RC.ARCH_IDS)
def test_config_equals_reference(arch_id):
    ref, port = RC.get_arch(arch_id), PC.get_arch(arch_id)
    for part in ("model", "smoke"):
        assert _model_fields(getattr(port, part)) == \
            _model_fields(getattr(ref, part))
        getattr(port, part).validate()
    for f in dataclasses.fields(ref):
        if f.name not in ("model", "smoke"):
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]


def test_registry_shapes_and_cells_equal_reference():
    assert PC.ARCH_IDS == RC.ARCH_IDS
    assert {k: dataclasses.asdict(v) for k, v in PC.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in RC.SHAPES.items()}
    assert list(PC.cells()) == list(RC.cells())
    assert list(PC.cells(include_skipped=True)) == \
        list(RC.cells(include_skipped=True))
    with pytest.raises(KeyError, match="unknown arch"):
        PC.get_arch("gpt-5")


@pytest.mark.parametrize("arch_id", DENSE)
def test_param_count_equals_reference(arch_id):
    """Full width and smoke twin, on the meta device (qwen2-0.5b full:
    494M parameters, allocated nowhere)."""
    for part in ("model", "smoke"):
        got = PT.param_count(getattr(PC.get_arch(arch_id), part))
        assert got == RT.param_count(getattr(RC.get_arch(arch_id), part))
    shapes = PT.param_shapes(PC.get_arch(arch_id).model)
    assert shapes["embed"].device.type == "meta"


@pytest.mark.parametrize("arch_id", NOT_PORTED)
def test_unported_stage_kinds_raise(arch_id):
    """MoE, mamba, hybrid, cross-attention and the encoder wait for later
    slices; each names its roadmap item."""
    cfg = PC.get_arch(arch_id).smoke
    for call in (lambda: PT.param_count(cfg),
                 lambda: PT.init_params(cfg, torch.Generator(), "cpu"),
                 lambda: PT.init_cache(cfg, 1, 8, device="cpu")):
        with pytest.raises(NotImplementedError, match="queue 1 item 5"):
            call()


def test_serve_main_runs_on_cpu(capsys):
    assert serve_mod.main(["--arch", "qwen2-0.5b", "--batch", "2",
                           "--prompt-len", "16", "--gen", "4",
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "prefill[2x16]" in out and "decode 4 steps" in out


def test_serve_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would use it")
    with pytest.raises(SystemExit, match="no CUDA device"):
        serve_mod.main(["--arch", "qwen2-0.5b"])


@pytest.mark.parametrize("arch_id", ("qwen2-0.5b", "gemma3-1b"))
def test_serve_greedy_tokens_equal_reference_loop(arch_id):
    """``serve`` with the reference's weights gives the tokens of the
    reference launcher's loop (``src/repro/launch/serve.py:44-64``), run
    here with the same weights and prompts; gemma3's 16-slot rings wrap
    during the prompt and the decode."""
    batch, prompt_len, gen, seed = 3, 24, 8, 5
    rcfg = RC.get_arch(arch_id).smoke
    key = jax.random.PRNGKey(seed)
    rp = jax.jit(RT.init_params, static_argnums=0)(rcfg, key)
    tokens = jax.random.randint(key, (batch, prompt_len), 0,
                                rcfg.vocab_size, jnp.int32)
    prefill = jax.jit(make_prefill_step(rcfg, max_seq=prompt_len + gen))
    decode = jax.jit(make_decode_step(rcfg))
    logits, cache = prefill(rp, tokens)
    cur = jnp.argmax(logits, axis=-1)[:, None].astype(jnp.int32)
    out = [cur]
    for i in range(gen):
        cur, logits, cache = decode(rp, cache, cur,
                                    jnp.asarray(prompt_len + i, jnp.int32))
        cur = cur[:, None]
        out.append(cur)
    want = np.asarray(jnp.concatenate(out, axis=1))

    pcfg = PC.get_arch(arch_id).smoke
    np.testing.assert_array_equal(
        serve_mod.prompt_tokens(pcfg, batch, prompt_len, seed, "cpu"),
        np.asarray(tokens))
    res = serve_mod.serve(pcfg, batch=batch, prompt_len=prompt_len,
                          gen=gen, seed=seed, device="cpu",
                          params=interop.params_from(rp, "cpu"))
    np.testing.assert_array_equal(res["tokens"].numpy(), want)
    torch.testing.assert_close(res["logits"],
                               torch.from_numpy(np.array(logits)),
                               rtol=1e-4, atol=1e-4)
    assert res["prefill_s"] > 0 and res["decode_s"] > 0


def test_sampled_decode_draws_from_the_generator():
    """``sample=True`` draws from softmax(logits / T) with the caller's
    generator: the same seed gives the same tokens, and every token is in
    the vocabulary."""
    from repro_torch.train.serve_step import make_decode_step as port_decode
    cfg = PC.get_arch("qwen2-0.5b").smoke
    params = PT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = serve_mod.prompt_tokens(cfg, 2, 8, 0, "cpu")
    step = port_decode(cfg, sample=True, temperature=0.7)
    runs = []
    for _ in range(2):
        _, cache = PT.prefill_step(cfg, params, toks, max_seq=12)
        gen = torch.Generator().manual_seed(3)
        nxt, _, _ = step(params, cache, toks[:, -1:], 8, gen)
        runs.append(nxt)
    assert torch.equal(runs[0], runs[1]) and runs[0].dtype == torch.int32
    assert bool(((runs[0] >= 0) & (runs[0] < cfg.vocab_size)).all())
