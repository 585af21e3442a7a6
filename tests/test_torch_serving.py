"""The port's LM serving path against the reference on the CPU:
``TokenStream`` bit for bit, the ten architecture configurations field for
field, parameter counts on the meta device, and ``launch.serve`` for every
architecture (greedy tokens equal to the reference's prefill-and-decode
loop with the same weights, prompts and cross-attention source)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm import with_gates
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


@pytest.mark.parametrize("arch_id", RC.ARCH_IDS)
def test_param_count_equals_reference(arch_id):
    """Full width and smoke twin, on the meta device
    (moonshot-v1-16b-a3b full: 28,057,995,264 parameters, allocated
    nowhere)."""
    for part in ("model", "smoke"):
        pcfg = getattr(PC.get_arch(arch_id), part)
        rcfg = getattr(RC.get_arch(arch_id), part)
        assert PT.param_count(pcfg) == RT.param_count(rcfg)
    shapes = PT.param_shapes(PC.get_arch(arch_id).model)
    assert shapes["embed"].device.type == "meta"
    if arch_id == "moonshot-v1-16b-a3b":
        assert PT.param_count(PC.get_arch(arch_id).model) == 28_057_995_264


@pytest.mark.parametrize("arch_id", RC.ARCH_IDS)
def test_serve_main_runs_on_cpu(arch_id, capsys):
    """The launcher at its defaults (batch 4 x 64 prompt tokens + 32
    decode steps, the smoke twin) for every architecture; whisper's and
    llama-vision's frames / patches are drawn from the seed.  Whisper's
    decode runs past its 64 learned positions and reads the last row, as
    the reference's ``dynamic_slice`` does."""
    assert serve_mod.main(["--arch", arch_id, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "prefill[4x64]" in out and "decode 32 steps" in out


def test_serve_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would use it")
    with pytest.raises(SystemExit, match="no CUDA device"):
        serve_mod.main(["--arch", "qwen2-0.5b"])


@pytest.mark.parametrize("arch_id", ("qwen2-0.5b", "gemma3-1b",
                                     "whisper-medium",
                                     "llama-3.2-vision-90b"))
def test_serve_greedy_tokens_equal_reference_loop(arch_id):
    """``serve`` with the reference's weights gives the tokens of the
    reference launcher's loop (``src/repro/launch/serve.py:44-64``), run
    here with the same weights, prompts and frames / patches (the
    launcher's ``normal(key, ...)``, handed to ``serve`` as
    ``cross_src``; the cross gates non-zero); gemma3's 16-slot rings wrap
    during the prompt and the decode."""
    batch, prompt_len, gen, seed = 3, 24, 8, 5
    rcfg = RC.get_arch(arch_id).smoke
    key = jax.random.PRNGKey(seed)
    rp = with_gates(jax.jit(RT.init_params, static_argnums=0)(rcfg, key))
    tokens = jax.random.randint(key, (batch, prompt_len), 0,
                                rcfg.vocab_size, jnp.int32)
    cross = None
    if rcfg.cross_seq:
        cross = jax.random.normal(
            key, (batch, rcfg.cross_seq, rcfg.d_model)).astype(rcfg.dtype)
    prefill = jax.jit(make_prefill_step(rcfg, max_seq=prompt_len + gen))
    decode = jax.jit(make_decode_step(rcfg))
    logits, cache = prefill(rp, tokens, cross)
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
                          params=interop.params_from(rp, "cpu"),
                          cross_src=None if cross is None else
                          torch.from_numpy(np.array(cross)))
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
