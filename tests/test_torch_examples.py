"""The port's examples driven on the CPU.  ``quickstart_torch.py`` at a
small corpus: it builds, searches, inserts and finds an inserted vector.
``rag_serving_torch.py`` at the smoke configuration: its embeddings equal
the reference example's with the same weights, and its retrieval's
recall@5 is the reference engine's.  ``train_lm_torch.py`` at 3 steps of
2 x 32 tokens: its printed lines, then a resume from a checkpoint at
step 1.  Without a card and without ``--device cpu`` each stops."""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401

_EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  _EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def quickstart():
    return _load("quickstart_torch")


@pytest.fixture(scope="module")
def rag():
    return _load("rag_serving_torch")


@pytest.fixture(scope="module")
def train_lm():
    return _load("train_lm_torch")


def test_quickstart_torch_runs_on_cpu(quickstart, capsys):
    recall, nearest, first_new = quickstart.main(["--device", "cpu",
                                                  "--n", "400"])
    out = capsys.readouterr().out
    assert "built 400 vertices on cpu" in out
    assert recall >= 0.9
    assert nearest == first_new


def test_quickstart_torch_needs_a_card_by_default(quickstart):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would use it")
    with pytest.raises(SystemExit, match="no CUDA device"):
        quickstart.main([])


def test_rag_serving_torch_runs_on_cpu(rag, capsys):
    out = rag.main(["--device", "cpu"])
    assert "indexed 512 docs" in capsys.readouterr().out
    assert out["docs"].shape == (512, 64) and out["ids"].shape[0] == 4
    assert out["recall"] >= 0.9


def test_rag_serving_torch_needs_a_card_by_default(rag):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would use it")
    with pytest.raises(SystemExit, match="no CUDA device"):
        rag.main([])


def test_train_lm_torch_runs_and_resumes_on_cpu(train_lm, tmp_path, capsys):
    """Three steps print the parameter count, the JSON lines of steps 0
    and 2 (its logging cadence: every 25th and the last) and the time; a
    checkpoint at step 1 in the reference's layout (the example's own
    params and AdamW state, as a run of 100 steps would commit them) is
    resumed, and step 2 runs from it."""
    import json

    from repro_torch import checkpoint as ckpt
    from repro_torch.models import transformer as T
    from repro_torch.train.optimizer import adamw
    from repro_torch.train.train_step import init_opt_state

    args = ["--steps", "3", "--batch", "2", "--seq", "32", "--ckpt",
            str(tmp_path), "--device", "cpu"]
    assert train_lm.main(args) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "params: 40.5M"
    beats = [json.loads(ln) for ln in lines[1:-1]]
    assert [b["step"] for b in beats] == [0, 2]
    assert all(np.isfinite(b["loss"]) and b["tok_per_s"] > 0
               for b in beats)
    assert lines[-1].startswith("done in ")
    assert ckpt.latest_step(tmp_path) is None     # no commit before 100

    cfg = train_lm.CFG_100M
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    state = init_opt_state(cfg, adamw(state_dtype="float32"), params)
    ckpt.save(tmp_path, 1, {"params": params, "opt": state})
    assert train_lm.main(args) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == "resumed from step 1"
    assert [json.loads(ln)["step"] for ln in lines[2:-1]] == [2]


def test_train_lm_torch_needs_a_card_by_default(train_lm):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would use it")
    with pytest.raises(SystemExit, match="no CUDA device"):
        train_lm.main([])


def test_rag_serving_torch_matches_reference(rag):
    """The reference example's weights carried across: the same document
    and query tokens, embeddings within 1e-4, and recall@5 against brute
    force over the 512 embeddings within 0.02 of the reference engine's on
    its own embeddings (64 queries; a port build is held by recall, not
    bit for bit, as in ``test_torch_build.py``)."""
    from repro import configs as RC
    from repro.core import Engine as RefEngine
    from repro.core import brute_force_topk as ref_truth
    from repro.models import transformer as RT
    from repro_torch import configs as PC
    from repro_torch import interop
    from repro_torch import random as jr
    from repro_torch.core import brute_force_topk, recall_at_k
    import jax.numpy as jnp

    ref_rag = _load("rag_serving")
    # one compile for all batches (eager, each forward's scan compiles)
    ref_embed = jax.jit(ref_rag.embed_queries, static_argnums=0)
    rcfg = RC.get_arch("qwen2-0.5b").smoke
    pcfg = PC.get_arch("qwen2-0.5b").smoke
    key = jax.random.PRNGKey(0)
    rp = jax.jit(RT.init_params, static_argnums=0)(rcfg, key)
    pp = interop.params_from(rp, "cpu")
    pkey = jr.PRNGKey(0)

    doc_tokens = rag.document_tokens(pcfg, pkey, "cpu")
    for i, t in enumerate(doc_tokens):
        np.testing.assert_array_equal(t.numpy(), np.asarray(
            jax.random.randint(jax.random.fold_in(key, i), (64, 32), 0,
                               rcfg.vocab_size, jnp.int32)))
    q_tokens = rag.query_tokens(pcfg, pkey, 64, "cpu")
    np.testing.assert_array_equal(q_tokens.numpy(), np.asarray(
        jax.random.randint(jax.random.fold_in(key, 1234), (64, 32), 0,
                           rcfg.vocab_size, jnp.int32)))

    docs = rag.embed_queries(pcfg, pp, doc_tokens)
    qs = rag.embed_queries(pcfg, pp, [q_tokens])
    ref_docs = ref_embed(rcfg, rp, [jnp.asarray(t.numpy())
                                    for t in doc_tokens])
    ref_qs = ref_embed(rcfg, rp, [jnp.asarray(q_tokens.numpy())])
    for got, want in ((docs, ref_docs), (qs, ref_qs)):
        torch.testing.assert_close(got, torch.from_numpy(np.array(want)),
                                   rtol=1e-4, atol=1e-4)

    eng, state = rag.build_index(docs, pkey, "cpu")
    ids, _, _, _ = eng.search_many(state, qs)
    recall = recall_at_k(ids[:, :rag.TOP],
                         brute_force_topk(qs, docs, 512, rag.TOP))
    ref_eng = RefEngine(_ref_spec(eng.spec))
    ref_state = ref_eng.build(jax.random.fold_in(key, 99), ref_docs)
    ref_ids, _, _, _ = ref_eng.search_many(ref_state, ref_qs)
    truth = np.array(ref_truth(ref_qs, ref_docs, 512, rag.TOP))
    ref_recall = recall_at_k(torch.from_numpy(np.array(ref_ids)[:, :rag.TOP]),
                             torch.from_numpy(truth))
    print(f"recall@5: port {recall}, reference {ref_recall}")
    assert recall >= 0.9 and abs(recall - ref_recall) <= 0.02, \
        (recall, ref_recall)


def _ref_spec(spec):
    """The reference's ``EngineSpec`` with the port spec's fields."""
    import dataclasses

    from repro.core import EngineSpec
    return EngineSpec(**{f.name: getattr(spec, f.name)
                         for f in dataclasses.fields(EngineSpec)})
