"""Port parity: eval/{metrics,harness,__main__}.py.

The metrics are pure Python over a ChatLLM and an Embedder connector:
on equal inputs (each package's scripted fakes with one script) they are
exactly equal. The harness runs over a scripted LLM and a stub chain
server (the port's ChainServer over echo and hash fakes) through both
packages' clients; the CLI runs --offline over the same corpus and
must write an equal report.
"""

import json
import os
import subprocess
import sys
import threading

import pytest

from generativeaiexamples_tpu.connectors.fakes import (
    EchoLLM as JEcho, HashEmbedder as JHash)
from generativeaiexamples_tpu.eval import harness as jh
from generativeaiexamples_tpu.eval import metrics as jm
from generativeaiexamples_tpu_torch.connectors.fakes import (
    EchoLLM, HashEmbedder)
from generativeaiexamples_tpu_torch.eval import harness as th
from generativeaiexamples_tpu_torch.eval import metrics as tm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ROWS = [
    {"question": "How much memory does the card have?",
     "generated_answer": "It has 80 GB. It is fast! Really?",
     "retrieved_context": ["The card has 80 GB of HBM.", "Unrelated text.",
                           "HBM is fast memory on the card."],
     "ground_truth_answer": "80 GB per card. Fast memory.",
     "ground_truth_context": "The card has 80 GB of HBM"},
    {"question": "What is a page?", "generated_answer": "",
     "retrieved_context": "A page holds KV slots.",
     "ground_truth_answer": "A block of KV slots.",
     "ground_truth_context": "nothing like it"},
    {"question": "No context here", "generated_answer": "Maybe.",
     "retrieved_context": [], "ground_truth_answer": ""},
]


def _scripted(echo):
    """Answers that depend on the prompt: yes, no, garbage, a failure."""

    class Scripted(echo):
        def stream_chat(self, messages, **kw):
            self.calls.append(list(messages))
            text = messages[-1]["content"]
            if "Unrelated" in text:
                yield "No"
            elif "Really?" in text:
                yield "perhaps"
            elif "Fast memory" in text:
                raise RuntimeError("probe timeout")
            elif "grading answers" in text and "page" in text:
                yield 'Rating: {"rating": "x"} then 3'
            elif "grading answers" in text:
                yield '{"rating": 4, "explanation": "close"}'
            else:
                yield "Yes, true."

    return Scripted()


def test_ragas_suite_and_score_equal_jax():
    got = tm.RagasEvaluator(_scripted(EchoLLM), HashEmbedder(32)) \
        .evaluate(ROWS)
    want = jm.RagasEvaluator(_scripted(JEcho), JHash(32)).evaluate(ROWS)
    assert got == want
    assert set(got) == set(jm.RagasEvaluator.METRICS) | {"ragas_score"}
    assert tm.RagasEvaluator.METRICS == jm.RagasEvaluator.METRICS
    for vals in ({"faithfulness": 1.0, "context_relevancy": 0.5,
                  "answer_relevancy": 1.0, "context_recall": 0.5},
                 {"faithfulness": 0.0, "context_relevancy": 0.5,
                  "answer_relevancy": None, "context_recall": 1.0},
                 {"faithfulness": None}, {}):
        assert tm.calculate_ragas_score(vals) == \
            jm.calculate_ragas_score(vals)


def test_retrieval_metrics_and_judge_equal_jax():
    for rows in (ROWS, ROWS[:1], [], ROWS[2:]):
        for thr in (0.5, 0.9):
            assert tm.eval_retrieval(rows, thr) == \
                jm.eval_retrieval(rows, thr)
    got = tm.eval_llm_judge(_scripted(EchoLLM), ROWS)
    want = jm.eval_llm_judge(_scripted(JEcho), ROWS)
    assert got == want
    # Row 0's answer ends "Really?", which the script answers unrated.
    assert got["rated"] == 2 and got["mean_rating"] == pytest.approx(3.5)


def test_synthetic_qa_equal_jax():
    script = [("chunk-1", '{"question": "Q1?", "answer": "A1"}'),
              ("chunk-2", 'noise {"question": "Q2?"} noise'),
              ("chunk-3", "no json"),
              ("chunk-4", '{"question": "Q4?", "answer": "A4"}')]
    chunks = ["chunk-1", "chunk-2", "chunk-3", "chunk-4"]
    for n in (None, 2):
        got = th.generate_synthetic_qa(EchoLLM(script=script), chunks, n)
        want = jh.generate_synthetic_qa(JEcho(script=script), chunks, n)
        assert got == want
    assert [r["question"] for r in got] == ["Q1?"]
    got = th.generate_synthetic_qa(EchoLLM(script=script), chunks)
    assert [r["question"] for r in got] == ["Q1?", "Q4?"]


def _stub_chain(tmp_path):
    from generativeaiexamples_tpu_torch.api.server import (
        ChainServer, make_http_server)
    from generativeaiexamples_tpu_torch.config.schema import load_config
    from generativeaiexamples_tpu_torch.connectors.factory import EngineHub
    from generativeaiexamples_tpu_torch.pipelines.base import (
        get_example_class)
    from generativeaiexamples_tpu_torch.pipelines.resources import Resources

    cfg = load_config(path="", env={})
    res = Resources(cfg, hub=EngineHub(cfg, device="cpu"), llm=EchoLLM(),
                    embedder=HashEmbedder(64), reranker=None)
    app = ChainServer(cfg, example=get_example_class("developer_rag")(res),
                      upload_dir=str(tmp_path))
    httpd = make_http_server(app, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    def stop():
        httpd.shutdown()
        httpd.server_close()
        app.close()

    return f"http://127.0.0.1:{httpd.server_address[1]}", stop


def test_harness_rows_and_report_equal_jax(tmp_path):
    doc = tmp_path / "corpus.txt"
    doc.write_text("The card carries eighty gigabytes of memory. Pages hold "
                   "key and value slots for each sequence.")
    qa = [{"question": "How much memory?", "ground_truth_answer": "80 GB",
           "ground_truth_context": "eighty gigabytes of memory"},
          {"question": "What do pages hold?",
           "ground_truth_answer": "KV slots", "ground_truth_context": "x"}]
    rows = {}
    for pkg, mod in (("jax", jh), ("port", th)):
        base, stop = _stub_chain(tmp_path / pkg)
        try:
            client = mod.ChainServerClient(base + "/")
            client.upload(str(doc))
            rows[pkg] = mod.generate_answers(client, qa, top_k=2)
            assert client.generate("hi", use_kb=False, max_tokens=8)
        finally:
            stop()
    assert rows["port"] == rows["jax"]
    assert rows["port"][0]["retrieved_context"]
    reports = {}
    for pkg, mod, echo, hash_ in (("jax", jh, JEcho, JHash),
                                  ("port", th, EchoLLM, HashEmbedder)):
        reports[pkg] = mod.run_eval(_scripted(echo), hash_(32), rows[pkg],
                                    judge_llm=_scripted(echo))
        mod.save_report(reports[pkg], str(tmp_path / pkg / "r" / "x.json"))
    assert reports["port"] == reports["jax"]
    assert set(reports["port"]) == {"ragas", "llm_judge", "retrieval", "n"}
    assert (tmp_path / "port" / "r" / "x.json").read_text() == \
        (tmp_path / "jax" / "r" / "x.json").read_text()


def _cli(pkg, args, tmp_path):
    out = tmp_path / f"{pkg}.json"
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("APP_CONFIG_FILE", None)
    proc = subprocess.run(
        [sys.executable, "-m", pkg + ".eval", *args, "--out", str(out)],
        capture_output=True, text=True, cwd=ROOT, timeout=240, env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    return summary, json.loads(out.read_text())


def test_offline_cli_writes_the_jax_report(tmp_path):
    corpus = tmp_path / "corpus"
    corpus.mkdir()
    (corpus / "a.txt").write_text(
        "Ring attention rotates key and value blocks over links. "
        "The paged KV cache stores int8 codes with narrow scales.")
    (corpus / "b.txt").write_text("Speculative decoding drafts tokens and "
                                  "verifies them in one forward pass.")
    qa = tmp_path / "qa.json"
    qa.write_text(json.dumps([{"question": "What rotates?",
                               "answer": "key and value blocks"}]))
    for args in (["--docs", str(corpus), "--offline", "--max-pairs", "2",
                  "--note", "fakes"],
                 ["--docs", str(corpus / "a.txt"), "--offline",
                  "--qa-file", str(qa)]):
        jsum, jrep = _cli("generativeaiexamples_tpu", args, tmp_path)
        tsum, trep = _cli("generativeaiexamples_tpu_torch", args, tmp_path)
        assert trep == jrep
        assert {k: v for k, v in tsum.items() if k != "report"} == \
            {k: v for k, v in jsum.items() if k != "report"}
        assert trep["environment"]["mode"] == "offline-fakes"
        for key in ("ragas", "llm_judge", "retrieval", "rows", "n"):
            assert key in trep
