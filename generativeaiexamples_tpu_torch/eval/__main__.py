"""Evaluation CLI: `python -m generativeaiexamples_tpu_torch.eval`.

Counterpart of generativeaiexamples_tpu/eval/__main__.py, with its flags
and report: [1] synthesize QA pairs from the corpus, [2] upload the
corpus and generate answers through a running chain server, [3]
RAGAS-style metrics + harmonic ragas_score, [4] LLM-judge Likert
ratings. `--device` (cuda unless cpu is asked) places the in-process
engines a config's `tpu` connectors build; `--offline` runs on fakes and
touches no device.

Hermetic dry run (fakes, no server):
    python -m generativeaiexamples_tpu_torch.eval --docs README.md --offline

Against a live chain server:
    python -m generativeaiexamples_tpu_torch.eval --docs docs/*.md \\
        --server http://localhost:8081 --out eval_report.json
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

_LOG = logging.getLogger(__name__)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--docs", nargs="+", required=True,
                    help="corpus files (or directories of files) to "
                         "evaluate over — directories expand non-"
                         "recursively, as the compose eval service "
                         "mounts the corpus at /corpus")
    ap.add_argument("--server", default="http://localhost:8081",
                    help="chain server base URL")
    ap.add_argument("--offline", action="store_true",
                    help="hermetic: fake LLM/embedder, in-process pipeline "
                         "instead of a server (smoke/CI mode)")
    ap.add_argument("--qa-file", default="",
                    help="JSON list of {question, answer} rows: skip "
                         "synthetic QA generation and evaluate this "
                         "dataset (the reference's bring-your-own qna.json "
                         "mode, tools/evaluation/rag_evaluator)")
    ap.add_argument("--note", action="append", default=[],
                    help="environment/limitation note recorded verbatim in "
                         "the report (repeatable)")
    ap.add_argument("--max-pairs", type=int, default=8)
    ap.add_argument("--out", default="eval_report.json")
    ap.add_argument("--device", default=None,
                    help="device of in-process engines: cuda (default) "
                         "or cpu")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args()
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)
    args.docs = [f for p in args.docs
                 for f in (sorted(
                     os.path.join(p, e) for e in os.listdir(p)
                     if os.path.isfile(os.path.join(p, e)))
                     if os.path.isdir(p) else [p])]
    if not args.docs:
        print("no corpus files found", file=sys.stderr)
        return 1

    from generativeaiexamples_tpu_torch.config.wizard import load_config
    from generativeaiexamples_tpu_torch.connectors import factory
    from generativeaiexamples_tpu_torch.eval import harness
    from generativeaiexamples_tpu_torch.rag.documents import load_document
    from generativeaiexamples_tpu_torch.rag.splitter import get_text_splitter

    cfg = load_config(None)
    # The fakes of --offline run on no device; the hub is only the
    # owner Resources expects.
    hub = factory.EngineHub(cfg, device="cpu" if args.offline
                            else args.device)
    if args.offline:
        from generativeaiexamples_tpu_torch.connectors.fakes import EchoLLM
        from generativeaiexamples_tpu_torch.connectors.lexical import (
            LexicalEmbedder)

        # Scripted fake LLM: enough structure to exercise all four
        # stages (patterns match the ACTUAL harness/metrics prompts).
        # The embedder is NOT a fake — lexical TF-IDF retrieval is the
        # real model-free retrieval path the retrieval metrics measure.
        llm = EchoLLM(script=[
            ("question-answer pair",
             '{"question": "What does the passage describe?", '
             '"answer": "The main subject of the passage."}'),
            ("You are grading answers",
             '{"rating": 4, "explanation": "close to the reference"}'),
        ])
        embedder = LexicalEmbedder(1024)
    else:
        llm = factory.get_llm(cfg, hub)
        embedder = factory.get_embedder(cfg, hub)

    # [1] QA dataset: user-provided (--qa-file) or synthesized from
    # corpus chunks
    if args.qa_file:
        with open(args.qa_file) as fh:
            qa_rows = json.load(fh)
        assert all("question" in r and "answer" in r for r in qa_rows), \
            "--qa-file rows need question + answer"
        # The metric suite reads the reference answer under the
        # harness's row key (ground_truth_answer).
        qa_rows = [{**r, "ground_truth_answer": r.get(
            "ground_truth_answer", r["answer"])} for r in qa_rows]
        _LOG.info("loaded %d QA pairs from %s", len(qa_rows), args.qa_file)
    else:
        splitter = get_text_splitter(cfg)
        chunks = []
        for path in args.docs:
            for d in load_document(path, path):
                chunks.extend(splitter.split(d.text))
        _LOG.info("corpus: %d files -> %d chunks", len(args.docs),
                  len(chunks))
        qa_rows = harness.generate_synthetic_qa(llm, chunks,
                                                n_pairs=args.max_pairs)
        if not qa_rows:
            print("no QA pairs generated (is the LLM reachable?)",
                  file=sys.stderr)
            return 1
        _LOG.info("synthesized %d QA pairs", len(qa_rows))

    # [2] answers through the chain server (or, offline, the in-process
    # developer_rag pipeline)
    if args.offline:
        from generativeaiexamples_tpu_torch.pipelines.base import get_example_class
        from generativeaiexamples_tpu_torch.pipelines.resources import Resources

        res = Resources(cfg, hub=hub, llm=llm, embedder=embedder,
                        reranker=None)
        ex = get_example_class("developer_rag")(res)
        for path in args.docs:
            ex.ingest_docs(path, path)
        rows = []
        for qa in qa_rows:
            ctx = [h["content"] for h in
                   ex.document_search(qa["question"], 4)]
            answer = "".join(ex.rag_chain(qa["question"], [],
                                          max_tokens=256))
            # Same row schema as the server path (generate_answers
            # spreads the full QA row in).
            rows.append({**qa, "generated_answer": answer,
                         "retrieved_context": ctx})
    else:
        client = harness.ChainServerClient(args.server)
        for path in args.docs:
            client.upload(path)
        rows = harness.generate_answers(client, qa_rows)

    # [3] RAGAS-style metrics + [4] LLM judge (harness.run_eval owns
    # the report shape; evaluate() computes ragas_score itself)
    report = harness.run_eval(llm, embedder, rows)
    # Provenance inside the artifact: which connectors produced these
    # numbers, and any environment limitations.
    report["environment"] = {
        "mode": "offline-fakes" if args.offline else "chain-server",
        "server": None if args.offline else args.server,
        "grader_llm": type(llm).__name__,
        "embedder": type(embedder).__name__,
        "qa_source": args.qa_file or "synthesized",
        "notes": args.note,
    }
    report["rows"] = rows
    harness.save_report(report, args.out)
    hub.close()
    print(json.dumps({"ragas_score": report["ragas"].get("ragas_score"),
                      "llm_judge_mean":
                          report["llm_judge"].get("mean_rating"),
                      "n_questions": len(rows), "report": args.out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
