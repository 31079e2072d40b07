"""RAG quality metrics: RAGAS-style suite + LLM-judge, in-process.

Counterpart of generativeaiexamples_tpu/eval/metrics.py: six metrics
(answer_similarity, faithfulness, context_precision, context_relevancy,
answer_relevancy, context_recall), the harmonic "ragas_score" over four
of them, the model-free retrieval metrics (hit@1, hit@k, MRR) and the
few-shot Likert LLM judge. Metric prompts go to any ChatLLM connector
(the in-process engine, a remote API, a test fake); answer similarity
is the Embedder connector's cosine.

Dataset rows use the JAX harness's JSON schema (llm_answer_generator
output): {question, generated_answer, retrieved_context ([str] or str),
ground_truth_answer, ground_truth_context}.
"""

from __future__ import annotations

import json
import logging
import re
import statistics
from typing import Dict, List, Optional, Sequence

import numpy as np

_LOG = logging.getLogger(__name__)

_YES_RE = re.compile(r"\b(yes|true|1)\b", re.I)


def _ask_binary(llm, prompt: str) -> Optional[float]:
    """LLM yes/no probe -> 1.0/0.0 (None on unparseable or on a failed
    call — one bad probe must not null out the whole metric run)."""
    try:
        out = llm.chat([{"role": "user", "content": prompt}], max_tokens=8,
                       temperature=0.0)
    except Exception as e:
        _LOG.warning("binary probe failed (%s): %s",
                     type(e).__name__, str(e)[:200])
        return None
    if _YES_RE.search(out):
        return 1.0
    if re.search(r"\b(no|false|0)\b", out, re.I):
        return 0.0
    return None


def _mean(vals: Sequence[Optional[float]]) -> Optional[float]:
    vs = [v for v in vals if v is not None]
    return sum(vs) / len(vs) if vs else None


def _sentences(text: str) -> List[str]:
    return [s.strip() for s in re.split(r"(?<=[.!?])\s+", text) if s.strip()]


def _context_list(row: Dict) -> List[str]:
    ctx = row.get("retrieved_context") or []
    return [ctx] if isinstance(ctx, str) else list(ctx)


class RagasEvaluator:
    """Computes the metric suite for a dataset of rows."""

    def __init__(self, llm, embedder=None):
        self.llm = llm
        self.embedder = embedder

    # -- per-row metrics ---------------------------------------------------

    def faithfulness(self, row: Dict) -> Optional[float]:
        """Fraction of answer statements supported by the context."""
        ctx = "\n".join(_context_list(row))
        sents = _sentences(row["generated_answer"])[:8]
        if not sents or not ctx:
            return None
        return _mean([
            _ask_binary(self.llm,
                        f"Context:\n{ctx}\n\nStatement: {s}\n\nIs the "
                        "statement supported by the context? Answer yes or no.")
            for s in sents])

    def answer_relevancy(self, row: Dict) -> Optional[float]:
        return _ask_binary(
            self.llm,
            f"Question: {row['question']}\nAnswer: {row['generated_answer']}\n\n"
            "Does the answer directly address the question? Answer yes or no.")

    def context_relevancy(self, row: Dict) -> Optional[float]:
        """Fraction of retrieved chunks relevant to the question."""
        chunks = _context_list(row)[:8]
        if not chunks:
            return None
        return _mean([
            _ask_binary(self.llm,
                        f"Question: {row['question']}\nPassage: {c}\n\nIs the "
                        "passage relevant to answering the question? "
                        "Answer yes or no.")
            for c in chunks])

    def context_precision(self, row: Dict) -> Optional[float]:
        """Rank-weighted relevance of retrieved chunks (RAGAS-style
        precision@k averaged over ranks)."""
        chunks = _context_list(row)[:8]
        if not chunks:
            return None
        rel = [
            _ask_binary(self.llm,
                        f"Question: {row['question']}\nPassage: {c}\n\n"
                        "Is the passage useful for answering the question? "
                        "Answer yes or no.")
            for c in chunks]
        rel = [r or 0.0 for r in rel]
        precisions = []
        hits = 0
        for i, r in enumerate(rel):
            if r:
                hits += 1
                precisions.append(hits / (i + 1))
        return _mean(precisions) if precisions else 0.0

    def context_recall(self, row: Dict) -> Optional[float]:
        """Fraction of ground-truth-answer statements recoverable from
        the retrieved context."""
        gt = row.get("ground_truth_answer", "")
        ctx = "\n".join(_context_list(row))
        sents = _sentences(gt)[:8]
        if not sents or not ctx:
            return None
        return _mean([
            _ask_binary(self.llm,
                        f"Context:\n{ctx}\n\nFact: {s}\n\nCan this fact be "
                        "derived from the context? Answer yes or no.")
            for s in sents])

    def answer_similarity(self, row: Dict) -> Optional[float]:
        if self.embedder is None:
            return None
        gt = row.get("ground_truth_answer", "")
        if not gt:
            return None
        vecs = self.embedder.embed_documents(
            [gt, row.get("generated_answer", "")])
        a, b = np.asarray(vecs[0]), np.asarray(vecs[1])
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        return float(a @ b / denom) if denom else None

    # -- suite -------------------------------------------------------------

    METRICS = ("faithfulness", "context_relevancy", "answer_relevancy",
               "context_recall", "context_precision", "answer_similarity")
    RAGAS_COMPONENTS = ("faithfulness", "context_relevancy",
                        "answer_relevancy", "context_recall")

    def evaluate(self, rows: Sequence[Dict]) -> Dict:
        per_metric: Dict[str, List[Optional[float]]] = {m: [] for m in self.METRICS}
        for row in rows:
            for m in self.METRICS:
                try:
                    per_metric[m].append(getattr(self, m)(row))
                except Exception:
                    _LOG.exception("metric %s failed", m)
                    per_metric[m].append(None)
        result = {m: _mean(v) for m, v in per_metric.items()}
        result["ragas_score"] = calculate_ragas_score(result)
        return result


def calculate_ragas_score(result: Dict) -> Optional[float]:
    """Harmonic mean of the four core metrics."""
    vals = [result.get(m) for m in RagasEvaluator.RAGAS_COMPONENTS]
    if any(v is None or v <= 0 for v in vals):
        return 0.0 if any(v == 0 for v in vals if v is not None) else None
    return statistics.harmonic_mean(vals)


# ---------------------------------------------------------------------------
# Retrieval metrics (non-LLM) — hit@k / MRR vs ground_truth_context
# ---------------------------------------------------------------------------

_WORD = re.compile(r"\w+")


def _containment(gt: str, chunk: str) -> float:
    """Multiset token containment: the fraction of the ground-truth
    context's tokens present in the chunk. Chunking may split or pad
    the source passage, so exact/substring matching under-counts;
    containment >= 0.5 marks 'this chunk carries the passage'."""
    from collections import Counter

    gt_tf = Counter(_WORD.findall(gt.lower()))
    if not gt_tf:
        return 0.0
    ch_tf = Counter(_WORD.findall(chunk.lower()))
    inter = sum(min(n, ch_tf[w]) for w, n in gt_tf.items())
    return inter / sum(gt_tf.values())


def eval_retrieval(rows: Sequence[Dict],
                   match_threshold: float = 0.5) -> Dict:
    """Model-free retrieval quality vs each row's ground_truth_context:
    hit@1, hit@k (k = retrieved depth), and MRR. Unlike the RAGAS
    context_* metrics, no LLM grades anything — these numbers are
    meaningful even when the serving model is a seeded random-weight
    stand-in."""
    ranks: List[Optional[int]] = []
    depths: List[int] = []
    for row in rows:
        gt = row.get("ground_truth_context") or ""
        ctx = _context_list(row)
        if not gt or not ctx:
            continue
        depths.append(len(ctx))
        rank = next((i + 1 for i, c in enumerate(ctx)
                     if _containment(gt, c) >= match_threshold), None)
        ranks.append(rank)
    n = len(ranks)
    depth = max(depths, default=0)
    k_min = min(depths, default=0)
    if not n:
        return {"n_scored": 0, "hit_at_1": None, "hit_at_k": None,
                "hit_at_k_min": None, "k": depth, "k_min": k_min,
                "mrr": None, "match_threshold": match_threshold}
    return {
        "n_scored": n,
        "hit_at_1": sum(1 for r in ranks if r == 1) / n,
        # hit@k scores each row over ITS full retrieved depth; when
        # depths differ across rows (a threshold cut a short list, a
        # pipeline retrieved deeper) `k` is only the MAX depth, so the
        # label "hit@k" overstates what shallow rows were scored at.
        # hit_at_k_min re-scores every row at the same fixed depth
        # k_min (the one cutoff every row actually reaches) — the
        # comparable-across-rows number; k == k_min means depths were
        # homogeneous and the two metrics coincide.
        "hit_at_k": sum(1 for r in ranks if r is not None) / n,
        "hit_at_k_min": sum(1 for r in ranks
                            if r is not None and r <= k_min) / n,
        "mrr": sum(1.0 / r for r in ranks if r is not None) / n,
        "k": depth,
        "k_min": k_min,
        "match_threshold": match_threshold,
    }


# ---------------------------------------------------------------------------
# LLM judge (Likert 1-5, few-shot)
# ---------------------------------------------------------------------------

_JUDGE_PROMPT = """\
You are grading answers to questions on a 1-5 Likert scale:
5 = fully correct and complete, 4 = correct with minor omissions,
3 = partially correct, 2 = mostly incorrect, 1 = wrong or irrelevant.

Example:
Question: What color is the sky on a clear day?
Reference answer: Blue.
Candidate answer: The sky is blue.
{{"rating": 5, "explanation": "Matches the reference exactly."}}

Example:
Question: How many legs does a spider have?
Reference answer: Eight.
Candidate answer: Six legs.
{{"rating": 1, "explanation": "Factually wrong."}}

Now grade:
Question: {question}
Reference answer: {reference}
Candidate answer: {candidate}

Reply with one JSON object: {{"rating": <1-5>, "explanation": "..."}}"""


def eval_llm_judge(llm, rows: Sequence[Dict]) -> Dict:
    ratings, details = [], []
    for row in rows:
        out = llm.chat([{"role": "user", "content": _JUDGE_PROMPT.format(
            question=row["question"],
            reference=row.get("ground_truth_answer", ""),
            candidate=row.get("generated_answer", ""))}],
            max_tokens=256, temperature=0.0)
        m = re.search(r"\{.*\}", out, re.S)
        rating, expl = None, out.strip()
        if m:
            try:
                obj = json.loads(m.group(0))
                rating = float(obj.get("rating"))
                expl = obj.get("explanation", "")
            except (json.JSONDecodeError, TypeError, ValueError):
                pass
        if rating is None:
            num = re.search(r"\b([1-5])\b", out)
            rating = float(num.group(1)) if num else None
        ratings.append(rating)
        details.append({"question": row["question"], "rating": rating,
                        "explanation": expl})
    valid = [r for r in ratings if r is not None]
    return {
        "mean_rating": sum(valid) / len(valid) if valid else None,
        "rated": len(valid), "total": len(rows), "details": details,
    }
