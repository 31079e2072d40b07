"""Port parity of the chain's pipelines (pipelines/*.py) on the hermetic
fakes: each scenario of tests/test_pipelines.py runs in both packages
over the same scripted EchoLLM and HashEmbedder, and must send the same
LLM messages, stream the same pieces and leave the same store and
conversation-store contents (texts, metadata and embeddings equal).
Also: the arithmetic and pandas-expression guards give the JAX verdicts,
`create_vector_store(ephemeral=...)` picks the JAX kinds, the config
reads the multi-turn template and the `vlm` section as the JAX wizard
does, and /metrics reports the conversation store.
"""

import asyncio
import dataclasses
import json

import numpy as np
import pytest

from generativeaiexamples_tpu.config.wizard import load_config as jload
from generativeaiexamples_tpu.connectors.fakes import (
    EchoLLM as JEcho, HashEmbedder as JHash)
from generativeaiexamples_tpu.pipelines import (
    query_decomposition as jqd, structured_data as jsd)
from generativeaiexamples_tpu.pipelines.base import (
    get_example_class as jget, list_examples as jlist)
from generativeaiexamples_tpu.pipelines.resources import (
    Resources as JResources)
from generativeaiexamples_tpu.rag import vectorstore as jvs
from generativeaiexamples_tpu_torch.api.server import ChainServer
from generativeaiexamples_tpu_torch.config.schema import load_config
from generativeaiexamples_tpu_torch.connectors.factory import EngineHub
from generativeaiexamples_tpu_torch.connectors.fakes import (
    EchoLLM, HashEmbedder)
from generativeaiexamples_tpu_torch.pipelines import (
    query_decomposition as tqd, structured_data as tsd)
from generativeaiexamples_tpu_torch.pipelines.base import (
    get_example_class as tget, list_examples as tlist)
from generativeaiexamples_tpu_torch.pipelines.resources import Resources
from generativeaiexamples_tpu_torch.rag import vectorstore as tvs

HISTORY = [{"role": "user", "content": "Tell me about the chip."},
           {"role": "assistant", "content": "It has an MXU."}]
FACTS = "TPU v5e has 16 GB HBM.\nMXU is a systolic array.\n"
FACT_CHECK = [("Fact-check", "TRUE: every claim is in the context.")]


def _pair(script=None, env=None, llm=None):
    """(JAX Resources, port Resources) on the same config env and fakes;
    `llm(base_class)` builds a custom LLM on each side."""
    env = dict(env or {})
    jres = JResources(jload(path="", env=env),
                      llm=llm(JEcho) if llm else JEcho(script=script),
                      embedder=JHash(64), reranker=None)
    tcfg = load_config(env=env)
    tres = Resources(tcfg, hub=EngineHub(tcfg, device="cpu"),
                     llm=llm(EchoLLM) if llm else EchoLLM(script=script),
                     embedder=HashEmbedder(64), reranker=None)
    return jres, tres


def _rows(store):
    """A store's rows [N, D] as host f32 (the port's stores and the JAX
    host store)."""
    if hasattr(store, "_host_rows"):
        return np.asarray(store._host_rows())
    return np.asarray(store._vecs)


def assert_same_store(jstore, tstore):
    assert tstore.snapshot_docs() == jstore.snapshot_docs()
    np.testing.assert_array_equal(_rows(tstore), _rows(jstore))


def _ingest(ex, tmp_path, name="facts.txt", text=FACTS):
    p = tmp_path / name
    p.write_text(text)
    ex.ingest_docs(str(p), name)


def test_registries_list_the_same_seven_names():
    assert tlist() == jlist() == sorted([
        "developer_rag", "multi_turn_rag", "api_catalog",
        "query_decomposition", "structured_data", "multimodal",
        "knowledge_graph"])
    with pytest.raises(KeyError, match="unknown example 'nope'"):
        tget("nope")


@pytest.mark.parametrize("fact_check", [False, True])
def test_multi_turn_rag_saves_and_uses_memory_like_jax(tmp_path, fact_check):
    env = {"APP_RETRIEVER_FACTCHECK": "true"} if fact_check else {}
    sides = []
    for res, get in zip(_pair(FACT_CHECK, env), (jget, tget)):
        ex = get("multi_turn_rag")(res)
        _ingest(ex, tmp_path)
        out1 = list(ex.rag_chain("how much HBM does v5e have", []))
        n1 = len(res.conv_store)
        out2 = list(ex.rag_chain("what did I just ask about", HISTORY))
        out3 = list(ex.llm_chain("and the MXU?", HISTORY))
        sides.append((res, [out1, out2, out3], n1))
    (jres, jout, jn1), (tres, tout, tn1) = sides
    assert tout == jout
    assert tres.llm.calls == jres.llm.calls
    assert tn1 == jn1 == 1 and len(tres.conv_store) == 3
    assert_same_store(jres.store, tres.store)
    assert_same_store(jres.conv_store, tres.conv_store)
    # The second turn's prompt carries the first turn's saved text, and
    # only the answer is saved (not the fact-check verdict).
    first = tres.conv_store.snapshot_docs()[0]
    assert first["text"] == ("User: how much HBM does v5e have\nAssistant: "
                             "ECHO: how much HBM does v5e have")
    assert first["metadata"] == {"filename": "__conversation__"}
    rag_calls = [c for c in tres.llm.calls
                 if "Conversation history:" in c[0]["content"]]
    assert first["text"] in rag_calls[1][0]["content"]
    assert all("[fact-check]" not in d["text"]
               for d in tres.conv_store.snapshot_docs())
    assert ("\n\n[fact-check] " in tout[0]) == fact_check


@pytest.mark.parametrize("kb", [True, False])
def test_api_catalog_stuffs_context_into_the_user_message_like_jax(
        tmp_path, kb):
    sides = []
    for res, get in zip(_pair(), (jget, tget)):
        ex = get("api_catalog")(res)
        if kb:
            _ingest(ex, tmp_path)
        sides.append((res, list(ex.rag_chain("HBM capacity?", HISTORY))))
    (jres, jout), (tres, tout) = sides
    assert tout == jout and tres.llm.calls == jres.llm.calls
    sent = tres.llm.calls[-1]
    assert sent[1:3] == HISTORY and sent[-1]["role"] == "user"
    assert ("Context:" in sent[-1]["content"]) == kb
    if kb:
        assert "HBM" in sent[-1]["content"]


def _seq_llm(replies):
    """An EchoLLM builder whose decision replies come from `replies` in
    order; the search tool's sub-answers are fixed."""
    def build(base):
        it = iter(replies)

        class Seq(base):
            def stream_chat(self, messages, **kw):
                self.calls.append(list(messages))
                if "Answer briefly and only from the context" in str(
                        messages[0]):
                    yield "16 GB per chip"
                    return
                yield next(it, "final answer text")

        return Seq()
    return build


DECOMPOSITIONS = {
    "search_math_final": [
        '{"action": "search", "input": "what is the HBM of v5e"}',
        '{"action": "math", "input": "16 * 8"}',
        '{"action": "final", "answer": "done"}'],
    "list_search": [
        '{"action": "search", "input": ["what is the HBM of v5e", '
        '"what is the MXU", " "]}',
        '{"action": "final", "answer": "done"}'],
    "budget": [
        json.dumps({"action": "search",
                    "input": [f"sub question {i}" for i in range(9)]}),
        '{"action": "search", "input": "one more"}'],
    "depth": ['{"action": "search", "input": "a"}'] * 4,
    "malformed": ["I think the answer is 7."],
    "bad_math": ['{"action": "math", "input": "__import__(\'os\')"}',
                 '{"action": "math", "input": "1 / 0"}'],
}


@pytest.mark.parametrize("case", sorted(DECOMPOSITIONS))
def test_query_decomposition_agent_matches_jax(tmp_path, case):
    sides = []
    for res, get in zip(_pair(llm=_seq_llm(DECOMPOSITIONS[case])),
                        (jget, tget)):
        ex = get("query_decomposition")(res)
        _ingest(ex, tmp_path)
        sides.append((res, list(ex.rag_chain("total HBM of 8 chips?", []))))
    (jres, jout), (tres, tout) = sides
    assert tout == jout and tres.llm.calls == jres.llm.calls
    final_prompt = tres.llm.calls[-1][-1]["content"]
    if case == "search_math_final":
        assert "16 GB per chip" in final_prompt and "128" in final_prompt
    if case == "budget":  # the list spends the whole search budget
        assert final_prompt.count("- Q: sub question") == tqd.MAX_STEPS


def test_sub_questions_ride_one_embed_and_one_search_batch(tmp_path):
    """A list of sub-questions reaches the embedder as one embed_queries
    call and the store as one search_batch dispatch."""
    _, tres = _pair(llm=_seq_llm(DECOMPOSITIONS["list_search"]))
    ex = tget("query_decomposition")(tres)
    _ingest(ex, tmp_path)
    calls = {"embed_queries": [], "search_batch": 0, "search": 0}
    real_eq, real_sb = tres.embedder.embed_queries, tres.store.search_batch

    def eq(texts):
        calls["embed_queries"].append(len(texts))
        return real_eq(texts)

    def sb(*a, **k):
        calls["search_batch"] += 1
        return real_sb(*a, **k)

    def s(*a, **k):
        calls["search"] += 1
        raise AssertionError("single search")

    tres.embedder.embed_queries, tres.store.search_batch = eq, sb
    tres.store.search = s
    list(ex.rag_chain("total HBM?", []))
    assert calls == {"embed_queries": [2], "search_batch": 1, "search": 0}


MATH = ["(120 - 85) / 85 * 100", "2 ^ 3", "1,000 + 2", "-3 ** 2", "7 // 2",
        "7 % 3", "+4", "1 / 0", "__import__('os')", "open('/etc/passwd')",
        "x + 1", "[1]*9", "(1).__class__", "lambda: 1", "'a' * 3",
        "2 +", "True + 1", "abs(-1)", "1 if 1 else 2"]


def _verdict(fn, *args):
    try:
        return ("ok", repr(fn(*args)))
    except Exception as e:  # the verdict is the exception's kind and text
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("expr", MATH)
def test_safe_eval_arithmetic_verdicts_match_jax(expr):
    got = _verdict(tqd.safe_eval_arithmetic, expr)
    assert got == _verdict(jqd.safe_eval_arithmetic, expr)
    assert tqd._DECIDE_PROMPT == jqd._DECIDE_PROMPT
    assert tqd._FINAL_PROMPT == jqd._FINAL_PROMPT
    assert (tqd.MAX_STEPS, tqd.MAX_DEPTH) == (jqd.MAX_STEPS, jqd.MAX_DEPTH)


def test_ledger_and_action_parser_match_jax():
    for text in ('{"action": "search", "input": "x"}', "no json here",
                 '{"answer": 1}', '[1, 2]', '{bad json}',
                 'pre {"action": "final", "answer": "a"} post'):
        assert tqd._parse_action(text) == jqd._parse_action(text)
    tl, jl = tqd.Ledger(), jqd.Ledger()
    assert tl.render() == jl.render() == "(none yet)"
    for lg in (tl, jl):
        lg.add("q1", "a1")
        lg.add("q2", "a2")
    assert tl.render() == jl.render()


GOOD_EXPRS = ["df['x'].sum()", "df['x'].to_list()",
              "df['x'].apply(lambda v: v * 2).sum()",
              "df[df['x'] > 1]['x'].mean()", "df.shape",
              "[v for v in df['x']]", "np.mean(df['x'])",
              "pd.Series([1, 2]).max()", "df.describe()"]
BAD_EXPRS = [
    # tests/test_pipelines.py's
    "df.to_csv('/tmp/x')", "__import__('os')", "open('/etc/passwd')",
    "df['x'].sum(); 1", "df.to_json('/tmp/x.json')",
    "df.to_hdf('/tmp/x.h5', 'k')", "df.to_feather('/tmp/x')",
    "df.to_stata('/tmp/x.dta')", "df.to_html('/tmp/x.html')",
    "df.to_latex('/tmp/x.tex')", "df.__class__",
    "getattr(df, 'to_' + 'csv')('/tmp/x')", "pd.eval('1+1')",
    "np.save('/tmp/x.npy', df.values)", "df.to_string(buf='/tmp/x')",
    "[x for x in ().__class__.__bases__]",
    "df.x.sum() if True else exec('1')",
    "np.lib.format.open_memmap('/tmp/p.npy', mode='w+', shape=(4,), "
    "dtype='u1')", "np.ctypeslib.load_library('evil', '/tmp')",
    "df['x'].agg('to_csv')", "df.apply('to_pickle')",
    # attribute and dunder escapes
    "df.x.__globals__", "df._data", "df['x'].__len__()",
    "df.x.sum.__self__", "().__class__.__base__.__subclasses__()",
    "pd.io.common", "np.core.multiarray", "pd.read_csv('/etc/passwd')",
    "df.query('x > 1')", "df.pipe(print)", "df.eval('x + 1')",
    "np.load('/tmp/x.npy')", "df.to_pickle('/tmp/x')",
    "df.apply('__class__')", "df.x.agg('_data')",
    # imports and builtins
    "import os", "from os import system", "exec('1')", "eval('1')",
    "globals()", "__builtins__", "breakpoint()", "vars(df)",
    # lambda and comprehension escapes
    "(lambda: __import__('os'))()", "(lambda f: f)(open)",
    "df.apply(lambda r: r.to_csv('/tmp/x'))",
    "[c for c in ().__class__.__base__.__subclasses__()]",
    "(lambda g=globals: g())()", "[y for y in [open]][0]('/etc/passwd')",
    "df.apply(lambda r: os)", "x := 1", "df.x.sum()\nimport os",
    "await df", "f'{df}'", "df.to_excel('/tmp/x.xlsx')",
    "df.to_sql('t', 'sqlite:////tmp/x')", "df.x.sum(engine='c')",
]


@pytest.mark.parametrize("expr", GOOD_EXPRS + BAD_EXPRS)
def test_pandas_expression_guard_verdicts_match_jax(expr):
    """The guard is a security boundary: its verdicts (and the values it
    lets through) equal the JAX guard's on every expression."""
    import pandas as pd

    df = pd.DataFrame({"x": [1, 2]})
    got = _verdict(tsd.run_pandas_expression, expr, df)
    assert got == _verdict(jsd.run_pandas_expression, expr, df)
    assert _verdict(tsd._validate_expr_ast, expr) == _verdict(
        jsd._validate_expr_ast, expr)
    assert (got[0] == "ok") == (expr in GOOD_EXPRS), got
    if expr in BAD_EXPRS:
        assert got[0] == "ValueError"


def test_structured_data_csv_flow_matches_jax(tmp_path):
    csv = tmp_path / "sales.csv"
    csv.write_text("region,revenue\nus,100\neu,50\napac,25\n")
    bad = tmp_path / "other.csv"
    bad.write_text("a,b\n1,2\n")
    script = [("data analyst", "```python\ndf['revenue'].sum()\n```")]
    retry = [("data analyst", "```python\ndf.to_csv('/tmp/x')\n```")]
    sides = []
    for res, get in zip(_pair(script), (jget, tget)):
        ex = get("structured_data")(res)
        empty = list(ex.rag_chain("total revenue?", []))
        ex.ingest_docs(str(csv), "sales.csv")
        out = list(ex.rag_chain("total revenue?", HISTORY))
        plain = list(ex.llm_chain("hi", HISTORY))
        res.llm.script = retry
        failed = list(ex.rag_chain("total revenue?", []))
        with pytest.raises(ValueError) as mismatch:
            ex.ingest_docs(str(bad), "other.csv")
        with pytest.raises(ValueError) as not_csv:
            ex.ingest_docs(str(tmp_path / "x.txt"), "x.txt")
        docs = ex.get_documents()
        deleted = (ex.delete_documents(["nope.csv"]),
                   ex.delete_documents(["sales.csv"]), ex.get_documents())
        sides.append((res, [empty, out, plain, failed, str(mismatch.value),
                            str(not_csv.value), docs, deleted]))
    (jres, jout), (tres, tout) = sides
    assert tout == jout and tres.llm.calls == jres.llm.calls
    assert "175" in "".join(tout[1])
    assert tout[3][0].startswith("Could not compute an answer")
    assert len(tres.llm.calls) == 2 + 1 + 3  # code+phrase, chat, retries
    assert tout[6] == ["sales.csv"] and tout[7] == (False, True, [])


def test_multimodal_tables_and_text_match_jax(tmp_path):
    doc = ("Quarterly results were strong.\n\n"
           "region   q1    q2\n"
           "us       100   120\n"
           "eu       50    60\n"
           "apac     25    30\n\n"
           "Revenue grew everywhere.\n")
    sides = []
    for res, get in zip(_pair(), (jget, tget)):
        ex = get("multimodal")(res)
        _ingest(ex, tmp_path, "report.txt", doc)
        out = list(ex.rag_chain("q2 revenue in eu?", []))
        sides.append((res, out, ex.document_search("eu revenue", 3,
                                                   content_type="table")))
    (jres, jout, jhits), (tres, tout, thits) = sides
    assert tout == jout and tres.llm.calls == jres.llm.calls
    assert thits == jhits and thits[0]["content_type"] == "table"
    assert_same_store(jres.store, tres.store)
    assert {d["metadata"]["content_type"]
            for d in tres.store.snapshot_docs()} == {"text", "table"}


# -- create_vector_store(ephemeral=...) -----------------------------------

KINDS = {"MemoryVectorStore": "MemoryVectorStore",
         "TPUVectorStore": "DeviceVectorStore",
         "MilvusVectorStore": "MilvusVectorStore",
         "PgVectorStore": "PgVectorStore"}


@pytest.mark.parametrize("ephemeral", [False, True])
@pytest.mark.parametrize("name", ["memory", "tpu", "native", "milvus",
                                  "pgvector"])
def test_create_vector_store_ephemeral_kinds_match_jax(
        tmp_path, monkeypatch, name, ephemeral):
    """An ephemeral store stays in-process (host memory under the
    external stores, the device store under tpu/native) and is never
    persisted; the external stores are stubbed here (no server)."""
    from generativeaiexamples_tpu.rag import (
        milvus_store as jm, pgvector_store as jp)
    from generativeaiexamples_tpu_torch.rag import (
        milvus_store as tm, pgvector_store as tp)

    for mod, cls in ((jm, "MilvusVectorStore"), (tm, "MilvusVectorStore"),
                     (jp, "PgVectorStore"), (tp, "PgVectorStore")):
        monkeypatch.setattr(mod, cls, type(cls, (), {
            "__init__": lambda self, url, dim: None}))
    env = {"APP_VECTORSTORE_NAME": name,
           "APP_VECTORSTORE_URL": "http://localhost:1"}
    persist = tmp_path / "persist"
    want = jvs.create_vector_store(jload(path="", env=env), dim=8,
                                   persist_dir=str(persist / "j"),
                                   ephemeral=ephemeral)
    got = tvs.create_vector_store(load_config(env=env), dim=8, device="cpu",
                                  persist_dir=str(persist / "t"),
                                  ephemeral=ephemeral)
    assert type(got).__name__ == KINDS[type(want).__name__]
    if ephemeral:
        assert isinstance(got, tvs.MemoryVectorStore)  # or its subclass
    if isinstance(got, tvs.MemoryVectorStore):
        got.add(["a"], np.ones((1, 8), np.float32), [{"filename": "f"}])
        assert (persist / "t").exists() == (not ephemeral)


# -- Resources, /metrics, config -------------------------------------------

def test_conv_store_injectable_ephemeral_and_never_microbatched(tmp_path):
    env = {"APP_SERVING_MICROBATCHENABLED": "true",
           "APP_VECTORSTORE_NAME": "tpu",
           "APP_VECTORSTORE_PERSISTDIR": str(tmp_path / "p")}
    cfg = load_config(env=env)
    hub = EngineHub(cfg, device="cpu")
    res = Resources(cfg, hub=hub, llm=EchoLLM(), embedder=HashEmbedder(64))
    assert type(res.conv_store).__name__ == "DeviceVectorStore"
    assert res.conv_store.device.type == "cpu"
    assert res.conv_store is not res.store
    stats = res.retriever.microbatch_stats()
    assert "search" in stats  # the document store coalesces ...
    from generativeaiexamples_tpu_torch.serving.batcher import (
        microbatch_stats_of)
    assert microbatch_stats_of(res.conv_store) is None  # ... memory never
    res.conv_store.add(["t"], np.ones((1, 64), np.float32))
    assert not (tmp_path / "p").exists()  # never persisted
    res.store.disable_microbatch()
    mine = tvs.MemoryVectorStore(64)
    other = Resources(cfg, hub=hub, llm=EchoLLM(), embedder=HashEmbedder(64),
                      conv_store=mine)
    assert other.conv_store is mine
    other.store.disable_microbatch()


def test_metrics_report_the_conversation_store_like_jax(tmp_path):
    from generativeaiexamples_tpu.api.server import ChainServer as JServer

    jres, tres = _pair()
    for res, get in zip((jres, tres), (jget, tget)):
        ex = get("multi_turn_rag")(res)
        _ingest(ex, tmp_path)
        list(ex.rag_chain("how much HBM", []))
    japp = JServer(jres.config, example=jget("multi_turn_rag")(jres),
                   upload_dir=str(tmp_path / "j"))
    resp = asyncio.run(japp.handle_metrics(None))
    want = json.loads(resp.body)
    tapp = ChainServer(tres.config, example=tget("multi_turn_rag")(tres),
                       upload_dir=str(tmp_path / "t"))
    try:
        status, got = tapp.metrics()
    finally:
        tapp.close()
    assert status == 200
    assert got == want
    assert got["conv_store"]["ntotal"] == 1
    assert got["conv_store"]["backend"] == "MemoryVectorStore"


def test_multi_turn_template_and_vlm_config_match_jax(tmp_path, caplog):
    from generativeaiexamples_tpu.config.schema import AppConfig as JApp

    port, jcfg = load_config(env={}), JApp()
    assert port.prompts.multi_turn_rag_template == \
        jcfg.prompts.multi_turn_rag_template
    ported = {f.name for f in dataclasses.fields(port.vlm)}
    # deplot_model_name is read by no code in either package; the port
    # leaves it out, and a file that sets it gets the "no counterpart" log.
    assert ported == {f.name for f in dataclasses.fields(jcfg.vlm)} - \
        {"deplot_model_name"}

    def same(cfg):
        return {k: v for k, v in dataclasses.asdict(cfg).items()
                if k in ported}

    assert dataclasses.asdict(port.vlm) == same(jcfg.vlm)
    env = {"APP_PROMPTS_MULTITURNRAGTEMPLATE": "H {history} C {context} "
                                               "I {input}",
           "APP_VLM_SERVERURL": "http://127.0.0.1:9/v1",
           "APP_VLM_MODELNAME": "my-vlm"}
    path = tmp_path / "app.yaml"
    path.write_text("vlm:\n  deplot_model_name: my-deplot\n"
                    "  model_name: file-vlm\n"
                    "prompts:\n  multi_turn_rag_template: 'F {history}'\n"
                    "voice:\n  asr_server_url: http://x\n")
    for file_ in ("", str(path)):
        for e in ({}, env):
            ours = load_config(path=file_, env=e)
            theirs = jload(path=file_, env=e)
            assert dataclasses.asdict(ours.vlm) == same(theirs.vlm), \
                (file_, e)
            assert dataclasses.asdict(ours.prompts) == \
                dataclasses.asdict(theirs.prompts), (file_, e)
    assert theirs.vlm.deplot_model_name == "my-deplot"
    assert "[vlm] deplot_model_name has no counterpart" in caplog.text
    # voice is the port's too (the playground's voice path): read, not
    # logged and ignored.
    assert "section [voice]" not in caplog.text
    assert dataclasses.asdict(ours.voice) == dataclasses.asdict(theirs.voice)
    assert ours.voice.asr_server_url == "http://x"
