"""The 5-minute RAG example: the hello world of the PyTorch port.

The port's copy of examples/5_mins_rag.py, with the same moving parts
as the reference's examples/5_mins_rag_no_gpu/main.py (Streamlit +
FAISS + API-catalog endpoints, :40-140): ingest a few files, ask
questions, stream answers. Streamlit is not in the image, so this is a
terminal REPL; splitter, vector store, embedder and streaming LLM are
the same.

Zero-config demo (fake echo LLM + hash embedder, no weights, no
network). The vector store lives on the card unless `--device cpu`:

    python generativeaiexamples_tpu_torch/examples/5_mins_rag.py README.md
    python generativeaiexamples_tpu_torch/examples/5_mins_rag.py \\
        --device cpu README.md

Against a real endpoint (the port's engine server,
`python -m generativeaiexamples_tpu_torch.serving`, or any
OpenAI-compatible /v1):

    APP_LLM_MODELENGINE=openai APP_LLM_SERVERURL=http://localhost:8000/v1 \\
    APP_EMBEDDINGS_MODELENGINE=openai \\
    APP_EMBEDDINGS_SERVERURL=http://localhost:8000/v1 \\
    python generativeaiexamples_tpu_torch/examples/5_mins_rag.py docs/*.md
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from generativeaiexamples_tpu_torch.config.wizard import load_config  # noqa: E402
from generativeaiexamples_tpu_torch.connectors.factory import EngineHub  # noqa: E402
from generativeaiexamples_tpu_torch.pipelines.base import get_example_class  # noqa: E402
from generativeaiexamples_tpu_torch.pipelines.resources import Resources  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("files", nargs="*", help="documents to ingest")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    if not args.files:
        print(__doc__)
        raise SystemExit("usage: python generativeaiexamples_tpu_torch/"
                         "examples/5_mins_rag.py [--device cpu] <files...>")

    # Default to the hermetic fakes unless the env selects an engine
    # (the reference defaults to API-catalog endpoints, main.py:40-43).
    os.environ.setdefault("APP_LLM_MODELENGINE", "echo")
    os.environ.setdefault("APP_EMBEDDINGS_MODELENGINE", "hash")
    cfg = load_config(None)
    res = Resources(cfg, hub=EngineHub(cfg, device=args.device))
    rag = get_example_class("developer_rag")(res)

    for path in args.files:
        rag.ingest_docs(path, os.path.basename(path))
        print(f"ingested {path}")

    print("\nAsk about your documents (empty line to quit).")
    while True:
        try:
            q = input("\n> ").strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not q:
            break
        for chunk in rag.rag_chain(q, [], max_tokens=512):
            print(chunk, end="", flush=True)
        print()


if __name__ == "__main__":
    main()
