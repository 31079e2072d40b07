"""The port's hello world and tutorials (generativeaiexamples_tpu_torch/
examples/) run top to bottom on the CPU with `--device cpu`.

Each runs in its own subprocess, as tests/test_tutorials.py runs JAX's;
all of them (and the JAX tutorials held against) start together from one
module fixture, three at a time.

- 01, 04, 05, 06 and 07 use the hermetic fakes, as JAX's do: every line
  they print must equal the line JAX's tutorial prints, except
  * 01's "top hit:" and "answer:" lines, which quote the sample
    document and question: the port's copy states the card's memory
    where JAX's states the TPU's;
  * 04's "ingest stats:" line, whose `elapsed_s` and `embeddings_per_s`
    are wall-clock readings (the other keys must be equal);
  * 07's "wrote <path>" line, which names a fresh temporary directory
    (the rest of the line must be equal).
  None of these builds a JAX `LLMEngine`.
- 02 and 03 run random weights (no value parity across frameworks):
  02 holds its own invariants (six streamed tokens, four tokens from the
  chunked prompt, speculative == greedy), 03 finite losses.
- Without `--device cpu` (and with no CUDA) every one exits non-zero
  with the device error: nothing falls back to the CPU.
"""

import ast
import glob
import math
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(ROOT, "generativeaiexamples_tpu_torch", "examples")
JAX_DIR = os.path.join(ROOT, "examples", "tutorials")
HELLO = os.path.join(PORT_DIR, "5_mins_rag.py")
TUTORIALS = sorted(os.path.basename(p) for p in glob.glob(
    os.path.join(PORT_DIR, "tutorials", "*.py")))
HERMETIC = [t for t in TUTORIALS if t[:2] in ("01", "04", "05", "06", "07")]
QUESTION = "what does the port serve?"
NO_CUDA = {"CUDA_VISIBLE_DEVICES": ""}


def _run(argv, stdin=None, env=None):
    proc = subprocess.run(
        [sys.executable] + argv, input=stdin, capture_output=True,
        text=True, cwd=ROOT, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu", **(env or {})})
    return proc.returncode, proc.stdout, proc.stderr


@pytest.fixture(scope="module")
def runs():
    jobs = {("hello", "cpu"): ([HELLO, "--device", "cpu", "README.md"],
                               QUESTION + "\n", None),
            ("hello", "default"): ([HELLO, "README.md"], "", NO_CUDA)}
    for t in TUTORIALS:
        path = os.path.join(PORT_DIR, "tutorials", t)
        jobs[(t, "cpu")] = ([path, "--device", "cpu"], None, None)
        jobs[(t, "default")] = ([path], None, NO_CUDA)
    for t in HERMETIC:
        jobs[(t, "jax")] = ([os.path.join(JAX_DIR, t)], None, None)
    with ThreadPoolExecutor(3) as pool:
        futs = {k: pool.submit(_run, *v) for k, v in jobs.items()}
        return {k: f.result() for k, f in futs.items()}


def test_port_has_every_tutorial():
    assert TUTORIALS == sorted(os.listdir(JAX_DIR))
    assert len(TUTORIALS) == 7


@pytest.mark.parametrize("name", TUTORIALS + ["hello"])
def test_runs_on_the_cpu(runs, name):
    rc, out, err = runs[(name, "cpu")]
    assert rc == 0, err[-3000:]
    assert out.strip()


@pytest.mark.parametrize("name", TUTORIALS + ["hello"])
def test_raises_without_cuda(runs, name):
    rc, _, err = runs[(name, "default")]
    assert rc != 0
    assert "CUDA is not available" in err, err[-2000:]


def test_hello_world_answers_from_stdin(runs):
    _, out, _ = runs[("hello", "cpu")]
    assert "ingested README.md" in out
    assert f"ECHO: {QUESTION}" in out


def _normalise(name, line):
    """The line as compared, or None for a line left out (the module
    docstring says which, and why)."""
    if name.startswith("01") and line.startswith(("top hit:", "answer:")):
        return None
    if name.startswith("04") and line.startswith("ingest stats: "):
        stats = ast.literal_eval(line[len("ingest stats: "):])
        for key in ("elapsed_s", "embeddings_per_s"):
            stats.pop(key)
        return f"ingest stats: {stats}"
    if name.startswith("07"):
        return re.sub(r"^wrote \S+/report\.pdf", "wrote <tmp>/report.pdf",
                      line)
    return line


@pytest.mark.parametrize("name", HERMETIC)
def test_prints_equal_jax(runs, name):
    rc, want, err = runs[(name, "jax")]
    assert rc == 0, err[-3000:]
    got = runs[(name, "cpu")][1].splitlines()
    want = want.splitlines()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _normalise(name, g) == _normalise(name, w)
    if name.startswith("01"):
        top = next(ln for ln in got if ln.startswith("top hit:"))
        assert "H100" in top
        assert any(ln.startswith("answer: ECHO: how much memory")
                   for ln in got)


def _ints(line):
    return [int(t) for t in re.findall(r"-?\d+", line)]


def test_serving_engine_invariants(runs):
    rc, out, err = runs[("02_serving_engine.py", "cpu")]
    assert rc == 0, err[-3000:]
    lines = out.splitlines()
    assert len(_ints(lines[0])) == 6
    chunked = next(ln for ln in lines
                   if ln.startswith("long-prompt continuation:"))
    assert len(ast.literal_eval(chunked.split(":", 1)[1].strip())) == 4
    spec = next(ln for ln in lines if ln.startswith("speculative tokens:"))
    greedy = next(ln for ln in lines if ln.startswith("greedy tokens:"))
    assert _ints(spec) == _ints(greedy) and len(_ints(spec)) == 12
    assert "speculative == greedy ✓" in lines
    metrics = next(ln for ln in lines if ln.startswith("metrics:"))
    # The CPU run takes the kernels' plain versions: no launch counted.
    assert "'kernel_launches_flash_attention': 0" in metrics
    assert "'kernel_launches_paged_attention': 0" in metrics


def test_finetuning_losses_finite(runs):
    rc, out, err = runs[("03_finetuning.py", "cpu")]
    assert rc == 0, err[-3000:]
    losses = [float(ln.split(":", 1)[1]) for ln in out.splitlines()
              if ln.startswith(("sft loss:", "lora loss:"))]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert "retriever fine-tune done" in out
