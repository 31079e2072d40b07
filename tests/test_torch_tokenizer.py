"""Port parity: utils/tokenizer.py against the JAX package's.

Two tokenizer.json files are trained here with `tokenizers` on a few KB
of the repository's README (nothing is downloaded): a byte-level BPE
with the Llama-3 specials and a WordPiece with the BERT ones. The port's
`HFTokenizer` must give the JAX one's ids, text, specials, chat template
and streamed text; `load_tokenizer` must keep the JAX gate for
weights-only snapshots (tests/test_checkpoint_e2e.py).
"""

import json
import os
from pathlib import Path

import pytest

from generativeaiexamples_tpu.utils import tokenizer as jt
from generativeaiexamples_tpu_torch.utils import tokenizer as tt

ROOT = Path(__file__).resolve().parent.parent
LLAMA3_SPECIALS = ["<|begin_of_text|>", "<|end_of_text|>",
                   "<|start_header_id|>", "<|end_header_id|>", "<|eot_id|>",
                   "<|finetune_right_pad_id|>"]
BERT_SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
TEXTS = ["Hello world", "", "  spaces  and\ttabs\n", "naïve café — déjà vu",
         "emoji 🚀 and 中文", "The prefill scheduler batches admissions.",
         "<|eot_id|> is a special token"]
MESSAGES = [{"role": "system", "content": "Be brief."},
            {"role": "user", "content": "What is a page table?"}]


def _corpus():
    return (ROOT / "README.md").read_text()[:6000].splitlines()


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    from tokenizers import Tokenizer, decoders, models, normalizers
    from tokenizers import pre_tokenizers, trainers

    root = tmp_path_factory.mktemp("tok")
    bpe = Tokenizer(models.BPE())
    bpe.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    bpe.decoder = decoders.ByteLevel()
    bpe.train_from_iterator(_corpus(), trainers.BpeTrainer(
        vocab_size=600, special_tokens=LLAMA3_SPECIALS,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    wp = Tokenizer(models.WordPiece(unk_token="[UNK]"))
    wp.normalizer = normalizers.BertNormalizer(lowercase=True)
    wp.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    wp.decoder = decoders.WordPiece()
    wp.train_from_iterator(_corpus(), trainers.WordPieceTrainer(
        vocab_size=400, special_tokens=BERT_SPECIALS))
    out = {}
    for name, tk in (("bpe", bpe), ("wordpiece", wp)):
        d = root / name
        d.mkdir()
        tk.save(str(d / "tokenizer.json"))
        out[name] = str(d)
    return out


@pytest.mark.parametrize("kind", ["bpe", "wordpiece"])
def test_hf_tokenizer_matches_jax(snapshots, kind):
    path = snapshots[kind]
    port, theirs = tt.load_tokenizer(path), jt.load_tokenizer(path)
    assert isinstance(port, tt.HFTokenizer)
    for attr in ("vocab_size", "bos_id", "eos_id", "eos_ids", "pad_id",
                 "cls_id", "sep_id"):
        assert getattr(port, attr) == getattr(theirs, attr), attr
    if kind == "bpe":
        assert port.bos_id == port.tk.token_to_id("<|begin_of_text|>")
        assert port.eos_ids == {port.tk.token_to_id("<|eot_id|>"),
                                port.tk.token_to_id("<|end_of_text|>")}
        assert port.cls_id is None
    else:
        assert (port.cls_id, port.sep_id) == (2, 3)
    for text in TEXTS:
        for add_bos in (False, True):
            ids = port.encode(text, add_bos=add_bos)
            assert ids == theirs.encode(text, add_bos=add_bos)
        assert port.decode(ids) == theirs.decode(ids)
    # A tokenizer.json file names the same tokenizer as its directory.
    assert tt.load_tokenizer(os.path.join(path, "tokenizer.json")).encode(
        TEXTS[3]) == port.encode(TEXTS[3])
    for gen in (False, True):
        assert port.apply_chat_template(MESSAGES, gen) == \
            theirs.apply_chat_template(MESSAGES, gen)


@pytest.mark.parametrize("kind", ["bpe", "wordpiece"])
def test_stream_detokenizer_matches_jax(snapshots, kind):
    """Token by token, including multi-byte characters split across
    tokens and a run past the detokenizer's window."""
    port, theirs = (tt.load_tokenizer(snapshots[kind]),
                    jt.load_tokenizer(snapshots[kind]))
    text = " ".join(TEXTS) * 3
    ids = port.encode(text)
    a, b = tt.StreamDetokenizer(port), jt.StreamDetokenizer(theirs)
    got = [a.push(i) for i in ids]
    assert got == [b.push(i) for i in ids]
    assert len(ids) > tt.StreamDetokenizer.WINDOW
    if kind == "bpe":  # byte-level: the text, specials skipped
        assert "".join(got) == text.replace("<|eot_id|>", "")


def _weights_only(path, vocab):
    path.mkdir()
    (path / "model.safetensors").write_bytes(b"\0" * 8)
    (path / "config.json").write_text(json.dumps({"vocab_size": vocab}))
    return str(path)


def test_byte_fallback_gated_on_vocab_size(tmp_path, monkeypatch):
    """A weights-only snapshot falls back to the byte tokenizer only for a
    byte-sized vocabulary or with GAIE_BYTE_TOKENIZER_FALLBACK=1, as in
    the JAX package."""
    monkeypatch.delenv("GAIE_BYTE_TOKENIZER_FALLBACK", raising=False)
    small = _weights_only(tmp_path / "small", 259)
    big = _weights_only(tmp_path / "big", 128256)
    for mod in (tt, jt):
        assert isinstance(mod.load_tokenizer(small), mod.ByteTokenizer)
        with pytest.raises(FileNotFoundError, match="byte-compatible"):
            mod.load_tokenizer(big)
        with pytest.raises(FileNotFoundError, match="no model weights"):
            mod.load_tokenizer(str(tmp_path / "missing"))
        assert isinstance(mod.load_tokenizer("byte"), mod.ByteTokenizer)
    monkeypatch.setenv("GAIE_BYTE_TOKENIZER_FALLBACK", "1")
    for mod in (tt, jt):
        assert isinstance(mod.load_tokenizer(big), mod.ByteTokenizer)
