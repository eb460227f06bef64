"""The port's unigram trainer (lip2speech_tpu_torch/data/spm_train.py) and
its CLI (cli/gen_subword.py) against the JAX package's: pure Python, so the
pieces and scores are equal, and the .vocab files equal byte for byte, for
a .txt corpus and a .csv with a Phrase column; the port's tokenizer reads
the file back."""

import csv
import sys

import pytest

from lip2speech_tpu.cli import gen_subword as jgen
from lip2speech_tpu.data import spm_train as jspm
from lip2speech_tpu_torch.cli import gen_subword as tgen
from lip2speech_tpu_torch.data import spm_train as tspm
from lip2speech_tpu_torch.data.text import UnigramTokenizer

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "the lazy dog sleeps all day",
    "quick thinking saves the day",
    "a fox and a dog walk over the hill",
    "over the hill the quick fox runs",
    "Dogs and foxes are QUICK animals!",
] * 3 + ["", "   "]


@pytest.mark.parametrize("vocab_size,max_piece_len", [(60, 6), (200, 8)])
def test_train_unigram_matches_jax(vocab_size, max_piece_len):
    got = tspm.train_unigram(CORPUS, vocab_size=vocab_size, max_piece_len=max_piece_len)
    ref = jspm.train_unigram(CORPUS, vocab_size=vocab_size, max_piece_len=max_piece_len)
    assert got == ref and 0 < len(got) <= vocab_size - 4
    assert tspm.train_unigram([]) == jspm.train_unigram([]) == []


@pytest.mark.parametrize("kind", ["txt", "csv"])
def test_gen_subword_vocab_bytes_match_jax(kind, tmp_path, monkeypatch, capsys):
    src = tmp_path / f"corpus.{kind}"
    if kind == "txt":
        src.write_text("\n".join(CORPUS), encoding="utf-8")
    else:
        with open(src, "w", newline="", encoding="utf-8") as f:
            writer = csv.DictWriter(f, fieldnames=["ID", "Phrase"])
            writer.writeheader()
            writer.writerows({"ID": i, "Phrase": line} for i, line in enumerate(CORPUS))
    argv = ["--input", str(src), "--vocab-size", "70", "--max-piece-len", "5"]
    monkeypatch.setattr(sys, "argv", ["gen_subword", *argv, "--out", str(tmp_path / "jax.vocab")])
    jgen.main()
    pieces = tgen.main([*argv, "--out", str(tmp_path / "port.vocab")])
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace("jax.vocab", "X") == out[1].replace("port.vocab", "X")
    assert (tmp_path / "port.vocab").read_bytes() == (tmp_path / "jax.vocab").read_bytes()
    tok = UnigramTokenizer(tmp_path / "port.vocab")
    assert tok.pieces[:4] == ["<pad>", "<sos>", "<eos>", "<unk>"]
    assert len(tok.pieces) == len(pieces) + 4
    assert tok.decode(tok.encode("the quick fox")) == "the quick fox"
