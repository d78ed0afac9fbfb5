"""BPE text tokenizer (contract: ttts/gpt/voice_tokenizer.py), the port's own
copy of ttts_tpu/text/tokenizer.py.

Tokenization is host-side I/O, so we keep the battle-tested Rust BPE from HF
``tokenizers`` and preserve the trained vocabulary artifact byte-for-byte
(ttts_tpu_torch/assets/gpt_tts_tokenizer.json, a byte copy of the JAX
package's; 255-vocab BPE with [STOP]/[UNK]/[SPACE] specials). Encoding
semantics match VoiceBpeTokenizer.encode
(voice_tokenizer.py:41-45): punctuation normalization, then spaces →
[SPACE], then BPE.
"""

from __future__ import annotations

import pathlib
import re
from typing import Iterable, Sequence

import numpy as np

_ASSET = pathlib.Path(__file__).resolve().parent.parent / "assets" / "gpt_tts_tokenizer.json"

_REPLACEMENTS = {
    "{": "(",
    "}": ")",
    "[": "(",
    "]": ")",
    "`": "'",
    "—": "-",
    "ʼ": "'",
}
_REPLACE_RE = re.compile(
    "|".join(re.escape(k) for k in sorted(_REPLACEMENTS, key=len, reverse=True)), flags=re.DOTALL
)
_EXTRANEOUS_RE = re.compile(r"^[@#%_=\$\^&\*\+\\]$")


def clean_text(text: str) -> str:
    """Punctuation normalization (voice_tokenizer.py:14-29)."""
    text = _REPLACE_RE.sub(lambda m: _REPLACEMENTS[m.group(0)], text)
    return _EXTRANEOUS_RE.sub("", text)


class VoiceBpeTokenizer:
    """Host-side BPE wrapper with the reference's encode/decode semantics."""

    def __init__(self, vocab_file: str | pathlib.Path | None = None):
        from tokenizers import Tokenizer  # Rust BPE, host-side only

        self.tokenizer = Tokenizer.from_file(str(vocab_file or _ASSET))

    def encode(self, text: str) -> list[int]:
        text = clean_text(text)
        text = text.replace(" ", "[SPACE]")
        return self.tokenizer.encode(text).ids

    def decode(self, ids: Sequence[int] | np.ndarray) -> str:
        if isinstance(ids, np.ndarray):
            ids = ids.tolist()
        txt = self.tokenizer.decode(list(ids), skip_special_tokens=False).replace(" ", "")
        return txt.replace("[SPACE]", " ").replace("[STOP]", "").replace("[UNK]", "")

    @property
    def vocab_size(self) -> int:
        return self.tokenizer.get_vocab_size()

    @staticmethod
    def train(corpus: Iterable[str], out_path: str, vocab_size: int = 255) -> "VoiceBpeTokenizer":
        """Train a fresh 255-vocab BPE (voice_tokenizer.py:57-90)."""
        from tokenizers import Tokenizer
        from tokenizers.models import BPE
        from tokenizers.pre_tokenizers import Whitespace
        from tokenizers.trainers import BpeTrainer

        allowed = re.compile(r"^[0-9a-z!:;\"/, \-\(\)\.\'\?ʼ，。？：；’‘”“、！…（）]+$")

        def preprocess(line: str) -> str:
            line = clean_text(line)
            return line if allowed.match(line) else ""

        trainer = BpeTrainer(special_tokens=["[STOP]", "[UNK]", "[SPACE]"], vocab_size=vocab_size)
        tok = Tokenizer(BPE(unk_token="[UNK]"))
        tok.pre_tokenizer = Whitespace()
        lines = [preprocess(l) for l in corpus]
        tok.train_from_iterator(
            (lines[i : i + 1000] for i in range(0, len(lines), 1000)), trainer, length=len(lines)
        )
        tok.save(out_path)
        return VoiceBpeTokenizer(out_path)


def default_tokenizer() -> VoiceBpeTokenizer:
    return VoiceBpeTokenizer(_ASSET)
