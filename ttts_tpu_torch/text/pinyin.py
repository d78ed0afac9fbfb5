"""Chinese → tone3 pinyin frontend (the port's own copy of ttts_tpu/text/pinyin.py).

The reference converts all Chinese text to tone3 pinyin before BPE using
``lazy_pinyin(text, style=Style.TONE3, neutral_tone_with_five=True)`` — the
identical snippet appears in ttts/gpt/dataset.py:41, ttts/vqvae/dataset.py:58,
ttts/diffusion/dataset.py:41, ttts/api_zh.py:38 and
ttts/prepare/bpe_all_text_to_one_file.py:12.

pypinyin is an optional host dependency. When present we call it with the
exact reference arguments; otherwise non-CJK text passes through unchanged and
CJK input raises, so the contract is never silently violated.
"""

from __future__ import annotations

import re

try:  # optional dependency (not baked into every image)
    from pypinyin import Style, lazy_pinyin  # type: ignore

    HAVE_PYPINYIN = True
except ImportError:  # pragma: no cover
    HAVE_PYPINYIN = False

_CJK_RE = re.compile(r"[㐀-䶿一-鿿豈-﫿]")


def contains_cjk(text: str) -> bool:
    return bool(_CJK_RE.search(text))


def text_to_pinyin(text: str) -> str:
    """tone3 pinyin with neutral tone as '5', joined by spaces."""
    if HAVE_PYPINYIN:
        return " ".join(lazy_pinyin(text, style=Style.TONE3, neutral_tone_with_five=True))
    if contains_cjk(text):
        raise RuntimeError(
            "pypinyin is required to romanize Chinese text but is not installed; "
            "pip install pypinyin on the data-prep host."
        )
    return text
