"""Bracket redactions, port of ttts_tpu/text/alignment.py:20-25
(`parse_redactions`): in Tortoise's `[bracket]` redaction, bracketed text is
spoken and then cut from the output audio by a CTC forced alignment.

`Wav2VecAlignment`, the aligner that cuts the spans, needs a local wav2vec2
checkpoint (HuggingFace transformers) and is not ported yet (ROADMAP.md
queue 1).
"""

from __future__ import annotations

import re
from typing import List, Tuple


def parse_redactions(text: str) -> Tuple[str, List[str]]:
    """'hello [world] x' → ('hello world x', ['world'])."""
    return re.sub(r"\[(.*?)\]", r"\1", text), re.findall(r"\[(.*?)\]", text)
