"""Forced alignment and redaction, port of ttts_tpu/text/alignment.py
(reference ttts/utils/wav2vec_alignment.py). In Tortoise's `[bracket]`
redaction, bracketed text is spoken and then cut from the output audio:
`parse_redactions` takes the brackets out of the text, and
`Wav2VecAlignment.redact` CTC-aligns the generated audio against the text
and cuts the bracketed spans.

The aligner is a third-party model: a local wav2vec2 CTC checkpoint loaded
through HuggingFace `transformers`, imported on first use (an ImportError
that names it where it is missing). It runs on the card unless
device="cpu" is given.
"""

from __future__ import annotations

import re
from typing import List, Tuple

import numpy as np
import torch


def parse_redactions(text: str) -> Tuple[str, List[str]]:
    """'hello [world] x' → ('hello world x', ['world'])."""
    return re.sub(r"\[(.*?)\]", r"\1", text), re.findall(r"\[(.*?)\]", text)


class Wav2VecAlignment:
    """Greedy CTC character aligner over a local wav2vec2 checkpoint."""

    def __init__(self, model_dir: str, device="cuda"):
        from ttts_tpu_torch.data.prepare.hubert import transformers_module
        from ttts_tpu_torch.infer_utils import prepare_device

        tf = transformers_module()
        self.device = prepare_device(device)
        self.processor = tf.Wav2Vec2Processor.from_pretrained(model_dir)
        self.model = tf.Wav2Vec2ForCTC.from_pretrained(model_dir).to(self.device).eval()

    def align(self, audio16k: np.ndarray, text: str) -> List[Tuple[int, int, str]]:
        """Each CTC frame's argmax character, blanks and word separators
        dropped → [(start_sample, end_sample, char)]."""
        inputs = self.processor(audio16k, sampling_rate=16000, return_tensors="pt")
        with torch.no_grad():
            logits = self.model(inputs.input_values.to(self.device)).logits[0]
        ids = logits.argmax(-1).cpu().numpy()
        per_frame = len(audio16k) / len(ids)
        chars = self.processor.tokenizer.convert_ids_to_tokens(list(ids))
        return [(int(i * per_frame), int((i + 1) * per_frame), ch.lower())
                for i, ch in enumerate(chars) if ch not in ("<pad>", "|")]

    def redact(self, audio16k: np.ndarray, text: str) -> np.ndarray:
        """The audio without the bracketed spans' aligned samples."""
        clean, redactions = parse_redactions(text)
        if not redactions:
            return audio16k
        spans = self.align(audio16k, clean)
        aligned = "".join(ch for _, _, ch in spans)
        keep = np.ones(len(audio16k), bool)
        for red in redactions:
            target = re.sub(r"[^a-z0-9]", "", red.lower())
            pos = aligned.find(target)
            if pos < 0 or not target:
                continue
            keep[spans[pos][0]:spans[min(pos + len(target) - 1, len(spans) - 1)][1]] = False
        return audio16k[keep]
