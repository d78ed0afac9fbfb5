"""Host-side text frontend: pinyin conversion and BPE tokenization (the
port's own copy of ttts_tpu/text, with its own vocabulary asset)."""

from ttts_tpu_torch.text.tokenizer import VoiceBpeTokenizer, default_tokenizer  # noqa: F401
from ttts_tpu_torch.text.pinyin import text_to_pinyin, HAVE_PYPINYIN  # noqa: F401
