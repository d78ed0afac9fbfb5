"""The port's own copies of the JAX package's config and text frontend: the
configuration dataclasses equal ttts_tpu.config's field by field, and the
BPE ids and pinyin equal ttts_tpu.text's.

Exports TINY, tests/test_api.py's TINY as the port's config classes, and
`to_port`, which the other port tests use to build port modules."""

import dataclasses

import numpy as np
import pytest

import ttts_tpu.config as jconfig
import ttts_tpu_torch.config as pconfig
from test_api import TINY as JAX_TINY
from ttts_tpu.text import default_tokenizer as jax_tokenizer
from ttts_tpu.text import text_to_pinyin as jax_pinyin
from ttts_tpu_torch.text import default_tokenizer, text_to_pinyin


def to_port(cfg):
    """A ttts_tpu.config dataclass → the port's dataclass of the same name,
    field for field (nested configs included)."""
    cls = getattr(pconfig, type(cfg).__name__)
    return cls(**{f.name: (to_port(v) if dataclasses.is_dataclass(v := getattr(cfg, f.name))
                           else v)
                  for f in dataclasses.fields(cfg)})


TINY = to_port(JAX_TINY)

NAMES = [c.__name__ for c in vars(jconfig).values()
         if isinstance(c, type) and dataclasses.is_dataclass(c)]


@pytest.mark.parametrize("name", NAMES)
def test_config_defaults_equal(name):
    jcls, pcls = getattr(jconfig, name), getattr(pconfig, name)
    assert [f.name for f in dataclasses.fields(pcls)] == [f.name for f in dataclasses.fields(jcls)]
    assert dataclasses.asdict(pcls()) == dataclasses.asdict(jcls())


@pytest.mark.parametrize("name", NAMES)
def test_to_dict_equal(name):
    """The port's to_dict gives JAX's dict for each config class, at its
    defaults and at TINY's value where TINY has one."""
    jcls, pcls = getattr(jconfig, name), getattr(pconfig, name)
    assert pconfig.to_dict(pcls()) == jconfig.to_dict(jcls())
    tiny = [getattr(JAX_TINY, f.name) for f in dataclasses.fields(JAX_TINY)
            if type(getattr(JAX_TINY, f.name)).__name__ == name]
    for cfg in tiny + ([JAX_TINY] if name == "TTTSConfig" else []):
        assert pconfig.to_dict(to_port(cfg)) == jconfig.to_dict(cfg)


def test_default_config_and_tiny():
    assert dataclasses.asdict(pconfig.default_config()) == dataclasses.asdict(
        jconfig.default_config())
    assert isinstance(TINY, pconfig.TTTSConfig) and isinstance(TINY.gpt, pconfig.GPTConfig)
    assert dataclasses.asdict(TINY) == dataclasses.asdict(JAX_TINY)


TEXTS = ["ni3 hao3 shi4 jie4", "Hello, world! [test] {x} — ok?", "jin1 tian1 tian1 qi4 hen3 hao3.",
         "a  b\tc 123 ʼquoteʼ `tick`", "", "你好，世界 ni3 hao3"]


def _pinyin_or_error(fn, text):
    """Romanised text, or the error raised (CJK text without pypinyin)."""
    try:
        return fn(text)
    except RuntimeError as e:
        return type(e)


@pytest.mark.parametrize("text", TEXTS)
def test_tokenizer_and_pinyin_equal(text):
    pinyin = _pinyin_or_error(text_to_pinyin, text)
    assert pinyin == _pinyin_or_error(jax_pinyin, text)
    if not isinstance(pinyin, str):
        return
    ids = default_tokenizer().encode(pinyin)
    assert ids == jax_tokenizer().encode(jax_pinyin(text))
    assert default_tokenizer().decode(np.asarray(ids)) == jax_tokenizer().decode(np.asarray(ids))
