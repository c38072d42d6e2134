"""The port's copy of the sentence segmenter against the JAX package's:
the inputs of tests/test_segmenter.py (and the repository's sentences)
split the same way, exactly."""
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CASES = [
    ('Hello there. How are you? Fine! Good.', 0),
    ('Dr. Smith lives on St. Mark Ave. in town. He is fine.', 0),
    ('George W. Bush met J. Smith. They talked.', 0),
    ('Use fruit, e.g. apples. Stores open at 9 a.m. Every day.', 0),
    ('Pi is 3.14 roughly. the rest follows. Done.', 0),
    ('He said "Stop!" Then he left. (Really.) Yes.', 0),
    ('', 0),
    ('   ', 0),
    ('No terminal punctuation', 0),
    ('This clause goes on, and this one follows, and a third one closes '
     'the sentence.', 45),
    (' '.join(['a' * 30] * 3), 35),
    (' '.join((ROOT / 'sentences.txt').read_text(encoding='utf-8')
              .splitlines()), 0),
    (' '.join((ROOT / 'sentences.txt').read_text(encoding='utf-8')
              .splitlines()), 80),
]


@pytest.mark.parametrize('text,max_len', CASES)
def test_split_sentences_equals_jax(text, max_len):
    from forwardtacotron_tpu.text.segmenter import split_sentences as ref
    from forwardtacotron_tpu_torch.text.segmenter import split_sentences
    assert split_sentences(text, max_len) == ref(text, max_len)
