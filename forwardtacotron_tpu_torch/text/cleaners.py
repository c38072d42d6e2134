"""Text cleaning + phonemization front-end.

Parity surface: utils/text/cleaners.py in the reference (Cleaner,
english_cleaners, no_cleaners, to_phonemes). Differences forced by the
TPU image (no unidecode / phonemizer / espeak python packages):

- transliteration uses a stdlib NFKD fold instead of `unidecode`,
- phonemization shells out to an `espeak-ng`/`espeak` binary when one is
  installed (same backend the reference's `phonemizer` package drives,
  same option surface: strip stress, preserve punctuation), and falls
  back to a built-in rule-based English G2P otherwise so the pipeline is
  fully self-contained.
"""
from __future__ import annotations

import re
import shutil
import subprocess
import unicodedata
from typing import Any, Dict

from forwardtacotron_tpu_torch.text.numbers import normalize_numbers
from forwardtacotron_tpu_torch.text.symbols import phonemes_set

_whitespace_re = re.compile(r'\s+')

_abbreviations = [(re.compile(r'\b%s\.' % x[0], re.IGNORECASE), x[1]) for x in [
    ('mrs', 'misess'),
    ('mr', 'mister'),
    ('dr', 'doctor'),
    ('st', 'saint'),
    ('co', 'company'),
    ('jr', 'junior'),
    ('maj', 'major'),
    ('gen', 'general'),
    ('drs', 'doctors'),
    ('rev', 'reverend'),
    ('lt', 'lieutenant'),
    ('hon', 'honorable'),
    ('sgt', 'sergeant'),
    ('capt', 'captain'),
    ('esq', 'esquire'),
    ('ltd', 'limited'),
    ('col', 'colonel'),
    ('ft', 'fort'),
]]

_PUNCTUATION_MARKS = ';:,.!?¡¿—…"«»“”()'


def transliterate(text: str) -> str:
    """Best-effort latin fold of unicode text (replacement for unidecode)."""
    decomposed = unicodedata.normalize('NFKD', text)
    out = []
    for ch in decomposed:
        if ord(ch) < 128:
            out.append(ch)
        elif unicodedata.combining(ch):
            continue
        else:
            repl = _EXTRA_TRANSLIT.get(ch)
            if repl is not None:
                out.append(repl)
    return ''.join(out)


_EXTRA_TRANSLIT = {
    'æ': 'ae', 'Æ': 'AE', 'œ': 'oe', 'Œ': 'OE', 'ß': 'ss',
    'ø': 'o', 'Ø': 'O', 'đ': 'd', 'Đ': 'D', 'þ': 'th', 'Þ': 'Th',
    'ð': 'd', 'Ð': 'D', 'ł': 'l', 'Ł': 'L', '—': '-', '–': '-',
    '‘': "'", '’': "'", '“': '"', '”': '"', '…': '...',
}


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _abbreviations:
        text = re.sub(regex, replacement, text)
    return text


def collapse_whitespace(text: str) -> str:
    return re.sub(_whitespace_re, ' ', text)


def no_cleaners(text: str) -> str:
    return text


def english_cleaners(text: str) -> str:
    text = transliterate(text)
    text = normalize_numbers(text)
    text = expand_abbreviations(text)
    return text


def english_cleaners_extended(text: str) -> str:
    """english_cleaners + clock times, percent, negative numbers
    (numbers.extended_normalize). Opt-in via
    `cleaner_name: english_cleaners_extended` — kept out of the
    default so reference-trained checkpoints see identical token
    streams."""
    from forwardtacotron_tpu_torch.text.numbers import extended_normalize
    text = transliterate(text)
    text = extended_normalize(text)
    text = normalize_numbers(text)
    text = expand_abbreviations(text)
    return text


def espeak_available() -> bool:
    return _espeak_binary() is not None


def _espeak_binary() -> str | None:
    for name in ('espeak-ng', 'espeak'):
        path = shutil.which(name)
        if path:
            return path
    return None


_STRESS_MARKS = 'ˈˌ'


def _espeak_phonemize_chunk(chunk: str, lang: str) -> str:
    binary = _espeak_binary()
    result = subprocess.run(
        [binary, '-q', '--ipa', '-v', lang, chunk],
        capture_output=True, text=True, check=True)
    out = result.stdout.replace('\n', ' ').strip()
    # language-switch flags like (en) — removed, as in the reference's
    # phonemizer(language_switch='remove-flags')
    out = re.sub(r'\([a-z\-]+\)', '', out)
    # espeak ties/tie bars stay; stress stripped (with_stress=False)
    return out.translate(str.maketrans('', '', _STRESS_MARKS))


def to_phonemes(text: str, lang: str) -> str:
    """Phonemize `text`, preserving punctuation, stripping stress,
    filtering to the model's phoneme inventory
    (reference: utils/text/cleaners.py:56-67)."""
    if espeak_available():
        pieces = re.split(f'([{re.escape(_PUNCTUATION_MARKS)}])', text)
        result = ''
        for piece in pieces:
            if not piece:
                continue
            if piece in _PUNCTUATION_MARKS:
                result += piece  # attach to the preceding chunk,
                #                  as phonemizer's preserve_punctuation
            elif piece.strip():
                result += (' ' if result else '') \
                    + _espeak_phonemize_chunk(piece.strip(), lang)
        result = result.strip()
    else:
        if not lang.startswith('en') and lang not in _FALLBACK_WARNED:
            _FALLBACK_WARNED.add(lang)
            import warnings
            warnings.warn(
                f'no espeak binary found: falling back to the built-in '
                f'ENGLISH rule G2P although language={lang!r} was '
                f'requested (e.g. the German FastPitch config, reference '
                f'README.md:135). Install espeak-ng for non-English '
                f'phonemization.', stacklevel=2)
        from forwardtacotron_tpu_torch.text.g2p import rule_based_g2p
        result = rule_based_g2p(text)
    return ''.join(p for p in result if p in phonemes_set)


_FALLBACK_WARNED: set = set()


class Cleaner:

    def __init__(self, cleaner_name: str, use_phonemes: bool,
                 lang: str) -> None:
        if cleaner_name == 'english_cleaners':
            self.clean_func = english_cleaners
        elif cleaner_name == 'english_cleaners_extended':
            self.clean_func = english_cleaners_extended
        elif cleaner_name == 'no_cleaners':
            self.clean_func = no_cleaners
        else:
            raise ValueError(
                f'Cleaner not supported: {cleaner_name}! Currently supported: '
                f"['english_cleaners', 'english_cleaners_extended', "
                f"'no_cleaners']")
        self.use_phonemes = use_phonemes
        self.lang = lang

    def __call__(self, text: str) -> str:
        text = self.clean_func(text)
        if self.use_phonemes:
            text = to_phonemes(text, self.lang)
        text = collapse_whitespace(text)
        return text.strip()

    @classmethod
    def from_config(cls, config: Dict[str, Any]) -> 'Cleaner':
        return Cleaner(
            cleaner_name=config['preprocessing']['cleaner_name'],
            use_phonemes=config['preprocessing']['use_phonemes'],
            lang=config['preprocessing']['language'])
