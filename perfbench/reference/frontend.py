"""The reference's text front end for the benchmark's traffic: the
published phoneme table (ForwardTacotron's utils/text/symbols.py) and a
frozen lexicon of the words the text generator draws from
(`perfbench/traffic/lexicon.tsv`: word, then its IPA without stress as
the English rules give it). A text of lexicon words joined by single
spaces and closed by one punctuation mark phonemizes word by word, so
its token ids are the table's ids of the joined IPA.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List

_pad = '_'
_punctuation = '!\'(),.:;? '
_special = '-'
_vowels = 'iyɨʉɯuɪʏʊeøɘəɵɤoɛœɜɞʌɔæɐaɶɑɒᵻ'
_non_pulmonic_consonants = 'ʘɓǀɗǃʄǂɠǁʛ'
_pulmonic_consonants = ('pbtdʈɖcɟkɡqɢʔɴŋɲɳnɱmʙrʀⱱɾɽɸβfvθðszʃʒʂʐçʝxɣχʁħʕhɦɬɮʋɹɻ'
                        'jɰlɭʎʟ')
_suprasegmentals = 'ˈˌːˑ'
_other_symbols = 'ʍwɥʜʢʡɕʑɺɧ'
_diacrilics = 'ɚ˞ɫ'
_extra_phons = ['g', 'ɝ', '̃', '̍', '̥', '̩', '̯', '͡']

SYMBOLS = list(
    _pad + _punctuation + _special + _vowels + _non_pulmonic_consonants
    + _pulmonic_consonants + _suprasegmentals + _other_symbols + _diacrilics
) + _extra_phons
SYMBOL_ID = {s: i for i, s in enumerate(SYMBOLS)}

LEXICON_PATH = Path(__file__).resolve().parent.parent / 'traffic' / \
    'lexicon.tsv'


def load_lexicon(path: Path = LEXICON_PATH) -> Dict[str, str]:
    out = {}
    for line in path.read_text(encoding='utf-8').splitlines():
        if line.strip():
            word, ipa = line.split('\t')
            out[word] = ipa
    return out


def token_ids(text: str, lexicon: Dict[str, str]) -> List[int]:
    """Ids of a generated text: lexicon words separated by single spaces,
    the last one followed by its punctuation mark."""
    words = text[:-1].split(' ')
    ipa = ' '.join(lexicon[w] for w in words) + text[-1]
    return [SYMBOL_ID[c] for c in ipa if c in SYMBOL_ID]
