"""Model vocabulary: the IPA phoneme id table.

The table contents and ordering are a frozen compatibility surface — token
ids must match the reference (utils/text/symbols.py:8-23) exactly, because
embedding rows in any converted checkpoint are indexed by these ids.
"""

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

phonemes = list(
    _pad + _punctuation + _special + _vowels + _non_pulmonic_consonants
    + _pulmonic_consonants + _suprasegmentals + _other_symbols + _diacrilics
) + _extra_phons

phonemes_set = set(phonemes)

PAD_ID = 0
