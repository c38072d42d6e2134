"""Number normalization for English text.

Behavioural parity with the reference front-end (utils/text/numbers.py,
which delegates to the `inflect` package): commas removed from numbers,
pounds/dollars expanded, decimal points spelled out, ordinals and
cardinals verbalized, years in (1000, 3000) read as pairs. Implemented
from scratch (no `inflect` in the TPU image).
"""
from __future__ import annotations

import re

_comma_number_re = re.compile(r'([0-9][0-9\,]+[0-9])')
_decimal_number_re = re.compile(r'([0-9]+\.[0-9]+)')
_pounds_re = re.compile(r'£([0-9\,]*[0-9]+)')
_dollars_re = re.compile(r'\$([0-9\.\,]*[0-9]+)')
_ordinal_re = re.compile(r'[0-9]+(st|nd|rd|th)')
_number_re = re.compile(r'[0-9]+')

_ONES = ['zero', 'one', 'two', 'three', 'four', 'five', 'six', 'seven',
         'eight', 'nine', 'ten', 'eleven', 'twelve', 'thirteen', 'fourteen',
         'fifteen', 'sixteen', 'seventeen', 'eighteen', 'nineteen']
_TENS = ['', '', 'twenty', 'thirty', 'forty', 'fifty', 'sixty', 'seventy',
         'eighty', 'ninety']
_SCALES = [(10 ** 12, 'trillion'), (10 ** 9, 'billion'),
           (10 ** 6, 'million'), (10 ** 3, 'thousand'), (100, 'hundred')]

_ORDINAL_IRREGULAR = {
    'one': 'first', 'two': 'second', 'three': 'third', 'five': 'fifth',
    'eight': 'eighth', 'nine': 'ninth', 'twelve': 'twelfth',
}


def _two_digits_to_words(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    if ones == 0:
        return _TENS[tens]
    return f'{_TENS[tens]}-{_ONES[ones]}'


def number_to_words(n: int, andword: str = 'and', zero: str = 'zero',
                    group: int = 0) -> str:
    """Verbalize a non-negative integer.

    `group=2` reads the number two digits at a time (used for years),
    mirroring inflect's grouping mode used by the reference.
    """
    if n == 0:
        return zero
    if group == 2:
        digits = str(n)
        if len(digits) % 2 == 1:
            digits = '0' + digits
        parts = []
        for i in range(0, len(digits), 2):
            pair = int(digits[i:i + 2])
            if pair == 0:
                parts.append('hundred' if i else zero)
            elif pair < 10 and i > 0:
                parts.append(f'{zero} {_ONES[pair]}')
            else:
                parts.append(_two_digits_to_words(pair))
        return ', '.join(parts)

    words = []
    remainder = n
    for scale_value, scale_name in _SCALES:
        if remainder >= scale_value:
            count = remainder // scale_value
            remainder = remainder % scale_value
            if scale_value == 100:
                words.append(f'{_ONES[count]} {scale_name}')
            else:
                words.append(f'{number_to_words(count, andword="")} {scale_name}')
    if remainder > 0:
        tail = _two_digits_to_words(remainder)
        if words and andword:
            words.append(f'{andword} {tail}')
        else:
            words.append(tail)
    return ' '.join(w for w in words if w)


def ordinal_to_words(n: int) -> str:
    cardinal = number_to_words(n, andword='')
    last_word = cardinal.split(' ')[-1]
    if '-' in last_word:
        head, _, tail = last_word.rpartition('-')
        tail_ord = _ORDINAL_IRREGULAR.get(tail, _regular_ordinal(tail))
        replaced = f'{head}-{tail_ord}'
    else:
        replaced = _ORDINAL_IRREGULAR.get(last_word, _regular_ordinal(last_word))
    return ' '.join(cardinal.split(' ')[:-1] + [replaced])


def _regular_ordinal(word: str) -> str:
    if word.endswith('y'):
        return word[:-1] + 'ieth'
    if word.endswith('e') and word in ('nine', 'twelve'):
        return word[:-1] + 'th'
    return word + 'th'


def _remove_commas(m: re.Match) -> str:
    return m.group(1).replace(',', '')


def _expand_decimal_point(m: re.Match) -> str:
    return m.group(1).replace('.', ' point ')


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1)
    parts = match.split('.')
    if len(parts) > 2:
        return match + ' dollars'
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = 'dollar' if dollars == 1 else 'dollars'
        cent_unit = 'cent' if cents == 1 else 'cents'
        return f'{dollars} {dollar_unit}, {cents} {cent_unit}'
    if dollars:
        return f'{dollars} {"dollar" if dollars == 1 else "dollars"}'
    if cents:
        return f'{cents} {"cent" if cents == 1 else "cents"}'
    return 'zero dollars'


def _expand_ordinal(m: re.Match) -> str:
    return ordinal_to_words(int(re.sub(r'[a-z]', '', m.group(0))))


def _expand_number(m: re.Match) -> str:
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return 'two thousand'
        if 2000 < num < 2010:
            return 'two thousand ' + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + ' hundred'
        return number_to_words(num, andword='', zero='oh',
                               group=2).replace(', ', ' ')
    return number_to_words(num, andword='')


def normalize_numbers(text: str) -> str:
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, r'\1 pounds', text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text


# ------------------------------------------------- extended (opt-in)
# Beyond the reference's normalizer: clock times, percent, negative
# numbers. NOT part of `english_cleaners` — changing default cleaning
# would alter token streams for reference-trained checkpoints; select
# `cleaner_name: english_cleaners_extended` to enable.

_time_re = re.compile(
    r'\b([01]?\d|2[0-3]):([0-5]\d)(\s*(?:[ap]\.?m\.?))?\b',
    re.IGNORECASE)
_percent_re = re.compile(r'([0-9]+(?:\.[0-9]+)?)\s*%')
_negative_re = re.compile(r'(?<![\w\-])-([0-9]+(?:\.[0-9]+)?)')


def _expand_time(m: re.Match) -> str:
    hour, minute = int(m.group(1)), int(m.group(2))
    suffix = ''
    if m.group(3):
        ap = m.group(3).strip().replace('.', '').lower()
        suffix = ' a m' if ap == 'am' else ' p m'
    if hour == 0 and minute == 0:
        return 'midnight' + suffix
    h = number_to_words(hour if hour != 0 else 12, andword='')
    if minute == 0:
        return f'{h} o\'clock{suffix}' if not suffix \
            else f'{h}{suffix}'
    if minute < 10:
        return f'{h} oh {number_to_words(minute, andword="")}{suffix}'
    return f'{h} {number_to_words(minute, andword="")}{suffix}'


def extended_normalize(text: str) -> str:
    """Time / percent / negative-number expansion, applied BEFORE
    normalize_numbers (which then handles any digits this introduces
    or leaves in place)."""
    text = re.sub(_time_re, _expand_time, text)
    text = re.sub(_percent_re, r'\1 percent', text)
    text = re.sub(_negative_re, r'minus \1', text)
    return text
