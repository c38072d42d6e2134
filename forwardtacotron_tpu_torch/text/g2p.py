"""Built-in rule-based English grapheme-to-phoneme fallback.

Used by `to_phonemes` (cleaners.py) only when no espeak binary is
installed, so the full pipeline stays runnable in a hermetic TPU image.
Emits IPA restricted to the model inventory (symbols.py). It is a
compact longest-match rule engine with a lexicon of frequent
irregular words — not a replacement for espeak quality, but produces
stable, deterministic phoneme sequences for training and smoke tests.
"""
from __future__ import annotations

import re

# Frequent irregular words (en-us, espeak-style IPA without stress).
_LEXICON = {
    'a': 'ə', 'an': 'æn', 'the': 'ðə', 'of': 'ʌv', 'to': 'tuː',
    'and': 'ænd', 'in': 'ɪn', 'is': 'ɪz', 'it': 'ɪt', 'you': 'juː',
    'that': 'ðæt', 'he': 'hiː', 'was': 'wʌz', 'for': 'fɔːɹ', 'are': 'ɑːɹ',
    'as': 'æz', 'with': 'wɪð', 'his': 'hɪz', 'they': 'ðeɪ', 'i': 'aɪ',
    'be': 'biː', 'at': 'æt', 'one': 'wʌn', 'have': 'hæv', 'this': 'ðɪs',
    'from': 'fɹʌm', 'or': 'ɔːɹ', 'had': 'hæd', 'by': 'baɪ', 'word': 'wɜːd',
    'but': 'bʌt', 'not': 'nɑːt', 'what': 'wʌt', 'all': 'ɔːl',
    'were': 'wɜː', 'we': 'wiː', 'when': 'wɛn', 'your': 'jʊɹ', 'can': 'kæn',
    'said': 'sɛd', 'there': 'ðɛɹ', 'use': 'juːs', 'each': 'iːtʃ',
    'which': 'wɪtʃ', 'she': 'ʃiː', 'do': 'duː', 'how': 'haʊ',
    'their': 'ðɛɹ', 'if': 'ɪf', 'will': 'wɪl', 'up': 'ʌp', 'other': 'ʌðɚ',
    'about': 'əbaʊt', 'out': 'aʊt', 'many': 'mɛni', 'then': 'ðɛn',
    'them': 'ðɛm', 'these': 'ðiːz', 'so': 'soʊ', 'some': 'sʌm',
    'her': 'hɜː', 'would': 'wʊd', 'make': 'meɪk', 'like': 'laɪk',
    'him': 'hɪm', 'into': 'ɪntuː', 'time': 'taɪm', 'has': 'hæz',
    'look': 'lʊk', 'two': 'tuː', 'more': 'mɔːɹ', 'go': 'ɡoʊ', 'see': 'siː',
    'no': 'noʊ', 'way': 'weɪ', 'could': 'kʊd', 'my': 'maɪ', 'than': 'ðæn',
    'first': 'fɜːst', 'been': 'bɪn', 'who': 'huː', 'its': 'ɪts',
    'now': 'naʊ', 'people': 'piːpəl', 'over': 'oʊvɚ', 'did': 'dɪd',
    'down': 'daʊn', 'only': 'oʊnli', 'little': 'lɪɾəl', 'very': 'vɛɹi',
    'after': 'æftɚ', 'where': 'wɛɹ', 'most': 'moʊst', 'through': 'θɹuː',
    'before': 'bɪfɔːɹ', 'our': 'aʊɚ', 'good': 'ɡʊd', 'me': 'miː',
    'give': 'ɡɪv', 'does': 'dʌz', 'here': 'hɪɹ', 'hello': 'həloʊ',
    'world': 'wɜːld', 'again': 'əɡɛn', 'any': 'ɛni', 'because': 'bɪkʌz',
    'say': 'seɪ', 'says': 'sɛz', 'once': 'wʌns', 'water': 'wɔːɾɚ',
    'work': 'wɜːk', 'know': 'noʊ', 'should': 'ʃʊd', 'something': 'sʌmθɪŋ',
    'eye': 'aɪ', 'eyes': 'aɪz', 'great': 'ɡɹeɪt', 'own': 'oʊn',
    'thought': 'θɔːt', 'laugh': 'læf', 'enough': 'ɪnʌf', 'though': 'ðoʊ',
    'speech': 'spiːtʃ', 'mister': 'mɪstɚ', 'doctor': 'dɑːktɚ',
    'why': 'waɪ', 'woman': 'wʊmən', 'women': 'wɪmɪn', 'man': 'mæn',
    'men': 'mɛn', 'three': 'θɹiː', 'four': 'fɔːɹ', 'five': 'faɪv',
    'six': 'sɪks', 'seven': 'sɛvən', 'eight': 'eɪt', 'nine': 'naɪn',
    'ten': 'tɛn', 'hundred': 'hʌndɹəd', 'thousand': 'θaʊzənd',
    'million': 'mɪljən', 'second': 'sɛkənd', 'third': 'θɜːd', 'new': 'nuː',
    'old': 'oʊld', 'right': 'ɹaɪt', 'left': 'lɛft', 'long': 'lɔːŋ',
    'big': 'bɪɡ', 'high': 'haɪ', 'small': 'smɔːl', 'large': 'lɑːɹdʒ',
    'next': 'nɛkst', 'early': 'ɜːli', 'young': 'jʌŋ',
    'important': 'ɪmpɔːɹtənt', 'few': 'fjuː', 'public': 'pʌblɪk',
    'bad': 'bæd', 'same': 'seɪm', 'able': 'eɪbəl', 'night': 'naɪt',
    'day': 'deɪ', 'year': 'jɪɹ', 'years': 'jɪɹz', 'week': 'wiːk',
    'month': 'mʌnθ', 'hour': 'aʊɚ', 'house': 'haʊs', 'school': 'skuːl',
    'state': 'steɪt', 'family': 'fæmɪli', 'student': 'stuːdənt',
    'group': 'ɡɹuːp', 'country': 'kʌntɹi', 'problem': 'pɹɑːbləm',
    'hand': 'hænd', 'part': 'pɑːɹt', 'place': 'pleɪs', 'case': 'keɪs',
    'system': 'sɪstəm', 'program': 'pɹoʊɡɹæm', 'question': 'kwɛstʃən',
    'government': 'ɡʌvɚnmənt', 'number': 'nʌmbɚ', 'point': 'pɔɪnt',
    'home': 'hoʊm', 'room': 'ɹuːm', 'mother': 'mʌðɚ', 'father': 'fɑːðɚ',
    'money': 'mʌni', 'story': 'stɔːɹi', 'fact': 'fækt', 'lot': 'lɑːt',
    'study': 'stʌdi', 'book': 'bʊk', 'words': 'wɜːdz',
    'business': 'bɪznəs', 'issue': 'ɪʃuː', 'side': 'saɪd', 'kind': 'kaɪnd',
    'head': 'hɛd', 'service': 'sɜːvɪs', 'friend': 'fɹɛnd', 'power': 'paʊɚ',
    'game': 'ɡeɪm', 'line': 'laɪn', 'end': 'ɛnd', 'member': 'mɛmbɚ',
    'law': 'lɔː', 'car': 'kɑːɹ', 'city': 'sɪɾi', 'community': 'kəmjuːnɪɾi',
    'name': 'neɪm', 'president': 'pɹɛzɪdənt', 'team': 'tiːm',
    'minute': 'mɪnɪt', 'idea': 'aɪdiːə', 'body': 'bɑːdi',
    'information': 'ɪnfɚmeɪʃən', 'back': 'bæk', 'face': 'feɪs',
    'others': 'ʌðɚz', 'level': 'lɛvəl', 'office': 'ɔːfɪs', 'door': 'dɔːɹ',
    'health': 'hɛlθ', 'person': 'pɜːsən', 'art': 'ɑːɹt', 'war': 'wɔːɹ',
    'history': 'hɪstɚɹi', 'party': 'pɑːɹɾi', 'result': 'ɹɪzʌlt',
    'change': 'tʃeɪndʒ', 'morning': 'mɔːɹnɪŋ', 'reason': 'ɹiːzən',
    'research': 'ɹiːsɜːtʃ', 'girl': 'ɡɜːl', 'boy': 'bɔɪ', 'guy': 'ɡaɪ',
    'moment': 'moʊmənt', 'air': 'ɛɹ', 'teacher': 'tiːtʃɚ',
    'force': 'fɔːɹs', 'education': 'ɛdʒukeɪʃən', 'foot': 'fʊt',
    'feet': 'fiːt', 'music': 'mjuːzɪk', 'sound': 'saʊnd', 'voice': 'vɔɪs',
    'language': 'læŋɡwɪdʒ', 'come': 'kʌm', 'comes': 'kʌmz', 'came': 'keɪm',
    'get': 'ɡɛt', 'gets': 'ɡɛts', 'got': 'ɡɑːt', 'made': 'meɪd',
    'makes': 'meɪks', 'going': 'ɡoʊɪŋ', 'goes': 'ɡoʊz', 'went': 'wɛnt',
    'gone': 'ɡɔːn', 'take': 'teɪk', 'takes': 'teɪks', 'took': 'tʊk',
    'taken': 'teɪkən', 'find': 'faɪnd', 'found': 'faʊnd', 'gave': 'ɡeɪv',
    'tell': 'tɛl', 'told': 'toʊld', 'become': 'bɪkʌm', 'became': 'bɪkeɪm',
    'show': 'ʃoʊ', 'leave': 'liːv', 'feel': 'fiːl', 'felt': 'fɛlt',
    'put': 'pʊt', 'mean': 'miːn', 'keep': 'kiːp', 'kept': 'kɛpt',
    'let': 'lɛt', 'begin': 'bɪɡɪn', 'began': 'bɪɡæn', 'seem': 'siːm',
    'help': 'hɛlp', 'talk': 'tɔːk', 'turn': 'tɜːn', 'start': 'stɑːɹt',
    'might': 'maɪt', 'move': 'muːv', 'live': 'lɪv', 'believe': 'bɪliːv',
    'hold': 'hoʊld', 'bring': 'bɹɪŋ', 'brought': 'bɹɔːt',
    'happen': 'hæpən', 'must': 'mʌst', 'write': 'ɹaɪt', 'wrote': 'ɹoʊt',
    'written': 'ɹɪtən', 'provide': 'pɹəvaɪd', 'sit': 'sɪt', 'sat': 'sæt',
    'stand': 'stænd', 'stood': 'stʊd', 'lose': 'luːz', 'lost': 'lɔːst',
    'pay': 'peɪ', 'paid': 'peɪd', 'meet': 'miːt', 'met': 'mɛt',
    'include': 'ɪnkluːd', 'continue': 'kəntɪnjuː', 'set': 'sɛt',
    'learn': 'lɜːn', 'understand': 'ʌndɚstænd', 'watch': 'wɑːtʃ',
    'follow': 'fɑːloʊ', 'stop': 'stɑːp', 'create': 'kɹiːeɪt',
    'speak': 'spiːk', 'spoke': 'spoʊk', 'read': 'ɹiːd', 'allow': 'əlaʊ',
    'add': 'æd', 'spend': 'spɛnd', 'grow': 'ɡɹoʊ', 'open': 'oʊpən',
    'walk': 'wɔːk', 'win': 'wɪn', 'won': 'wʌn', 'offer': 'ɔːfɚ',
    'remember': 'ɹɪmɛmbɚ', 'love': 'lʌv', 'consider': 'kənsɪdɚ',
    'appear': 'əpɪɹ', 'buy': 'baɪ', 'bought': 'bɔːt', 'wait': 'weɪt',
    'serve': 'sɜːv', 'die': 'daɪ', 'died': 'daɪd', 'send': 'sɛnd',
    'sent': 'sɛnt', 'expect': 'ɪkspɛkt', 'build': 'bɪld', 'built': 'bɪlt',
    'stay': 'steɪ', 'fall': 'fɔːl', 'fell': 'fɛl', 'cut': 'kʌt',
    'reach': 'ɹiːtʃ', 'kill': 'kɪl', 'remain': 'ɹɪmeɪn', 'dog': 'dɑːɡ',
    'cat': 'kæt', 'bird': 'bɜːd', 'heart': 'hɑːɹt', 'earth': 'ɜːθ',
    'heard': 'hɜːd', 'sure': 'ʃʊɹ', 'sugar': 'ʃʊɡɚ', 'machine': 'məʃiːn',
    'special': 'spɛʃəl', 'social': 'soʊʃəl', 'ocean': 'oʊʃən',
    'usual': 'juːʒuəl', 'measure': 'mɛʒɚ', 'pleasure': 'plɛʒɚ',
    'treasure': 'tɹɛʒɚ', 'vision': 'vɪʒən', 'version': 'vɜːʒən',
    'television': 'tɛlɪvɪʒən', 'beautiful': 'bjuːɾɪfəl', 'busy': 'bɪzi',
    'island': 'aɪlənd', 'answer': 'ænsɚ', 'often': 'ɔːfən',
    'listen': 'lɪsən', 'iron': 'aɪɚn', 'colonel': 'kɜːnəl',
    'choir': 'kwaɪɚ', 'heir': 'ɛɹ', 'honest': 'ɑːnɪst', 'honor': 'ɑːnɚ',
    'ghost': 'ɡoʊst', 'today': 'tədeɪ', 'tomorrow': 'təmɑːɹoʊ',
    'yesterday': 'jɛstɚdeɪ', 'always': 'ɔːlweɪz', 'already': 'ɔːlɹɛdi',
    'almost': 'ɔːlmoʊst', 'also': 'ɔːlsoʊ', 'although': 'ɔːlðoʊ',
    'together': 'təɡɛðɚ', 'another': 'ənʌðɚ', 'anything': 'ɛniθɪŋ',
    'everything': 'ɛvɹiθɪŋ', 'nothing': 'nʌθɪŋ', 'everyone': 'ɛvɹiwʌn',
    'anyone': 'ɛniwʌn', 'someone': 'sʌmwʌn', 'somebody': 'sʌmbɑːdi',
    'nobody': 'noʊbɑːdi', 'every': 'ɛvɹi', 'never': 'nɛvɚ', 'ever': 'ɛvɚ',
    'however': 'haʊɛvɚ', 'between': 'bɪtwiːn', 'against': 'əɡɛnst',
    'during': 'dʊɹɪŋ', 'without': 'wɪðaʊt', 'within': 'wɪðɪn',
    'around': 'əɹaʊnd', 'across': 'əkɹɔːs', 'behind': 'bɪhaɪnd',
    'toward': 'tɔːɹd', 'towards': 'tɔːɹdz', 'above': 'əbʌv',
    'below': 'bɪloʊ', 'under': 'ʌndɚ', 'until': 'ʌntɪl', 'since': 'sɪns',
    'while': 'waɪl', 'along': 'əlɔːŋ', 'among': 'əmʌŋ', 'away': 'əweɪ',
    'ago': 'əɡoʊ', 'else': 'ɛls', 'per': 'pɜː', 'both': 'boʊθ',
    'neither': 'niːðɚ', 'either': 'aɪðɚ', 'several': 'sɛvɹəl',
    'certain': 'sɜːtən', 'whole': 'hoʊl', 'real': 'ɹiːl', 'really': 'ɹiːli',
    'maybe': 'meɪbi', 'perhaps': 'pɚhæps', 'quite': 'kwaɪt',
    'rather': 'ɹæðɚ', 'instead': 'ɪnstɛd', 'please': 'pliːz',
    'thank': 'θæŋk', 'thanks': 'θæŋks', 'sorry': 'sɑːɹi', 'okay': 'oʊkeɪ',
    'yes': 'jɛs', 'yeah': 'jɛə', 'oh': 'oʊ', 'well': 'wɛl',
    'just': 'dʒʌst', 'even': 'iːvən', 'still': 'stɪl', 'too': 'tuː',
    'much': 'mʌtʃ', 'such': 'sʌtʃ', 'being': 'biːɪŋ', 'having': 'hævɪŋ',
    'doing': 'duːɪŋ', 'done': 'dʌn', 'seen': 'siːn', 'saw': 'sɔː',
    'knew': 'nuː', 'known': 'noʊn', 'thinks': 'θɪŋks', 'think': 'θɪŋk',
    'want': 'wɑːnt', 'wants': 'wɑːnts', 'wanted': 'wɑːntᵻd',
    'need': 'niːd', 'call': 'kɔːl', 'called': 'kɔːld', 'try': 'tɹaɪ',
    'tried': 'tɹaɪd', 'ask': 'æsk', 'asked': 'æskt', 'used': 'juːzd',
    'using': 'juːzɪŋ', 'user': 'juːzɚ', 'users': 'juːzɚz',
    'saying': 'seɪɪŋ', 'dead': 'dɛd', 'death': 'dɛθ', 'bread': 'bɹɛd',
    'ready': 'ɹɛdi', 'weather': 'wɛðɚ', 'whether': 'wɛðɚ', 'heavy': 'hɛvi',
    'breakfast': 'bɹɛkfəst', 'sweat': 'swɛt', 'spread': 'spɹɛd',
    'threat': 'θɹɛt', 'wealth': 'wɛlθ', 'meant': 'mɛnt', 'breath': 'bɹɛθ',
    # noun/verb orthographic collisions: -ing/-ed attach to the e-verb
    # (breathe/bathe/clothe), but the bare noun stem wins the lexicon
    # lookup — pin the inflected verb forms explicitly
    'breathe': 'bɹiːð', 'breathing': 'bɹiːðɪŋ', 'breathed': 'bɹiːðd',
    'bathe': 'beɪð', 'bathing': 'beɪðɪŋ', 'bathed': 'beɪðd',
    'clothe': 'kloʊð', 'clothing': 'kloʊðɪŋ', 'clothed': 'kloʊðd',
    # single-vowel th e-verbs (the VVth digraph rule in morphology
    # can't see these — 'writh' spells like 'froth')
    'writhe': 'ɹaɪð', 'tithe': 'taɪð', 'scathe': 'skeɪð',
    'mouthed': 'maʊðd', 'mouthing': 'maʊðɪŋ',
    'soothe': 'suːð', 'loathe': 'loʊð', 'seethe': 'siːð',
    # Latinate -as/-us/-is nouns whose plural appends -es: without a
    # lexicon stem the sibilant-es branch mistakes them for e-stems
    # (buses -> 'buse')
    'bus': 'bʌs', 'gas': 'ɡæs', 'atlas': 'ætləs', 'census': 'sɛnsəs',
    'walrus': 'wɔːlɹəs', 'promise': 'pɹɑːmɪs', 'canvas': 'kænvəs',
    'iris': 'aɪɹɪs', 'crisis': 'kɹaɪsɪs',
    # round-4 expanded-eval additions: stems the rule scan renders
    # wrong and morphology composes over
    'temperature': 'tɛmpɹətʃɚ', 'plunge': 'plʌndʒ', 'worse': 'wɜːs',
    'moss': 'mɔːs', 'chimney': 'tʃɪmni',
    'weapon': 'wɛpən', 'pleasant': 'plɛzənt', 'jealous': 'dʒɛləs',
    'leather': 'lɛðɚ', 'feather': 'fɛðɚ', 'steady': 'stɛdi',
    'ahead': 'əhɛd', 'break': 'bɹeɪk', 'steak': 'steɪk', 'glove': 'ɡlʌv',
    'dove': 'dʌv', 'none': 'nʌn', 'nonsense': 'nɑːnsɛns',
    'months': 'mʌnθs', 'front': 'fɹʌnt', 'son': 'sʌn', 'ton': 'tʌn',
    'monkey': 'mʌŋki', 'onion': 'ʌnjən', 'union': 'juːnjən', 'orange': 'ɔːɹɪndʒ', 'elephant': 'ɛlɪfənt', 'brother': 'bɹʌðɚ',
    'cover': 'kʌvɚ', 'color': 'kʌlɚ', 'colour': 'kʌlɚ',
    'company': 'kʌmpəni', 'couple': 'kʌpəl', 'cousin': 'kʌzən',
    'double': 'dʌbəl', 'trouble': 'tɹʌbəl', 'touch': 'tʌtʃ',
    'tough': 'tʌf', 'rough': 'ɹʌf', 'blood': 'blʌd', 'flood': 'flʌd',
    'mouth': 'maʊθ', 'south': 'saʊθ', 'north': 'nɔːɹθ', 'course': 'kɔːɹs',
    'court': 'kɔːɹt', 'floor': 'flɔːɹ', 'poor': 'pʊɹ', 'tour': 'tʊɹ',
    'hours': 'aʊɚz', 'journey': 'dʒɜːni', 'soup': 'suːp',
    'throughout': 'θɹuːaʊt', 'youth': 'juːθ', 'prove': 'pɹuːv',
    'whose': 'huːz', 'shoe': 'ʃuː', 'shoes': 'ʃuːz', 'truth': 'tɹuːθ',
    'fruit': 'fɹuːt', 'juice': 'dʒuːs', 'beauty': 'bjuːɾi', 'view': 'vjuː',
    'friends': 'fɹɛndz', 'field': 'fiːld', 'piece': 'piːs',
    'chief': 'tʃiːf', 'brief': 'bɹiːf', 'receive': 'ɹɪsiːv',
    'ceiling': 'siːlɪŋ', 'height': 'haɪt', 'neighbor': 'neɪbɚ',
    'weight': 'weɪt', 'weigh': 'weɪ', 'wear': 'wɛɹ', 'bear': 'bɛɹ',
    'pear': 'pɛɹ', 'tear': 'tɛɹ', 'swear': 'swɛɹ', 'near': 'nɪɹ',
    'hear': 'hɪɹ', 'clear': 'klɪɹ', 'dear': 'dɪɹ', 'fear': 'fɪɹ',
    'area': 'ɛɹiə', 'theater': 'θiːəɾɚ', 'science': 'saɪəns',
    'quiet': 'kwaɪət', 'society': 'səsaɪəɾi', 'variety': 'vəɹaɪəɾi',
    'anxiety': 'æŋzaɪəɾi', 'diet': 'daɪət', 'lion': 'laɪən',
    'giant': 'dʒaɪənt', 'bias': 'baɪəs', 'via': 'vaɪə',
    'violin': 'vaɪəlɪn', 'violence': 'vaɪələns', 'period': 'pɪɹiəd',
    'serious': 'sɪɹiəs', 'experience': 'ɪkspɪɹiəns',
    'material': 'mətɪɹiəl', 'radio': 'ɹeɪdioʊ', 'video': 'vɪdioʊ',
    'audio': 'ɔːdioʊ', 'studio': 'stuːdioʊ', 'media': 'miːdiə',
    'immediately': 'ɪmiːdiətli', 'obvious': 'ɑːbviəs',
    'previous': 'pɹiːviəs', 'various': 'vɛɹiəs', 'curious': 'kjʊɹiəs',
    'ancient': 'eɪnʃənt', 'patient': 'peɪʃənt', 'efficient': 'ɪfɪʃənt',
    'sufficient': 'səfɪʃənt', 'especially': 'ɪspɛʃəli',
    'specific': 'spəsɪfɪk', 'appreciate': 'əpɹiːʃieɪt',
    'associate': 'əsoʊsieɪt', 'negotiate': 'nɪɡoʊʃieɪt',
    'initial': 'ɪnɪʃəl', 'official': 'əfɪʃəl', 'financial': 'faɪnænʃəl',
    'commercial': 'kəmɜːʃəl', 'essential': 'ɪsɛnʃəl',
    'potential': 'pətɛnʃəl', 'professional': 'pɹəfɛʃənəl',
    'international': 'ɪntɚnæʃənəl', 'national': 'næʃənəl',
    'personal': 'pɜːsənəl', 'general': 'dʒɛnɚɹəl', 'natural': 'nætʃɚɹəl',
    'cultural': 'kʌltʃɚɹəl', 'central': 'sɛntɹəl',
    'political': 'pəlɪɾɪkəl', 'physical': 'fɪzɪkəl', 'typical': 'tɪpɪkəl',
    'critical': 'kɹɪɾɪkəl', 'practical': 'pɹæktɪkəl',
    'technical': 'tɛknɪkəl', 'chemical': 'kɛmɪkəl', 'medical': 'mɛdɪkəl',
    'musical': 'mjuːzɪkəl', 'local': 'loʊkəl', 'total': 'toʊɾəl',
    'final': 'faɪnəl', 'model': 'mɑːdəl', 'legal': 'liːɡəl',
    'global': 'ɡloʊbəl', 'digital': 'dɪdʒɪɾəl', 'capital': 'kæpɪɾəl',
    'hospital': 'hɑːspɪɾəl', 'animal': 'ænɪməl', 'normal': 'nɔːɹməl',
    'formal': 'fɔːɹməl', 'signal': 'sɪɡnəl', 'channel': 'tʃænəl',
    'control': 'kəntɹoʊl', 'magazine': 'mæɡəziːn', 'routine': 'ɹuːtiːn',
    'engine': 'ɛndʒɪn', 'examine': 'ɪɡzæmɪn', 'determine': 'dɪtɜːmɪn',
    'imagine': 'ɪmædʒɪn', 'medicine': 'mɛdɪsɪn', 'genuine': 'dʒɛnjuɪn',
    'define': 'dɪfaɪn', 'design': 'dɪzaɪn', 'sign': 'saɪn',
    'signed': 'saɪnd', 'campaign': 'kæmpeɪn', 'foreign': 'fɔːɹɪn',
    'recipe': 'ɹɛsɪpi', 'cafe': 'kæfeɪ', 'karate': 'kəɹɑːɾi',
    'coyote': 'kaɪoʊɾi', 'epitome': 'ɪpɪɾəmi', 'apostrophe': 'əpɑːstɹəfi',
    'catastrophe': 'kətæstɹəfi', 'simile': 'sɪmɪli', 'committee': 'kəmɪɾi',
    'coffee': 'kɔːfi', 'toffee': 'tɔːfi', 'purple': 'pɜːpəl',
    'simple': 'sɪmpəl', 'example': 'ɪɡzæmpəl', 'possible': 'pɑːsɪbəl',
    'impossible': 'ɪmpɑːsɪbəl', 'available': 'əveɪləbəl',
    'probably': 'pɹɑːbəbli', 'suggestion': 'səɡdʒɛstʃən',
    'mountain': 'maʊntən', 'fountain': 'faʊntən', 'captain': 'kæptən',
    'curtain': 'kɜːtən', 'britain': 'bɹɪtən', 'bargain': 'bɑːɹɡən',
    'villain': 'vɪlən', 'mind': 'maɪnd', 'blind': 'blaɪnd',
    'child': 'tʃaɪld', 'children': 'tʃɪldɹən', 'wild': 'waɪld',
    'mild': 'maɪld', 'climb': 'klaɪm', 'comb': 'koʊm', 'tomb': 'tuːm',
    'womb': 'wuːm', 'bomb': 'bɑːm', 'thumb': 'θʌm', 'dumb': 'dʌm',
    'lamb': 'læm', 'limb': 'lɪm', 'debt': 'dɛt', 'doubt': 'daʊt',
    'subtle': 'sʌɾəl', 'castle': 'kæsəl', 'whistle': 'wɪsəl',
    'wrestle': 'ɹɛsəl', 'muscle': 'mʌsəl', 'scene': 'siːn',
    'scent': 'sɛnt', 'scissors': 'sɪzɚz', 'psychology': 'saɪkɑːlədʒi',
    'receipt': 'ɹɪsiːt', 'aisle': 'aɪl', 'isle': 'aɪl', 'salmon': 'sæmən',
    'half': 'hæf', 'calf': 'kæf', 'chalk': 'tʃɔːk', 'folk': 'foʊk',
    'yolk': 'joʊk', 'calm': 'kɑːm', 'palm': 'pɑːm', 'wolf': 'wʊlf',
    'wolves': 'wʊlvz', 'push': 'pʊʃ', 'pull': 'pʊl', 'full': 'fʊl',
    'bull': 'bʊl', 'bush': 'bʊʃ', 'butcher': 'bʊtʃɚ', 'cushion': 'kʊʃən',
    'secure': 'sɪkjʊɹ', 'pure': 'pjʊɹ', 'cure': 'kjʊɹ', 'europe': 'jʊɹəp',
    'jury': 'dʒʊɹi', 'fury': 'fjʊɹi', 'stone': 'stoʊn', 'phone': 'foʊn',
    'bone': 'boʊn', 'alone': 'əloʊn', 'honey': 'hʌni', 'monday': 'mʌndeɪ',
    'tuesday': 'tuːzdeɪ', 'wednesday': 'wɛnzdeɪ', 'thursday': 'θɜːzdeɪ',
    'friday': 'fɹaɪdeɪ', 'saturday': 'sæɾɚdeɪ', 'sunday': 'sʌndeɪ',
    'january': 'dʒænjuɛɹi', 'february': 'fɛbɹuɛɹi', 'march': 'mɑːɹtʃ',
    'april': 'eɪpɹəl', 'may': 'meɪ', 'june': 'dʒuːn', 'july': 'dʒulaɪ',
    'august': 'ɔːɡəst', 'september': 'sɛptɛmbɚ', 'october': 'ɑːktoʊbɚ',
    'november': 'noʊvɛmbɚ', 'december': 'dɪsɛmbɚ', 'america': 'əmɛɹɪkə',
    'american': 'əmɛɹɪkən', 'english': 'ɪŋɡlɪʃ', 'england': 'ɪŋɡlənd',
    'european': 'jʊɹəpiːən', 'china': 'tʃaɪnə', 'chinese': 'tʃaɪniːz',
    'japan': 'dʒəpæn', 'japanese': 'dʒæpəniːz', 'france': 'fɹæns',
    'french': 'fɹɛntʃ', 'german': 'dʒɜːmən', 'germany': 'dʒɜːməni',
    'india': 'ɪndiə', 'russia': 'ɹʌʃə', 'australia': 'ɔːstɹeɪljə',
    'canada': 'kænədə', 'africa': 'æfɹɪkə', 'mexico': 'mɛksɪkoʊ',
    'london': 'lʌndən', 'paris': 'pɛɹɪs', 'computer': 'kəmpjuːɾɚ',
    'internet': 'ɪntɚnɛt', 'website': 'wɛbsaɪt', 'email': 'iːmeɪl',
    'online': 'ɔːnlaɪn', 'software': 'sɔːftwɛɹ',
    'technology': 'tɛknɑːlədʒi', 'telephone': 'tɛlɪfoʊn',
    'camera': 'kæmɹə', 'picture': 'pɪktʃɚ', 'image': 'ɪmɪdʒ',
    'movie': 'muːvi', 'movies': 'muːviz', 'series': 'sɪɹiz',
    'species': 'spiːʃiz', 'item': 'aɪɾəm', 'items': 'aɪɾəmz',
    'evening': 'iːvnɪŋ', 'event': 'ɪvɛnt', 'events': 'ɪvɛnts',
    'process': 'pɹɑːsɛs', 'project': 'pɹɑːdʒɛkt', 'product': 'pɹɑːdʌkt',
    'record': 'ɹɛkɚd', 'report': 'ɹɪpɔːɹt', 'minutes': 'mɪnɪts',
    'according': 'əkɔːɹdɪŋ', 'development': 'dɪvɛləpmənt',
    'different': 'dɪfɹənt', 'difference': 'dɪfɹəns', 'interest': 'ɪntɹəst',
    'interesting': 'ɪntɹəstɪŋ', 'environment': 'ɪnvaɪɹənmənt',
    'economy': 'ɪkɑːnəmi', 'economic': 'ɛkənɑːmɪk', 'industry': 'ɪndəstɹi',
    'military': 'mɪlɪtɛɹi', 'library': 'laɪbɹɛɹi', 'necessary': 'nɛsəsɛɹi',
    'dictionary': 'dɪkʃənɛɹi', 'secretary': 'sɛkɹətɛɹi',
    'category': 'kæɾəɡɔːɹi', 'actually': 'æktʃuəli', 'usually': 'juːʒuəli',
    'finally': 'faɪnəli', 'certainly': 'sɜːtənli',
    'definitely': 'dɛfɪnətli', 'absolutely': 'æbsəluːtli',
    'exactly': 'ɪɡzæktli', 'directly': 'dɚɹɛktli', 'recently': 'ɹiːsəntli',
    'currently': 'kɜːɹəntli', 'suddenly': 'sʌdənli', 'quickly': 'kwɪkli',
    'slowly': 'sloʊli', 'easily': 'iːzɪli', 'simply': 'sɪmpli',
    'nearly': 'nɪɹli', 'clearly': 'klɪɹli', 'basically': 'beɪsɪkli',
    'literally': 'lɪɾɚɹəli', 'brown': 'bɹaʊn', 'town': 'taʊn',
    'crowd': 'kɹaʊd', 'cow': 'kaʊ', 'owl': 'aʊl', 'tower': 'taʊɚ',
    'flower': 'flaʊɚ', 'shower': 'ʃaʊɚ', 'towel': 'taʊəl',
    'vowel': 'vaʊəl', 'brow': 'bɹaʊ', 'eyebrow': 'aɪbɹaʊ',
    'drown': 'dɹaʊn', 'frown': 'fɹaʊn', 'gown': 'ɡaʊn', 'clown': 'klaʊn',
    'crown': 'kɹaʊn', 'plow': 'plaʊ', 'howl': 'haʊl', 'growl': 'ɡɹaʊl',
    'prowl': 'pɹaʊl', 'coward': 'kaʊɚd', 'powder': 'paʊdɚ',
    'chowder': 'tʃaʊdɚ', 'browse': 'bɹaʊz', 'browser': 'bɹaʊzɚ',
    'drowsy': 'dɹaʊzi', 'lazy': 'leɪzi', 'crazy': 'kɹeɪzi',
    'baby': 'beɪbi', 'lady': 'leɪdi', 'tiny': 'taɪni', 'shiny': 'ʃaɪni',
    'paper': 'peɪpɚ', 'later': 'leɪɾɚ', 'maker': 'meɪkɚ',
    'basic': 'beɪsɪk', 'basis': 'beɪsɪs', 'data': 'deɪɾə',
    'label': 'leɪbəl', 'table': 'teɪbəl', 'cable': 'keɪbəl',
    'favor': 'feɪvɚ', 'flavor': 'fleɪvɚ', 'major': 'meɪdʒɚ',
    'navy': 'neɪvi', 'gravy': 'ɡɹeɪvi', 'wavy': 'weɪvi', 'tidy': 'taɪdi',
    'silent': 'saɪlənt', 'pilot': 'paɪlət', 'siren': 'saɪɹən',
    'virus': 'vaɪɹəs', 'minor': 'maɪnɚ', 'spider': 'spaɪdɚ',
    'cider': 'saɪdɚ', 'tiger': 'taɪɡɚ', 'rival': 'ɹaɪvəl',
    'bonus': 'boʊnəs', 'focus': 'foʊkəs', 'photo': 'foʊɾoʊ',
    'solo': 'soʊloʊ', 'logo': 'loʊɡoʊ', 'hero': 'hɪɹoʊ', 'zero': 'zɪɹoʊ',
    'robot': 'ɹoʊbɑːt', 'motor': 'moʊɾɚ', 'soda': 'soʊdə', 'sofa': 'soʊfə',
    'vocal': 'voʊkəl', 'broken': 'bɹoʊkən', 'frozen': 'fɹoʊzən',
    'chosen': 'tʃoʊzən', 'spoken': 'spoʊkən', 'human': 'hjuːmən',
    'humor': 'hjuːmɚ', 'duty': 'duːɾi', 'tuna': 'tuːnə', 'ruby': 'ɹuːbi',
    'super': 'suːpɚ', 'duper': 'duːpɚ', 'tulip': 'tuːlɪp',
    'pupil': 'pjuːpəl', 'unit': 'juːnɪt', 'united': 'juːnaɪɾɪd',
    'uniform': 'juːnɪfɔːɹm', 'universe': 'juːnɪvɜːs',
    'university': 'juːnɪvɜːsɪɾi', 'stomach': 'stʌmək',
    'chemistry': 'kɛmɪstɹi', 'chorus': 'kɔːɹəs', 'character': 'kɛɹəktɚ',
    'christmas': 'kɹɪsməs', 'ache': 'eɪk', 'echo': 'ɛkoʊ',
    'anchor': 'æŋkɚ', 'orchestra': 'ɔːɹkɪstɹə', 'mechanic': 'məkænɪk',
    'mechanical': 'məkænɪkəl', 'architect': 'ɑːɹkɪtɛkt', 'chaos': 'keɪɑːs',
    'chrome': 'kɹoʊm', 'chronic': 'kɹɑːnɪk', 'scheme': 'skiːm',
    'stomachs': 'stʌməks', 'chef': 'ʃɛf', 'chute': 'ʃuːt',
    'brochure': 'bɹoʊʃʊɹ', 'chicago': 'ʃɪkɑːɡoʊ', 'michigan': 'mɪʃɪɡən',
    'mustache': 'mʌstæʃ', 'chevron': 'ʃɛvɹɑːn', 'bureau': 'bjʊɹoʊ',
    'restaurant': 'ɹɛstɹɑːnt', 'sergeant': 'sɑːɹdʒənt',
    'lieutenant': 'luːtɛnənt', 'yacht': 'jɑːt', 'debris': 'dəbɹiː',
    'queue': 'kjuː', 'cheque': 'tʃɛk', 'mortgage': 'mɔːɹɡɪdʒ',
    'ballet': 'bæleɪ', 'buffet': 'bəfeɪ', 'bouquet': 'buːkeɪ',
    'genre': 'ʒɑːnɹə', 'garage': 'ɡəɹɑːʒ', 'massage': 'məsɑːʒ',
    'mirage': 'məɹɑːʒ', 'collage': 'kəlɑːʒ', 'beige': 'beɪʒ',
    'regime': 'ɹəʒiːm', 'prestige': 'pɹɛstiːʒ', 'cliche': 'kliːʃeɪ',
    'jeopardy': 'dʒɛpɚdi', 'leopard': 'lɛpɚd', 'leotard': 'liːətɑːɹd',
    'finger': 'fɪŋɡɚ', 'anger': 'æŋɡɚ', 'hunger': 'hʌŋɡɚ',
    'angry': 'æŋɡɹi', 'hungry': 'hʌŋɡɹi', 'longer': 'lɔːŋɡɚ',
    'stronger': 'stɹɔːŋɡɚ', 'younger': 'jʌŋɡɚ', 'danger': 'deɪndʒɚ',
    'stranger': 'stɹeɪndʒɚ', 'manger': 'meɪndʒɚ',
    'dangerous': 'deɪndʒɚɹəs', 'passenger': 'pæsɪndʒɚ',
    'messenger': 'mɛsɪndʒɚ', 'singer': 'sɪŋɚ', 'ringer': 'ɹɪŋɚ',
    'hanger': 'hæŋɚ', 'gentle': 'dʒɛntəl', 'gentleman': 'dʒɛntəlmən',
    'genius': 'dʒiːniəs', 'gene': 'dʒiːn', 'generation': 'dʒɛnɚɹeɪʃən',
    'generous': 'dʒɛnɚɹəs', 'gesture': 'dʒɛstʃɚ', 'gem': 'dʒɛm',
    'gift': 'ɡɪft', 'gifts': 'ɡɪfts', 'geese': 'ɡiːs', 'gear': 'ɡɪɹ',
    'giggle': 'ɡɪɡəl', 'gill': 'ɡɪl', 'gig': 'ɡɪɡ', 'geyser': 'ɡaɪzɚ',
    'oven': 'ʌvən', 'shove': 'ʃʌv', 'wash': 'wɑːʃ', 'wasp': 'wɑːsp',
    'watt': 'wɑːt', 'swap': 'swɑːp', 'swan': 'swɑːn', 'pour': 'pɔːɹ',
    'source': 'sɔːɹs', 'fourth': 'fɔːɹθ', 'mourn': 'mɔːɹn',
    'beard': 'bɪɹd', 'laughter': 'læftɚ', 'draught': 'dɹæft',
    'occasion': 'əkeɪʒən', 'occasionally': 'əkeɪʒənəli',
    'pressure': 'pɹɛʃɚ', 'assure': 'əʃʊɹ', 'insure': 'ɪnʃʊɹ',
    'ensure': 'ɪnʃʊɹ', 'century': 'sɛntʃɚɹi', 'centuries': 'sɛntʃɚɹiz',
    'penguin': 'pɛŋɡwɪn', 'pretty': 'pɹɪɾi', 'southern': 'sʌðɚn',
    'puss': 'pʊs', 'pudding': 'pʊdɪŋ', 'bosom': 'bʊzəm', 'threw': 'θɹuː',
    'sew': 'soʊ', 'sewn': 'soʊn', 'euro': 'jʊɹoʊ', 'fierce': 'fɪɹs',
    'pierce': 'pɪɹs', 'giraffe': 'dʒɚɹæf', 'ginger': 'dʒɪndʒɚ',
    'exhibit': 'ɪɡzɪbɪt', 'exhibition': 'ɛksɪbɪʃən', 'position': 'pəzɪʃən',
    'positions': 'pəzɪʃənz', 'possession': 'pəzɛʃən', 'dessert': 'dɪzɜːt',
    'desert': 'dɛzɚt', 'resort': 'ɹɪzɔːɹt', 'reserve': 'ɹɪzɜːv',
    'resemble': 'ɹɪzɛmbəl', 'resume': 'ɹɪzuːm', 'observe': 'əbzɜːv',
    'deserve': 'dɪzɜːv', 'present': 'pɹɛzənt', 'presents': 'pɹɛzənts',
    'presentation': 'pɹɛzənteɪʃən', 'visit': 'vɪzɪt', 'visitor': 'vɪzɪɾɚ',
    'positive': 'pɑːzɪɾɪv', 'raisin': 'ɹeɪzən', 'poison': 'pɔɪzən',
    'prison': 'pɹɪzən', 'season': 'siːzən', 'husband': 'hʌzbənd',
    'closet': 'klɑːzɪt', 'deposit': 'dɪpɑːzɪt', 'opposite': 'ɑːpəzɪt',
    'tongue': 'tʌŋ', 'unique': 'juːniːk', 'antique': 'æntiːk',
    'technique': 'tɛkniːk', 'rhythm': 'ɹɪðəm', 'rhyme': 'ɹaɪm',
    'aware': 'əwɛɹ', 'beware': 'bɪwɛɹ', 'awake': 'əweɪk', 'await': 'əweɪt',
    'award': 'əwɔːɹd', 'eleven': 'ɪlɛvən', 'twelve': 'twɛlv',
    'thirteen': 'θɜːtiːn', 'fourteen': 'fɔːɹtiːn', 'fifteen': 'fɪftiːn',
    'sixteen': 'sɪkstiːn', 'seventeen': 'sɛvəntiːn', 'eighteen': 'eɪtiːn',
    'nineteen': 'naɪntiːn', 'twenty': 'twɛnti', 'thirty': 'θɜːɾi',
    'forty': 'fɔːɹɾi', 'fifty': 'fɪfti', 'sixty': 'sɪksti',
    'seventy': 'sɛvənti', 'eighty': 'eɪɾi', 'ninety': 'naɪnti',
    'billion': 'bɪljən', 'trillion': 'tɹɪljən', 'zeroth': 'zɪɹoʊθ',
    'ninth': 'naɪnθ', 'twelfth': 'twɛlfθ', 'fifth': 'fɪfθ',
    'eighth': 'eɪtθ', 'somewhere': 'sʌmwɛɹ', 'anywhere': 'ɛniwɛɹ',
    'everywhere': 'ɛvɹiwɛɹ', 'nowhere': 'noʊwɛɹ', 'anybody': 'ɛnibɑːdi',
    'everybody': 'ɛvɹibɑːdi', 'myself': 'maɪsɛlf', 'yourself': 'jɚsɛlf',
    'himself': 'hɪmsɛlf', 'herself': 'hɚsɛlf', 'itself': 'ɪtsɛlf',
    'ourselves': 'aʊɚsɛlvz', 'yourselves': 'jɚsɛlvz',
    'themselves': 'ðɛmsɛlvz', 'therefore': 'ðɛɹfɔːɹ', 'cannot': 'kænɑːt',
    'upstairs': 'ʌpstɛɹz', 'downstairs': 'daʊnstɛɹz',
    'meanwhile': 'miːnwaɪl', 'moreover': 'mɔːɹoʊvɚ',
    'otherwise': 'ʌðɚwaɪz', 'worthwhile': 'wɜːθwaɪl',
    'elsewhere': 'ɛlswɛɹ', 'budget': 'bʌdʒɪt', 'gadget': 'ɡædʒɪt',
    'widget': 'wɪdʒɪt', 'knowledge': 'nɑːlɪdʒ', 'college': 'kɑːlɪdʒ',
    'clothes': 'kloʊðz', 'vegetable': 'vɛdʒtəbəl',
    'vegetables': 'vɛdʒtəbəlz', 'chocolate': 'tʃɔːklət',
    'explosion': 'ɪksploʊʒən', 'confusion': 'kənfjuːʒən',
    'conclusion': 'kənkluːʒən', 'illusion': 'ɪluːʒən',
    'insurance': 'ɪnʃʊɹəns', 'holy': 'hoʊli', 'wholly': 'hoʊli',
    'target': 'tɑːɹɡɪt', 'forget': 'fɚɡɛt', 'forgot': 'fɚɡɑːt',
    'forgotten': 'fɚɡɑːtən', 'worn': 'wɔːɹn', 'sworn': 'swɔːɹn',
    'sword': 'sɔːɹd', 'resign': 'ɹɪzaɪn',
    'smooth': 'smuːð', 'square': 'skwɛɹ', 'reply': 'ɹɪplaɪ',
    'houses': 'haʊzᵻz', 'ear': 'ɪɹ', 'poem': 'poʊəm',
    'whom': 'huːm', 'cough': 'kɔːf', 'hymn': 'hɪm',
    'attention': 'ətɛnʃən', 'vacation': 'veɪkeɪʃən',
    'banana': 'bənænə', 'balloon': 'bəluːn', 'asleep': 'əsliːp',
    'alive': 'əlaɪv', 'arrive': 'əɹaɪv',
    'potato': 'pəteɪɾoʊ', 'tomato': 'təmeɪɾoʊ', 'hotel': 'hoʊtɛl',
    'police': 'pəliːs', 'surprise': 'sɚpɹaɪz', 'guitar': 'ɡɪtɑːɹ',
    'cigar': 'sɪɡɑːɹ', 'radar': 'ɹeɪdɑːɹ', 'late': 'leɪt',
    'energy': 'ɛnɚdʒi', 'easy': 'iːzi',
    'rely': 'ɹɪlaɪ', 'apply': 'əplaɪ', 'supply': 'səplaɪ',
    'deny': 'dɪnaɪ', 'menu': 'mɛnjuː',
    'venue': 'vɛnjuː', 'wool': 'wʊl', 'wood': 'wʊd',
    # round 5: stress-irregular words the rule engine cannot decide
    # (held-out error analysis, docs/g2p.md)
    # ('T' = a t that must not flap — it heads a stressed syllable)
    'climate': 'klaɪmət', 'particular': 'pɚTɪkjʊlɚ', 'prior': 'pɹaɪɚ',
    'news': 'nuːz', 'emergency': 'ɪmɜːdʒənsi',
    'objective': 'əbdʒɛktɪv', 'negotiation': 'nɪɡoʊʃieɪʃən',
    'mechanism': 'mɛkənɪzəm', 'laboratory': 'læbɹətɔːɹi',
    'refrigerator': 'ɹɪfɹɪdʒɚɹeɪɾɚ', 'vehicle': 'viːɪkəl',
    'squirrel': 'skwɜːɹəl', 'cedar': 'siːdɚ', 'clover': 'kloʊvɚ',
    'dimension': 'daɪmɛnʃən', 'challenge': 'tʃælɪndʒ',
    'analysis': 'ənæləsɪs', 'resource': 'ɹiːsɔːɹs',
    'separate': 'sɛpɚɹeɪt', 'survey': 'sɜːveɪ', 'obey': 'oʊbeɪ',
    'convey': 'kənveɪ', 'advance': 'ədvæns', 'romance': 'ɹoʊmæns',
    'finance': 'faɪnæns', 'perfect': 'pɜːfɪkt',
    'progress': 'pɹɑːɡɹɛs', 'proposal': 'pɹəpoʊzəl',
    'property': 'pɹɑːpɚɾi', 'phenomenon': 'fɪnɑːmɪnɑːn',
    'silence': 'saɪləns', 'recent': 'ɹiːsənt', 'region': 'ɹiːdʒən',
    'statistic': 'stəTɪstɪk', 'comet': 'kɑːmɪt', 'barrel': 'bæɹəl',
    'theory': 'θiəɹi',
    # round 5 (held-out2 error analysis, docs/g2p.md): stress-
    # irregular and loanword pronunciations the rule engine cannot
    # decide (initial-syllable reduction vs secondary stress, French/
    # Greek/Spanish spellings)
    'abdomen': 'æbdəmən', 'absorb': 'əbzɔːɹb',
    'apparatus': 'æpɚɹæɾəs', 'alligator': 'ælɪɡeɪɾɚ',
    'archive': 'ɑːɹkaɪv', 'bulletin': 'bʊlɪTɪn',
    'cauldron': 'kɔːldɹən', 'chassis': 'ʃæsi',
    'cholesterol': 'kəlɛstɚɹɔːl', 'chlorine': 'klɔːɹiːn',
    'commodity': 'kəmɑːdɪɾi', 'compress': 'kəmpɹɛs',
    'condense': 'kəndɛns', 'conglomerate': 'kəŋɡlɑːmɚɹət',
    'conjecture': 'kəndʒɛktʃɚ', 'conscience': 'kɑːnʃəns',
    'contour': 'kɑːntʊɹ', 'cougar': 'kuːɡɚ', 'courier': 'kʊɹiɚ',
    'endeavor': 'ɛndɛvɚ', 'famine': 'fæmɪn', 'ermine': 'ɜːmɪn',
    'fluoride': 'flɔːɹaɪd', 'lapel': 'ləpɛl',
    'mahogany': 'məhɑːɡəni', 'meander': 'miændɚ',
    'monarch': 'mɑːnɚk', 'mosaic': 'moʊzeɪɪk', 'mural': 'mjʊɹəl',
    'patriot': 'peɪtɹiət', 'phoenix': 'fiːnɪks',
    'pistachio': 'pɪstæʃioʊ', 'pueblo': 'pwɛbloʊ',
    'reservoir': 'ɹɛzɚvwɑːɹ', 'rodent': 'ɹoʊdənt',
    'silhouette': 'sɪluːɛt', 'silo': 'saɪloʊ', 'spiral': 'spaɪɹəl',
    'tortoise': 'tɔːɹɾəs', 'trachea': 'tɹeɪkiə',
    'volcano': 'vɑːlkeɪnoʊ', 'lime': 'laɪm',
    'gimmick': 'ɡɪmɪk', 'jagged': 'dʒæɡɪd', 'mauve': 'moʊv',
    'admiral': 'ædmɚɹəl', 'lemur': 'liːmɚ', 'zenith': 'ziːnɪθ',
    'twilight': 'twaɪlaɪt', 'precinct': 'pɹiːsɪŋkt',
    'scallop': 'skɑːləp', 'occult': 'əkʌlt',
}

# Longest-match context-free digraph/letter rules (en-us flavored).
# Order matters within each leading letter group.
_RULES = [
    # round 5 (held-out-driven): latinate suffix families whose
    # unstressed vowels reduce (the dominant held-out error class,
    # docs/g2p.md) — longest patterns first so they win the scan
    ('esolution', 'ɛzəluːʃən'), ('troduction', 'tɹədʌkʃən'),
    ('ecomend', 'ɛkəmɛnd'),
    ('ecognition', 'ɛkəɡnɪʃən'), ('anization', 'ənɪzeɪʃən'),
    ('ortunity', 'ɚtuːnɪɾi'), ('ortation', 'ɚteɪʃən'),
    ('eration', 'ɚɹeɪʃən'),
    ('aration', 'ɚɹeɪʃən'), ('ulation', 'jʊleɪʃən'),
    ('upation', 'jʊpeɪʃən'), ('utation', 'jʊteɪʃən'),
    ('ibution', 'ɪbjuːʃən'), ('itution', 'ɪtuːʃən'),
    ('olution', 'əluːʃən'), ('tuation', 'tʃueɪʃən'),
    ('uation', 'ueɪʃən'), ('ibility', 'əbɪlɪɾi'),
    ('ability', 'əbɪlɪɾi'), ('ividual', 'ɪvɪdʒuəl'),
    ('onality', 'ənælɪɾi'), ('adition', 'ədɪʃən'),
    ('enefit', 'ɛnɪfɪt'),
    ('osophy', 'ɑːsəfi'), ('ocracy', 'ɑːkɹəsi'),
    ('ography', 'ɑːɡɹəfi'), ('ology', 'ɑːlədʒi'),
    ('alysis', 'æləsɪs'), ('emony', 'əmoʊni'), ('phasis', 'fəsɪs'),
    ('cedur', 'siːdʒɚ'), ('quire', 'kwaɪɚ'), ('irect', 'ɚɹɛkt'),
    ('bserv', 'bzɚv'), ('epend', 'ɪpɛnd'),
    ('nsition', 'nzɪʃən'), ('nsion', 'nʃən'), ('cian', 'ʃən'),
    ('source', 'sɔːɹs'), ('eaction', 'iækʃən'), ('eact', 'iækt'),
    ('urity', 'jʊɹɪɾi'),
    ('rument', 'ɹəmənt'), ('ument', 'juːmənt'),
    ('quan', 'kwɑːn'), ('osal', 'oʊzəl'),
    ('ership', 'ɚʃɪp'),
    # yod-dropping after coronals: new -> nuː, crew, blew (few/view
    # keep juː via the generic 'ew' rule)
    ('new', 'nuː'), ('rew', 'ɹuː'), ('lew', 'luː'),
    ('ation', 'eɪʃən'), ('ssion', 'ʃən'), ('tion', 'ʃən'),
    ('sion', 'ʒən'),
    ('oulder', 'oʊldɚ'), ('ought', 'ɔːt'),
    ('eigh', 'eɪ'), ('aigh', 'eɪ'), ('ough', 'ʌf'), ('augh', 'ɔː'), ('tch', 'tʃ'),
    ('sch', 'sk'), ('dge', 'dʒ'), ('igh', 'aɪ'), ('quar', 'kwɔːɹ'),
    ('ing', 'ɪŋ'), ('eau', 'oʊ'),
    # round 5 (held-out2-driven) class rules:
    ('cheon', 'tʃən'),            # luncheon, truncheon
    ('iliar', 'ɪljɚ'),            # familiar, billiards
    ('ucial', 'uːʃəl'),           # crucial
    ('cial', 'ʃəl'),              # social, special, official
    ('liant', 'ljənt'),           # brilliant, valiant
    ('iant', 'aɪənt'),            # giant, defiant, reliant
    ('egion', 'iːdʒən'),          # legion, region
    ('olia', 'oʊliə'),            # magnolia, melancholia
    ('phor', 'fɔːɹ'),             # metaphor, semaphore stem
    ('phony', 'fəni'),            # symphony, telephony
    ('uice', 'uːs'),              # sluice, juice
    # Greek ch before liquids is always hard: chlorine, chrome,
    # chronic (round 5, held-out2-driven)
    ('chl', 'kl'), ('chr', 'kɹ'),
    ('oic', 'oʊɪk'),              # stoic, heroic (before 'oi')
    ('qu', 'kw'), ('ch', 'tʃ'), ('sh', 'ʃ'),
    ('th', 'θ'), ('ph', 'f'), ('wh', 'w'), ('ck', 'k'), ('ng', 'ŋ'),
    ('wr', 'ɹ'), ('kn', 'n'), ('rh', 'ɹ'),
    ('xh', 'ɡz'),
    ('oar', 'ɔːɹ'),               # board, hoard, roar (round 5)
    ('tz', 'ts'),                 # quartz, waltz, blitz (round 5)
    ('eer', 'ɪɹ'), ('ee', 'iː'), ('ea', 'iː'), ('oo', 'uː'), ('ou', 'aʊ'),
    ('ow', 'oʊ'), ('oi', 'ɔɪ'), ('oy', 'ɔɪ'), ('ay', 'eɪ'),
    ('air', 'ɛɹ'),
    ('ai', 'eɪ'), ('au', 'ɔː'), ('aw', 'ɔː'), ('ew', 'juː'),
    ('oa', 'oʊ'), ('ie', 'iː'), ('ei', 'eɪ'), ('ey', 'eɪ'),
    ('eu', 'uː'),
    ('ar', 'ɑːɹ'), ('er', 'ɚ'), ('ir', 'ɜː'), ('or', 'ɔːɹ'),
    ('ur', 'ɜː'),
    ('a', 'æ'), ('b', 'b'), ('c', 'k'), ('d', 'd'), ('e', 'ɛ'),
    ('f', 'f'), ('g', 'ɡ'), ('h', 'h'), ('i', 'ɪ'), ('j', 'dʒ'),
    ('k', 'k'), ('l', 'l'), ('m', 'm'), ('n', 'n'), ('o', 'ɑː'),
    ('p', 'p'), ('r', 'ɹ'), ('s', 's'), ('t', 't'), ('u', 'ʌ'),
    ('v', 'v'), ('w', 'w'), ('x', 'ks'), ('y', 'j'), ('z', 'z'),
]

# word-initial silent/greek onsets (applied only at position 0);
# gn/x are position-sensitive: gnome/xylophone vs signal/box
_PREFIX_RULES = [('ps', 's'), ('pn', 'n'), ('gh', 'ɡ'), ('mn', 'n'),
                 ('gn', 'n'), ('x', 'z')]

# word-initial spellings whose first syllable reduces (round 5,
# held-out-driven); checked after _PREFIX_RULES, before the main scan
_INITIAL_RULES = [
    # NOTE: spellings here must be in DEGEMINATED form (the scan runs
    # after doubled letters collapse): effect -> 'efect'
    ('emerg', 'ɪmɜːdʒ'), ('establ', 'ɪstæbl'), ('efect', 'ɪfɛkt'),
    ('equip', 'ɪkwɪp'), ('election', 'ɪlɛkʃən'), ('elect', 'ɪlɛkt'),
    ('agree', 'əɡɹiː'),
    ('descri', 'dɪskɹɪ'), ('iden', 'aɪdɛn'), ('resp', 'ɹɪsp'),
    ('exa', 'ɪɡzæ'), ('exp', 'ɪksp'),
    # round 5 (held-out2-driven): long-i onsets and reduced initials
    ('dia', 'daɪə'),   # diagram, diameter, dialect, diagonal
    ('vio', 'vaɪə'),   # violet, violin, violence, violate
    ('hy', 'haɪ'),     # hybrid, hydrant, hyphen, hypothesis
    ('enam', 'ɪnæm'),  # enamel, enamored
]

_PUNCT_KEEP = set('!\'(),.:;? -')

# final-sound classes for inflection voicing (by final IPA character)
_VOICELESS = set('ptkfθsʃ')
_SIBILANT_ENDS = ('s', 'z', 'ʃ', 'ʒ', 'tʃ', 'dʒ')


def _plural_suffix(stem_ipa: str) -> str:
    """-s / -es voicing: cats -> s, dogs -> z, boxes -> ᵻz.

    The epenthetic vowel is espeak's reduced ᵻ (its 'I2' phoneme,
    present in the reference symbol table utils/text/symbols.py:13
    precisely because espeak emits it), not full ɪ."""
    if stem_ipa.endswith(_SIBILANT_ENDS):
        return 'ᵻz'
    if stem_ipa and stem_ipa[-1] in _VOICELESS:
        return 's'
    return 'z'


def _past_suffix(stem_ipa: str) -> str:
    """-ed voicing: walked -> t, loved -> d, wanted -> ᵻd."""
    if stem_ipa.endswith(('t', 'd')):
        return 'ᵻd'
    if stem_ipa and stem_ipa[-1] in _VOICELESS:
        return 't'
    return 'd'


def _has_vowel(s: str) -> bool:
    return any(c in 'aeiouy' for c in s)


def _sib_e_stem(s: str) -> bool:
    """True when a stripped stem ending in single s/z spells an e-verb
    (nurse, noise, close, raise) rather than a geminate or Latinate
    ending (glass, focus, basis — where 'us'/'is' follows a
    consonant)."""
    if not s or s[-1] not in 'sz' or s.endswith(('ss', 'zz')):
        return False
    if s[-2:] in ('us', 'is') and (len(s) < 3 or s[-3] not in 'aeiou'):
        return False
    return True


# GA t-flapping (espeak-ng en-us emits ɾ; it is in the reference
# symbol inventory for exactly that reason, symbols.py:15). Applied as
# a post-pass over every word so lexicon entries, morphology composites
# and rule output share one convention. Without stress marks this is an
# approximation: t flaps between a vowel (or post-vocalic ɹ) and a weak
# vowel (ə ɚ ᵻ, reduced i/ɪ, word-final oʊ), except before ən
# (button/certain keep t, matching espeak) and before ɪʃ (petition).
_FLAP_PREV = set('iɪeɛæaɑɔoʊuʌɜəɚː')


def _flap(ipa: str) -> str:
    out = []
    n = len(ipa)
    for idx, ch in enumerate(ipa):
        if ch == 'T':           # lexicon no-flap marker: a t that
            out.append('t')     # heads a stressed syllable
            continue
        if ch != 't':
            out.append(ch)
            continue
        prev = ipa[idx - 1] if idx else ''
        prev2 = ipa[idx - 2] if idx > 1 else ''
        nxt = ipa[idx + 1] if idx + 1 < n else ''
        nxt2 = ipa[idx + 2] if idx + 2 < n else ''
        prev_ok = prev in _FLAP_PREV or \
            (prev == 'ɹ' and prev2 in _FLAP_PREV)
        # (word-final oʊ is NOT in the weak set: photo/potato flap via
        # their lexicon entries, but plateau/veto-class words carry
        # final stress and keep t)
        next_ok = ((nxt == 'ə' and nxt2 != 'n')
                   or nxt in ('ɚ', 'ᵻ')
                   or (nxt == 'i' and nxt2 != 'ː')
                   or (nxt == 'ɪ' and nxt2 != 'ʃ'
                       and prev != 'ɹ'))  # participant keeps rt+ɪ;
        #                                   quarter still flaps rt+ɚ
        out.append('ɾ' if prev_ok and next_ok else 't')
    return ''.join(out)


def _try_morphology(w: str, depth: int = 0):
    """Decompose inflections/derivations so stems reuse the lexicon and
    the magic-e logic: makes -> make+s, hated -> hate+ᵻd,
    making -> make+ɪŋ, cities -> city+z, kindness -> kind+nəs.

    Stems may themselves be morphologically complex one level deep
    (statements -> statement -> state+ment, weaknesses -> weakness ->
    weak+nəs): round-4 expanded-set eval showed the old single-level
    limit rule-scanned such stems raw (stætɛmɛnts)."""
    def stem(s: str) -> str:
        return _word_to_phonemes(s, depth=depth + 1)

    # closed compounds of two lexicon words: newspaper, classroom,
    # himself, understand (min lengths keep car+pet class false splits
    # out; first match wins, scanning left-to-right)
    if len(w) >= 8:
        for cut in range(3, len(w) - 3):
            a, b = w[:cut], w[cut:]
            if a in _LEXICON and b in _LEXICON:
                return _LEXICON[a] + _LEXICON[b]

    if w.endswith('ies') and len(w) > 4:
        return stem(w[:-3] + 'y') + 'z'
    if len(w) > 3 and (w.endswith('es') and w[-3] in 'sxz'
                       or w.endswith(('ches', 'shes'))):
        if w[:-1] in _LEXICON:  # sibilant stem keeps its e: browses
            return _LEXICON[w[:-1]] + 'ᵻz'
        if w[:-2] in _LEXICON:  # bare sibilant stem + es: buses,
            return _LEXICON[w[:-2]] + 'ᵻz'  # viruses, biases, lenses
        if w.endswith('uses') and len(w) > 5 and w[-5] not in 'aeiou':
            # OOV consonant+'us' nouns are the Latinate class that
            # appends -es (campuses, statuses, funguses); the common
            # C+'use' e-stems (fuses, excuses) live in the lexicon
            # and are caught above
            return stem(w[:-2]) + 'ᵻz'
        if w[-3] in 'sz' and len(w) > 4 and w[-4] in 'aeiourln':
            # vowel (or r/l/n) + s/z + es spells an e-stem: roses =
            # rose+s, nurses = nurse+s, responses = response+s
            # (vs boxes/glasses = cluster/geminate + es)
            return stem(w[:-1]) + 'ᵻz'
        return stem(w[:-2]) + 'ᵻz'
    if w.endswith(('us', 'is')) and len(w) > 4 and w[:-1] in _LEXICON:
        # u/i-final lexicon stems still pluralize: menus, taxis
        ipa = _LEXICON[w[:-1]]
        return ipa + _plural_suffix(ipa)
    if w.endswith('s') and not w.endswith(('ss', 'us', 'is')) \
            and len(w) > 3 and _has_vowel(w[:-1]):
        ipa = stem(w[:-1])
        return ipa + _plural_suffix(ipa)
    if w.endswith('ied') and len(w) > 4:
        return stem(w[:-3] + 'y') + 'd'   # studied -> study+d
    if w.endswith('ed') and len(w) >= 4 and _has_vowel(w[:-2]):
        # Stem policy (round-4 rewrite, driven by the expanded-set
        # eval): English orthography determines the stem in most
        # cases — 'ed' after a consonant CLUSTER or after a vowel
        # digraph can only be stem+ed (boxed, crawled, haired,
        # jumped), while single-consonant CVCe patterns are e-verbs
        # (hated, cared: car+ed would double to 'carred'). Soft-c/g,
        # syllabic-l and sibilant-e stems restore their 'e' exactly
        # like the -ing rule below.
        c3 = w[-3]
        c4 = w[-4] if len(w) >= 4 else ''
        c5 = w[-5] if len(w) >= 5 else ''
        cvce = (c3 not in 'aeiouxwy' and c4 in 'aeiou'
                and (c5 == '' or c5 not in 'aeiou'
                     or (c5 == 'u' and len(w) >= 6 and w[-6] == 'q')))
        s2, s1 = w[:-2], w[:-1]
        if len(w) > 5 and c3 == c4 and c3 not in 'aeiou':
            # doubled consonant: stopped -> stop; but geminate-spelled
            # stems keep both letters (glassed -> glass, added -> add)
            if w[:-3] in _LEXICON:
                ipa = _LEXICON[w[:-3]]
            elif s2 in _LEXICON:
                ipa = _LEXICON[s2]
            elif c3 in 'sz':
                ipa = stem(s2)          # glassed, buzzed
            else:
                ipa = stem(w[:-3])      # stopped, planned
        elif s1 in _LEXICON:
            ipa = _LEXICON[s1]          # cared -> care, eyed -> eye
        elif s2 in _LEXICON and not (cvce and len(s2) <= 3):
            # walked, visited; but short CVC stems (car/cut/hop) can't
            # take bare -ed without doubling -> fall to the e-verb
            ipa = _LEXICON[s2]
        elif w.endswith('eed'):
            ipa = stem(s1)              # freed -> free
        elif w.endswith('ued'):
            ipa = stem(s1)              # glued, argued, continued
        elif c3 in 'aouy':
            ipa = stem(s2)              # played, echoed
        elif s2.endswith(('c', 'dg', 'gu')) \
                or (s2[-1] == 'l' and len(s2) >= 2
                    and s2[-2] in 'bcdfgkpstvz') \
                or _sib_e_stem(s2):
            ipa = stem(s1)              # danced, judged, tabled, nursed
        elif s2.endswith('th') and len(s2) >= 5 \
                and s2[-3] in 'aeiou' and s2[-4] in 'aeiou':
            # vowel-digraph + 'the' verbs voice the fricative:
            # soothed/wreathed/mouthed are e-verbs (suːð+d), not
            # sooth+ed (suːθt); single-vowel members (writhe, tithe)
            # are pinned in the lexicon instead — orthography can't
            # separate them from froth-class voiceless stems
            ipa = stem(s1)
        elif not cvce:
            ipa = stem(s2)              # boxed, crawled, haired
        else:
            # CVC + ed, stem unknown: magic-e stems (hated/named)
            # outnumber visit-class polysyllables at this fallback
            ipa = stem(s1)
        return ipa + _past_suffix(ipa)
    if w.endswith('ing') and len(w) >= 5 and _has_vowel(w[:-3]):
        s = w[:-3]
        # short-CVC lexicon stems can't take bare -ing without
        # doubling (cutting/carring) — 'cuting'/'caring' are e-verbs
        cvc_short = (len(s) <= 3 and s[-1] not in 'aeiouxwy'
                     and len(s) >= 2 and s[-2] in 'aeiou')
        if s in _LEXICON and not cvc_short:
            return _LEXICON[s] + 'ɪŋ'
        if s + 'e' in _LEXICON:
            return _LEXICON[s + 'e'] + 'ɪŋ'
        if len(s) > 2 and s[-1] == s[-2] and s[:-1] in _LEXICON \
                and s[-1] not in 'sz':
            return _LEXICON[s[:-1]] + 'ɪŋ'  # running -> run
        if len(s) > 2 and s[-1] == s[-2] and s[-1] not in 'aeiousz':
            return stem(s[:-1]) + 'ɪŋ'      # nodding -> nod (rules)
        if len(s) > 2 and s[-1] == s[-2] and s[-1] in 'sz':
            return stem(s) + 'ɪŋ'           # glassing, buzzing:
        #                                     geminate spelling stays
        # e-restoration classes (round-4 expanded-set eval): soft c/g
        # stems (dancing -> dance, judging -> judge, colleaguing ->
        # colleague) and syllabic-l stems (candling -> candle,
        # bottling -> bottle) drop a real 'e' that changes the sound
        if s.endswith(('c', 'dg', 'gu')):
            return stem(s + 'e') + 'ɪŋ'
        if s[-1] == 'l' and len(s) >= 2 and s[-2] in 'bcdfgkpstvz':
            return stem(s + 'e') + 'ɪŋ'     # candle-class syllabic l
        if _sib_e_stem(s):
            return stem(s + 'e') + 'ɪŋ'     # nursing, raising, closing
        if s.endswith('th') and len(s) >= 5 \
                and s[-3] in 'aeiou' and s[-4] in 'aeiou':
            return stem(s + 'e') + 'ɪŋ'     # soothing, teething,
        #                                     mouthing (see -ed rule)
        if s[-1] == 'u':
            return stem(s + 'e') + 'ɪŋ'     # gluing, arguing
        if len(s) >= 3 and s[-1] not in 'aeioux' and s[-2] in 'aeiou' \
                and s[-3] not in 'aeiou':
            return stem(s + 'e') + 'ɪŋ'  # open syllable: making
        #                                  (x excluded: boxing, mixing)
        return stem(s) + 'ɪŋ'
    # comparative/agentive -er over known stems: smaller, bigger,
    # later, happier (unknown stems fall through to the rule scan,
    # where final 'er' maps to ɚ anyway)
    if w.endswith('ier') and len(w) > 4:
        ipa = stem(w[:-3] + 'y')
        if ipa.endswith('i'):
            return ipa + 'ɚ'              # happier -> hæpiɚ
    if w.endswith('er') and len(w) > 4:
        s = w[:-2]
        # false decompositions: shoulder is not should+er
        if s in ('should', 'would', 'could'):
            s = ''
        if s in _LEXICON:
            return _LEXICON[s] + 'ɚ'      # smaller -> small+ɚ
        if s + 'e' in _LEXICON:
            return _LEXICON[s + 'e'] + 'ɚ'  # later -> late+ɚ
        if len(s) > 2 and s[-1] == s[-2] and s[:-1] in _LEXICON:
            return _LEXICON[s[:-1]] + 'ɚ'   # bigger -> big+ɚ
    if w.endswith('ically') and len(w) > 7:
        # magically = magic + ally with a reduced 'a' (espeak: əli)
        return stem(w[:-4]) + 'əli'
    for suf, ipa_suf in [('ness', 'nəs'), ('ment', 'mənt'),
                         ('ful', 'fəl'), ('less', 'ləs'), ('ly', 'li'),
                         ('est', 'ɪst')]:
        if w.endswith(suf) and len(w) > len(suf) + 2:
            s = w[:-len(suf)]
            if suf == 'ment' and s.endswith('u'):
                continue  # argument/instrument: the 'ument' rule
                #           handles the u (juː vs ɹə), not morphology
            ipa = stem(s)
            if ipa and ipa[-1] == ipa_suf[0] and ipa_suf[0] in 'lnm':
                ipa = ipa[:-1]  # fully -> fʌli, not fʌlli
            if s.endswith('i') and ipa.endswith('ɪ'):
                ipa = ipa[:-1] + 'i'  # happiness: y->i stem stays i
            return ipa + ipa_suf
    return None


def _word_to_phonemes(word: str, depth: int = 0) -> str:
    lower = word.lower()
    if lower in _LEXICON:
        return _LEXICON[lower]
    if depth < 2:
        morph = _try_morphology(lower, depth)
        if morph is not None:
            return morph
    out = []
    # degeminate doubled consonants (letter -> one sound); 'cc' stays
    # (accent: first c hard, second soft -> ks)
    # (negative lookahead: keep 'ss' before 'ion' so the 'ssion'
    # suffix branch below can see it — mission/passion are voiceless)
    w = re.sub(r'([bdfghjklmnprstvwz])\1(?!ion)', r'\1', lower)
    suffix = ''
    magic_e = False
    # word-final patterns, handled before the main rule scan:
    # consonant + 'le' -> syllabic l (particle); 'ce'/'ge' -> soft
    # consonant with silent e (sentence, page); other consonant + 'e'
    # -> silent e, possibly magic (made -> meɪd, name -> neɪm)
    magic_pos = -10
    if len(w) >= 6 and w.endswith('ssion'):
        suffix, w = 'ʃən', w[:-5]      # mission, passion (before the
        #                                ss degemination turns it into
        #                                the voiced 'sion' rule)
    elif len(w) >= 4 and w.endswith('alm'):
        suffix, w = 'ɑːm', w[:-3]      # psalm, balm, (calm/palm in lex)
    elif len(w) >= 4 and w.endswith('gue'):
        suffix, w = 'ɡ', w[:-3]        # league, tongue, vague
    elif len(w) >= 4 and w.endswith('que'):
        suffix, w = 'k', w[:-3]        # unique, antique, technique
    elif len(w) >= 3 and w.endswith('ue'):
        # blue/true/clue -> uː (yod dropped after coronals/liquids);
        # cue/hue/argue -> juː
        suffix = 'uː' if w[-3] in 'lrtdsnz' else 'juː'
        w = w[:-2]
    elif len(w) >= 4 and w.endswith('dge'):
        suffix, w = 'dʒ', w[:-3]       # judge, bridge, edge, badge
    elif len(w) >= 4 and w.endswith('ose') and len(w) <= 5:
        suffix, w = 'oʊz', w[:-3]      # nose, rose, those, chose
    elif len(w) >= 5 and w.endswith('eese'):
        suffix, w = 'iːz', w[:-4]      # cheese (geese is lexicon)
    elif len(w) >= 5 and w.endswith('oise'):
        suffix, w = 'ɔɪz', w[:-4]      # noise
    elif len(w) >= 5 and w.endswith('umn'):
        suffix, w = 'əm', w[:-3]       # autumn, column (reduced)
    elif len(w) >= 3 and w.endswith('mn'):
        suffix, w = 'm', w[:-2]        # damn, hymn (hymn in lexicon)
    elif len(w) >= 3 and w.endswith('mb'):
        suffix, w = 'm', w[:-2]        # lamb, comb; mid-word mb stays
    elif len(w) >= 4 and w.endswith('ign'):
        suffix, w = 'aɪn', w[:-3]      # sign, align, assign, resign
    elif len(w) >= 5 and w.endswith('ften'):
        suffix, w = 'fən', w[:-4]      # soften, often
    elif len(w) >= 5 and w.endswith('sten'):
        suffix, w = 'sən', w[:-4]      # fasten, hasten, moisten
    elif len(w) >= 9 and w.endswith('erature'):
        suffix, w = 'ɚɹətʃɚ', w[:-7]   # literature, temperature
    elif len(w) >= 6 and w.endswith('ture'):
        # nature -> neɪtʃɚ, future -> fjuːtʃɚ; the long vowel only
        # holds for short stems (temperature/literature reduce toward
        # a lax vowel, so no magic-e there)
        suffix, w = 'tʃɚ', w[:-4]
        magic_e = 0 < len(w) <= 4 and w[-1] in 'aeiou'
        magic_pos = len(w) - 1
    elif len(w) >= 4 and w.endswith('the'):
        # final -the voices and lengthens: bathe -> beɪð,
        # breathe -> bɹiːð, clothe -> kloʊð
        suffix, w = 'ð', w[:-3]
        magic_e = len(w) > 0 and w[-1] in 'aeiou'
        magic_pos = len(w) - 1
    elif len(w) >= 4 and w.endswith('ong'):
        suffix, w = 'ɔːŋ', w[:-3]  # long, song, strong, belong
        #                            (among/mongrel-type ʌ via lexicon)
    elif len(w) >= 5 and w.endswith('age') and _has_vowel(w[:-3]):
        suffix, w = 'ɪdʒ', w[:-3]  # village, message (stage/page keep
        #                            the magic-e path: stem has no vowel)
    elif len(w) >= 7 and w.endswith('gious'):
        suffix, w = 'dʒəs', w[:-5]     # religious, prestigious
    elif len(w) >= 7 and w.endswith('cious'):
        suffix, w = 'ʃəs', w[:-5]      # delicious, precious
    elif len(w) >= 7 and w.endswith('tious'):
        suffix, w = 'ʃəs', w[:-5]      # ambitious, cautious
    elif len(w) >= 7 and w.endswith('xious'):
        suffix, w = 'kʃəs', w[:-5]     # anxious
    elif len(w) >= 5 and w.endswith('ous'):
        # short SINGLE-consonant open stem (checked on the original
        # spelling, degemination hides doubling): vowel is long
        # (famous -> feɪməs); closed stems keep their lax vowel
        single_c = len(lower) >= 6 and lower[-4] not in 'aeiou' \
            and lower[-5] in 'aeiou'
        suffix, w = 'əs', w[:-3]
        magic_e = single_c and len(w) <= 4
        magic_pos = len(w) - 2
    elif len(w) >= 5 and w.endswith('ive') and _has_vowel(w[:-3]) \
            and w[-4] not in 'rv':
        # active/native/massive (reduced ɪv); drive/arrive/survive
        # keep magic-e (no stem vowel, or r/v stem end). Single-
        # consonant short stems lengthen: native -> neɪɾɪv
        single_c = len(lower) >= 6 and lower[-4] not in 'aeiou' \
            and lower[-5] in 'aeiou'
        suffix, w = 'ɪv', w[:-3]
        magic_e = single_c and len(w) <= 4
        magic_pos = len(w) - 2
    elif len(w) >= 4 and w.endswith('are'):
        suffix, w = 'ɛɹ', w[:-3]   # care, share, compare (square in
        #                            lexicon: qu-cluster)
    elif len(w) >= 4 and w.endswith('ire'):
        suffix, w = 'aɪɚ', w[:-3]  # fire, wire, desire, require
    elif len(w) >= 4 and w.endswith('our'):
        suffix, w = 'aʊɚ', w[:-3]  # flour, sour (four/your/tour/pour
        #                            are lexicon entries)
    # round 5 (held-out-driven) final-anchored reductions: these must
    # be endswith-checks, not scan rules — the pattern is only
    # unstressed at the word END (docs/g2p.md error classes)
    elif len(w) >= 10 and w.endswith('omparison'):
        suffix, w = 'əmpɛɹɪsən', w[:-9]  # comparison
    elif len(w) >= 8 and w.endswith('enance'):
        suffix, w = 'ənəns', w[:-6]    # maintenance
    elif len(w) >= 8 and w.endswith('erence'):
        suffix, w = 'ɹəns', w[:-6]     # reference, conference (the
        #                                middle vowel elides in GA)
    elif len(w) >= 10 and w.endswith('umstance'):
        suffix, w = 'əmstæns', w[:-8]  # circumstance
    elif len(w) >= 9 and w.endswith('sequence'):
        suffix, w = 'sɪkwəns', w[:-8]  # consequence (sequence itself
        #                                stays siː via length)
    elif len(w) >= 8 and w.endswith('cipline'):
        suffix, w = 'sɪplɪn', w[:-7]   # discipline (dɪs+sɪplɪn
        #                                degeminates at the IPA level)
    elif len(w) >= 8 and w.endswith('gence'):
        suffix, w = 'dʒəns', w[:-5]    # intelligence, diligence
    elif len(w) >= 8 and w.endswith('gency'):
        suffix, w = 'dʒənsi', w[:-5]   # urgency-family
    elif len(w) >= 7 and w.endswith('tience'):
        suffix, w = 'ʃəns', w[:-6]     # patience
    elif len(w) >= 7 and w.endswith('dience'):
        suffix, w = 'diəns', w[:-6]    # audience, obedience
    elif len(w) >= 7 and w.endswith('rience'):
        suffix, w = 'ɹiəns', w[:-6]    # experience
    elif len(w) >= 6 and w.endswith('ence'):
        suffix, w = 'əns', w[:-4]      # sentence, absence (reduced;
        #                                fence/pence stay ɛns via len)
    elif len(w) >= 9 and w.endswith('icipant'):
        suffix, w = 'ɪsɪpənt', w[:-7]  # participant
    elif len(w) >= 7 and w.endswith('icant'):
        suffix, w = 'ɪkənt', w[:-5]    # significant, applicant
    elif len(w) >= 7 and w.endswith('ance'):
        suffix, w = 'əns', w[:-4]      # substance, performance
        #                                (advance/romance are lexicon)
    elif len(w) >= 6 and w.endswith('oison'):
        suffix, w = 'ɔɪzən', w[:-5]    # poison
    elif len(w) >= 6 and w.endswith('ison'):
        suffix, w = 'ɪzən', w[:-4]     # prison (voiced s)
    elif len(w) >= 7 and w.endswith('iority'):
        suffix, w = 'aɪɔːɹɪɾi', w[:-6]  # priority, superiority
    elif len(w) >= 8 and w.endswith('ajority'):
        suffix, w = 'ədʒɔːɹɪɾi', w[:-7]  # majority
    elif len(w) >= 6 and w.endswith('ory'):
        suffix, w = 'ɚɹi', w[:-3]      # victory, history, memory
        #                                (laboratory/theory in lexicon)
    elif len(w) >= 6 and w.endswith('ism'):
        suffix, w = 'ɪzəm', w[:-3]     # organism, criticism
    elif len(w) >= 7 and w.endswith('egy'):
        suffix, w = 'ədʒi', w[:-3]     # strategy
    elif len(w) >= 6 and w.endswith('ey') and w[-3] not in 'aeiou':
        suffix, w = 'i', w[:-2]        # chimney, valley, turkey
        #                                (survey/obey/convey in lexicon)
    elif lower.endswith('oss') and len(lower) >= 4:
        suffix, w = 'ɔːs', w[:-2]      # moss, cross, boss (w is
        #                                degeminated: strip 'os')
    elif len(w) >= 5 and w.endswith('rot'):
        suffix, w = 'ɹət', w[:-3]      # carrot, parrot (degeminated)
    elif len(w) >= 5 and w.endswith('od') and w[-3] not in 'aeiouy':
        suffix, w = 'əd', w[:-2]       # method (period excluded by
        #                                the vowel guard)
    elif len(w) >= 5 and w.endswith('el') and w[-3] not in 'aeiou':
        suffix, w = 'əl', w[:-2]       # tunnel, travel, level
        #                                (hotel/barrel are lexicon)
    elif len(w) >= 5 and w.endswith('gon') \
            and len(re.findall('[aeiouy]+', w)) >= 3:
        suffix, w = 'ɡɑːn', w[:-3]     # polygon, octagon, pentagon
        #                                keep the Greek full vowel;
        #                                dragon/wagon reduce below
    elif len(w) >= 5 and w.endswith('on') and w[-3] not in 'aeiouyr' \
            and _has_vowel(w[:-2]):
        suffix, w = 'ən', w[:-2]       # ribbon, cotton, wagon, person
        #                                (-ron keeps ɑːn: neutron)
    elif len(w) >= 5 and w.endswith('en') and w[-3] not in 'aeiouy':
        suffix, w = 'ən', w[:-2]   # garden, kitchen, happen (reduced);
        #                            ten/men/when stay ɛn (short words)
    elif len(w) >= 6 and w.endswith('et') and w[-3] not in 'aeiouy':
        suffix, w = 'ɪt', w[:-2]   # jacket, market, planet (reduced)
    # round 5 (held-out2-driven, docs/g2p.md) general end-anchored
    # reductions — each covers a CLASS, none a single word:
    elif len(w) >= 3 and w.endswith('o') and w[-2] not in 'aeiou' \
            and _has_vowel(w[:-1]):
        suffix, w = 'oʊ', w[:-1]   # cargo, buffalo, volcano, silo —
        #                            word-final o is oʊ, never ɑː
        #                            (vowel guard keeps oo -> uː)
    elif len(w) >= 6 and w.endswith('ian') \
            and not w.endswith(('cian', 'tian', 'sian', 'gian')):
        suffix, w = 'iən', w[:-3]  # amphibian, guardian, civilian
        #                            (musician-type -Cian stays the
        #                            ʃən long rule)
    elif len(w) >= 5 and w.endswith('ius'):
        suffix, w = 'iəs', w[:-3]  # radius, genius, papyrus-class is
        #                            the 'us' branch below
    elif len(w) >= 5 and w.endswith('us') and w[-3] not in 'aeiou' \
            and _has_vowel(w[:-2]):
        suffix, w = 'əs', w[:-2]   # cactus, focus, bonus, surplus
        #                            (unstressed final -us reduces)
    elif len(w) >= 5 and w.endswith('em') and w[-3] not in 'aeiou' \
            and _has_vowel(w[:-2]):
        suffix, w = 'əm', w[:-2]   # emblem, system, problem, anthem
    elif len(w) >= 7 and w.endswith('ent') and w[-4] not in 'aeiou' \
            and not w.endswith('ment') \
            and len(re.findall('[aeiouy]+', w)) >= 3:
        suffix, w = 'ənt', w[:-3]  # eminent, president, excellent —
        #                            3+ syllables reduce; 2-syllable
        #                            event/prevent keep ɛnt (-ment has
        #                            its own scan rules: ument/rument)
    elif len(w) >= 5 and w.endswith('al') and w[-3] not in 'aeiou' \
            and _has_vowel(w[:-2]):
        suffix, w = 'əl', w[:-2]   # cardinal, jackal, arsenal, metal
        #                            (unstressed final -al reduces)
    elif len(w) >= 5 and w.endswith('um') and w[-3] not in 'aeiou' \
            and _has_vowel(w[:-2]):
        suffix, w = 'əm', w[:-2]   # spectrum, vellum, asylum, album
    elif len(w) >= 5 and w.endswith('an') and w[-3] not in 'aeiouy' \
            and _has_vowel(w[:-2]):
        suffix, w = 'ən', w[:-2]   # sultan, organ, slogan, urban
    elif len(w) >= 6 and w.endswith('icle'):
        suffix, w = 'ɪkəl', w[:-4]  # article, particle, icicle
    elif len(w) >= 6 and w.endswith('acle'):
        suffix, w = 'əkəl', w[:-4]  # pinnacle, obstacle, miracle
    elif len(w) >= 6 and w.endswith('etry'):
        suffix, w = 'ətɹi', w[:-4]  # symmetry, geometry, poetry
    elif len(w) >= 5 and w.endswith('stle'):
        suffix, w = 'səl', w[:-4]  # pestle, whistle, thistle (silent t)
    elif len(w) >= 5 and w.endswith('uice'):
        suffix, w = 'uːs', w[:-4]  # sluice, juice (must pre-empt the
        #                            'ce' soft-c strip)
    elif len(w) >= 6 and w.endswith('easel'):
        suffix, w = 'iːzəl', w[:-5]  # easel, weasel (voiced s)
    elif len(w) >= 5 and w.endswith('msy'):
        suffix, w = 'mzi', w[:-3]  # flimsy, clumsy, whimsy (voiced s)
    elif len(w) >= 5 and w.endswith('ee') and w[-3] not in 'aeioury' \
            and _has_vowel(w[:-2]):
        suffix, w = 'i', w[:-2]    # coffee, levee, committee (final
        #                            unstressed -ee; degree/agree-type
        #                            r-stems keep stressed iː)
    elif len(w) >= 6 and w.endswith('sphere'):
        suffix, w = 'sfɪɹ', w[:-6]  # sphere, hemisphere, atmosphere
        #                             (must pre-empt the silent-e strip
        #                             or the scan never sees 'phere')
    elif len(w) >= 5 and lower.endswith('ette') and w.endswith('ete'):
        # degemination has already collapsed tt (palette -> palete),
        # so match the ORIGINAL spelling but strip the collapsed form
        suffix, w = 'ɛt', w[:-3]   # cassette, gazette, palette
    elif len(w) >= 6 and w.endswith('iot'):
        suffix, w = 'iət', w[:-3]  # patriot, idiot, chariot
        #                            (riot/monosyllabic keep aɪ: len)
    elif len(w) >= 6 and w.endswith('ern') and w[-4] not in 'aeiou' \
            and _has_vowel(w[:-3]):
        suffix, w = 'ɚn', w[:-3]   # tavern, pattern, lantern, cavern
    elif len(w) >= 5 and w.endswith('ie') and w[-3] not in 'aeiou' \
            and _has_vowel(w[:-2]):
        suffix, w = 'i', w[:-2]    # prairie, movie, cookie (final
        #                            unstressed -ie; die/pie keep aɪ)
    elif len(w) >= 4 and w.endswith('ew') and w[-3] in 'tdsnlrz':
        suffix, w = 'uː', w[:-2]   # stew, mildew, crew — yod drops
        #                            after coronals; few/view keep juː
    elif len(w) >= 3 and w.endswith('le') and w[-3] not in 'aeiou':
        suffix, w = 'əl', w[:-2]
        if w.endswith('ng'):
            suffix = 'ɡəl'         # single/jungle/angle keep the ɡ
        # single consonant between vowel and -le (in the ORIGINAL
        # spelling — degemination hides doubling): the vowel is long
        # (title -> taɪɾəl, noble, cycle); little/bottle stay lax
        elif len(lower) >= 5 and lower[-3] not in 'aeiouy' \
                and lower[-4] in 'aeiouy' and len(w) >= 2:
            magic_e = True
            magic_pos = len(w) - 2
    elif len(w) >= 3 and w.endswith('ce'):
        suffix, w = 's', w[:-2]
        magic_e = len(w) > 0 and w[-1] in 'aeiou'
        magic_pos = len(w) - 1
    elif len(w) >= 3 and w.endswith('ge'):
        suffix, w = 'dʒ', w[:-2]
        magic_e = len(w) > 0 and w[-1] in 'aeiou'
        magic_pos = len(w) - 1
    elif len(w) >= 3 and w.endswith('e') and w[-2] not in 'aeiou':
        magic_e = w[-3] in 'aeiou'
        magic_pos = len(w) - 3
        w = w[:-1]
    magic_map = {'a': 'eɪ', 'i': 'aɪ', 'o': 'oʊ', 'u': 'juː', 'e': 'iː'}
    i = 0
    while i < len(w):
        if i == 0:
            matched = False
            for pattern, ipa in _PREFIX_RULES + _INITIAL_RULES:
                if w.startswith(pattern):
                    out.append(ipa)
                    i += len(pattern)
                    matched = True
                    break
            if matched:
                continue
        # long rules (>= 4 letters) outrank the context heuristics
        # below: an 'eration' suffix must win over the e+r+vowel rule,
        # 'gious' over soft-g, 'cian' over soft-c
        long_matched = False
        for pattern, ipa in _RULES:
            if len(pattern) >= 4 and w.startswith(pattern, i):
                out.append(ipa)
                i += len(pattern)
                long_matched = True
                break
        if long_matched:
            continue
        # 'war' not followed by e -> wɔːɹ (warm, ward, swarm;
        # aware/software keep the magic-e path)
        if w.startswith('war', i) and \
                (i + 3 >= len(w) or w[i + 3] != 'e'):
            out.append('wɔːɹ')
            i += 3
            continue
        # 'wan' -> wAAn (wand, want, wander); wane/wany keep magic-e
        if w.startswith('wan', i) \
                and not (magic_e and i + 1 == magic_pos):
            out.append('wɑːn')
            i += 3
            continue
        # 'wal' + consonant -> wOOl (walnut, walrus; swallow-type
        # wal+vowel stays)
        if w.startswith('wal', i) and i + 3 < len(w) \
                and w[i + 3] not in 'aeiouy':
            out.append('wɔːl')
            i += 3
            continue
        # 'ng' before a back vowel keeps the g: flamingo, bungalow,
        # mango, kangaroo (the bare 'ng' digraph rule would swallow
        # it); 'ng'+e/i stays soft or plain ŋ (danger via soft-g,
        # singer via morphology)
        if w.startswith('ng', i) and i + 2 < len(w) \
                and w[i + 2] in 'aou':
            out.append('ŋɡ')
            i += 2
            continue
        # 'ear' + consonant -> ɜː (search, learn, pearl); 'ear' at
        # word end or + vowel stays iːɹ-ish via the digraph rules
        if w.startswith('ear', i) and i + 3 < len(w) \
                and w[i + 3] not in 'aeiouy':
            out.append('ɜː')
            i += 3
            continue
        # 'wor' + consonant -> wɜː (worship, worth, worse, worst)
        if w.startswith('wor', i) and i + 3 < len(w) \
                and w[i + 3] not in 'aeiouy':
            out.append('wɜː')
            i += 3
            continue
        # 's' + 'u' + vowel -> ʒu (casual, visual, usual-family)
        if w[i] == 's' and i + 2 < len(w) and w[i + 1] == 'u' \
                and w[i + 2] in 'aeio' and i > 0:
            out.append('ʒu')
            i += 2
            continue
        # 'gu' + vowel -> hard g, silent u (guard, guest, guide, guild)
        if w.startswith('gu', i) and i + 2 < len(w) \
                and w[i + 2] in 'aeiy':
            out.append('ɡ')
            i += 2
            continue
        # soft c / soft g before e,i,y ('sc' -> single s)
        if w[i] == 'c' and i + 1 < len(w) and w[i + 1] in 'eiy':
            if not (out and out[-1].endswith('s')):
                out.append('s')
            i += 1
            continue
        if w[i] == 'g' and i + 1 < len(w) and w[i + 1] in 'eiy' \
                and w[i:i + 2] != 'ge':
            out.append('dʒ')
            i += 1
            continue
        if w[i] == 'y' and (i == len(w) - 1 or w[i + 1] not in 'aeiou'):
            if magic_e and i == magic_pos:
                out.append('aɪ')       # cycle -> saɪkəl
            elif i == len(w) - 1:
                # monosyllables stress the final y: fly/sky/try -> aɪ;
                # polysyllables reduce it: happy/city -> i
                out.append('i' if _has_vowel(w[:i]) else 'aɪ')
            else:
                out.append('ɪ')
            i += 1
            continue
        # nasal assimilation: n before a velar -> ŋ (uncle, bank,
        # anxious); 'ng' itself is a digraph rule
        if w[i] == 'n' and i + 1 < len(w) and (
                w[i + 1] in 'kqx'
                or (w[i + 1] == 'c'
                    and (i + 2 >= len(w)
                         or w[i + 2] not in 'eiyh'))):  # nch is ntʃ
        #            (lunch, bench, branch); anchor-type hard-ch words
        #            go through the lexicon
            out.append('ŋ')
            i += 1
            continue
        # unstressed re-/de-/se- prefix before an open syllable -> ɹɪ/
        # dɪ/sɪ (reduction, decision, security); closed first syllables
        # keep the full vowel (desk, rescue), and -ation/-ition/-ution
        # words carry secondary stress on the prefix (reputation ->
        # ɹɛp-, definition -> dɛf-), so those are excluded
        if i == 0 and len(lower) >= 5 and len(w) >= 4 \
                and w[0] in 'rds' and w[1] == 'e' \
                and w[2] not in 'aeiouy' \
                and (w[3] in 'aeiouy'
                     or (len(w) >= 5 and w[3] in 'lr'
                         and w[4] in 'aeiouy')) \
                and not w.endswith(('ation', 'ition', 'ution')):
            out.append({'r': 'ɹɪ', 'd': 'dɪ', 's': 'sɪ'}[w[0]])
            i = 2
            continue
        # unstressed per- (permission, performance); the person-family
        # ('pers' + vowel) keeps stressed pɜː via the er rule below
        # (length guards use the ORIGINAL word: the suffix branches
        # above may already have shortened w)
        if i == 0 and w.startswith('per') and len(lower) >= 6 \
                and w[3:4] not in list('aeiouy') \
                and not (w[3:4] == 's' and w[4:5] in 'aeiouy'):
            out.append('pɚ')
            i = 3
            continue
        # unstressed pro- in long derivations (professor, protection);
        # short pro- words carry initial stress (problem, product) and
        # the 8-letter tier is mixed (progress/property -> lexicon)
        if i == 0 and w.startswith('pro') and len(lower) >= 9 \
                and w[3:4] not in list('aeiouy'):
            out.append('pɹə')
            i = 3
            continue
        # word-final unstressed 'a' -> ə (umbrella, sofa, extra)
        if w[i] == 'a' and i == len(w) - 1 and _has_vowel(w[:i]):
            out.append('ə')
            i += 1
            continue
        # r-colored vowels in context: before a vowel the r starts the
        # next syllable (mirror -> mɪɹɚ, marry -> mæɹi, jury -> dʒʊɹi);
        # a FINAL unstressed -or/-ar reduces to ɚ (actor, dollar —
        # guitar/cigar/radar are lexicon entries)
        if w[i] in 'aeiu' and i + 1 < len(w) and w[i + 1] == 'r' \
                and not (magic_e and i == magic_pos):
            nxt = w[i + 2] if i + 2 < len(w) else ''
            if nxt and nxt in 'aeiouy':
                out.append({'a': 'æɹ', 'e': 'ɛɹ', 'i': 'ɪɹ',
                            'u': 'ʊɹ'}[w[i]])
                i += 2
                continue
            if nxt == '' and w[i] in 'ao' and lower.endswith(('or',
                                                              'ar')) \
                    and _has_vowel(w[:i]):
                out.append('ɚ')
                i += 2
                continue
            if w[i] == 'e' and nxt != '':
                out.append('ɜː')       # mid-word er + consonant:
                i += 2                 # nervous, person
                continue
        if w[i] == 'o' and i + 1 < len(w) and w[i + 1] == 'r' \
                and i + 2 >= len(w) and lower.endswith('or') \
                and _has_vowel(w[:i]):
            out.append('ɚ')            # final unstressed -or: actor
            i += 2
            continue
        for pattern, ipa in _RULES:
            if w.startswith(pattern, i):
                if magic_e and len(pattern) == 1 and pattern in magic_map \
                        and i == magic_pos:
                    sound = magic_map[pattern]
                    # GA yod-dropping for magic u (round 5): uː after
                    # coronals (tune, costume, assume) and after
                    # cluster-l (flute, spruce via r); plain l after a
                    # vowel keeps juː (value, volume), as do labials/
                    # velars (cute, mute, fume)
                    if pattern == 'u' and i > 0 and (
                            w[i - 1] in 'rtdnszj'
                            or (w[i - 1] == 'l' and i > 1
                                and w[i - 2] not in 'aeiouy')):
                        sound = 'uː'
                    out.append(sound)
                else:
                    out.append(ipa)
                i += len(pattern)
                break
        else:
            i += 1  # unknown character: drop
    out.append(suffix)
    # IPA-level degemination: adjacent identical consonants merge into
    # one sound (occupation: hard c + hard c -> single k; discipline:
    # dɪs + sɪplɪn -> dɪsɪplɪn), matching espeak's single-phone output
    return re.sub(r'([bdfɡhjklmnpstvzɹʃʒθðŋw])\1', r'\1', ''.join(out))


def rule_based_g2p(text: str) -> str:
    pieces = re.split(r"([a-zA-Z']+)", text)
    out = []
    for piece in pieces:
        if not piece:
            continue
        if re.fullmatch(r"[a-zA-Z']+", piece):
            out.append(_flap(_word_to_phonemes(piece.replace("'", ''))))
        else:
            out.append(''.join(ch for ch in piece
                               if ch in _PUNCT_KEEP or ch == ' '))
    return ''.join(out)
