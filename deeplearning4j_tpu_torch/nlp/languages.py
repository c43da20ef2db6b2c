"""Japanese/Korean tokenizer factories + stopwords + moving window.

Reference: deeplearning4j-nlp-japanese (a bundled kuromoji fork, 6.9k LoC) and
deeplearning4j-nlp-korean (SURVEY.md §2.5), plus StopWords and the
moving-window iterator in deeplearning4j-nlp text/.

The reference ships dictionary-based morphological analyzers. Japanese here
uses the same lattice-Viterbi architecture as kuromoji (lexicon edges +
character-class unknown-word edges, minimum-cost path) with an embedded
closed-class mini-lexicon instead of the 6.9k-LoC IPADIC fork this image
can't carry; Korean is hangul-run segmentation with josa stripping. The
TokenizerFactory seam is identical, so a full-dictionary implementation can
replace them without touching callers.

Counterpart of ``deeplearning4j_tpu/nlp/languages.py``: host code, the same
in the port (the port keeps its own copy; it imports nothing of the JAX
package).
"""
from __future__ import annotations

import re
from typing import Iterator, List, Sequence

from .tokenization import Tokenizer, TokenizerFactory

# Common English stopwords (reference stopwords resource file)
STOP_WORDS = frozenset("""a an and are as at be but by for if in into is it no
not of on or such that the their then there these they this to was will with
he she his her him i me my we our you your had has have were been being do
does did so than too very can could should would may might must shall
""".split())


class StopWords:
    """Reference org.deeplearning4j.text.stopwords.StopWords."""

    @staticmethod
    def get_stop_words() -> List[str]:
        return sorted(STOP_WORDS)

    @staticmethod
    def is_stop_word(w: str) -> bool:
        return w.lower() in STOP_WORDS


# --------------------------------------------------------------------- Japanese
# Kuromoji-architecture lattice segmenter: Viterbi over (embedded-lexicon
# edges + character-class unknown-word edges), per-edge word costs plus a
# connection penalty. The reference vendors a 6.9k-LoC kuromoji fork whose
# quality comes from the full IPADIC dictionary; this image ships no such
# dictionary, so the embedded lexicon covers (a) closed-class morphemes —
# particles, copulas, auxiliaries, demonstratives, frequent adverbs — and
# (b) generated conjugation paradigms (~1000 surface forms from ~100
# high-frequency verb/adjective stems via the standard godan/ichidan/
# i-adjective rules below). Coverage gap vs IPADIC, stated precisely:
# IPADIC carries ~300k open-class entries (nouns, names, rare verbs) with
# per-pair connection costs and POS tags; here open-class words fall to
# script-run unknown edges (whole kanji/katakana runs kept intact), no POS
# is emitted, and compound kanji runs without a lexicon boundary are not
# split (e.g. 毎日日本語 stays one run). Same algorithm, miniature
# dictionary; the TokenizerFactory seam is unchanged, so a full-dictionary
# build can drop in without touching callers.

_JA_LEXICON = {
    # case/topic particles (lowest cost: always split off)
    "は": 100, "が": 100, "を": 100, "に": 100, "で": 100, "と": 100,
    "の": 100, "へ": 110, "も": 110, "や": 120, "か": 130, "ね": 140,
    "よ": 140, "な": 150, "から": 115, "まで": 115, "より": 125,
    "ので": 125, "のに": 130, "には": 120, "では": 120, "とは": 125,
    "でも": 125, "だけ": 125, "など": 125, "について": 130,
    # copulas / auxiliaries / light verbs
    "です": 140, "だ": 160, "である": 150, "でした": 150, "ます": 140,
    "ました": 145, "ません": 145, "する": 170, "した": 170, "して": 170,
    "します": 160, "いる": 175, "いた": 180, "いて": 180, "ある": 175,
    "あった": 180, "ない": 170, "なかった": 180, "なる": 180, "なった": 185,
    "れる": 185, "られる": 185, "せる": 190, "たい": 185, "という": 150,
    # frequent function nouns / demonstratives
    "こと": 180, "もの": 190, "ため": 185, "とき": 190, "ところ": 195,
    "これ": 180, "それ": 180, "あれ": 190, "どれ": 195, "この": 175,
    "その": 175, "あの": 185, "ここ": 190, "そこ": 190, "わたし": 190,
    "私": 200, "人": 260, "日": 270, "年": 270, "月": 270, "時": 270,
    # frequent adverbs / temporal nouns / question words
    "とても": 220, "少し": 220, "すこし": 230, "もう": 220, "まだ": 220,
    "また": 225, "すぐ": 225, "よく": 230, "たくさん": 225, "ちょっと": 225,
    "いつも": 225, "時々": 235, "今日": 230, "明日": 230, "昨日": 230,
    "今": 250, "毎日": 235, "今朝": 240, "今年": 240, "何": 240,
    "いつ": 240, "どこ": 235, "だれ": 240, "誰": 245, "なぜ": 240,
    "どう": 235, "こう": 250, "そう": 240,
}

# ---- conjugation paradigms -------------------------------------------------
# IPADIC's verb/adjective coverage is mostly paradigm expansion; the same
# expansion is generated here programmatically for a list of high-frequency
# stems. Each surface form enters the lexicon at a flat cost so the lattice
# prefers one conjugated-verb edge over unknown-run + auxiliary splits.
# (Original stem lists + standard textbook conjugation rules — no dictionary
# data is copied.)

#: godan row -> (nai-stem a, masu-stem i, e-stem, o-stem, te-form suffix)
_GODAN_ROWS = {
    "う": ("わ", "い", "え", "お", "って"),
    "く": ("か", "き", "け", "こ", "いて"),
    "ぐ": ("が", "ぎ", "げ", "ご", "いで"),
    "す": ("さ", "し", "せ", "そ", "して"),
    "つ": ("た", "ち", "て", "と", "って"),
    "ぬ": ("な", "に", "ね", "の", "んで"),
    "ぶ": ("ば", "び", "べ", "ぼ", "んで"),
    "む": ("ま", "み", "め", "も", "んで"),
    "る": ("ら", "り", "れ", "ろ", "って"),
}

_GODAN_VERBS = """行く 書く 聞く 歩く 働く 着く 泳ぐ 急ぐ 話す 出す 貸す 返す
待つ 持つ 立つ 死ぬ 遊ぶ 呼ぶ 飛ぶ 読む 飲む 住む 休む 頼む 買う 使う 会う
言う 思う 歌う 習う 作る 乗る 帰る 入る 走る 知る 売る 送る 取る 終わる
始まる 分かる かかる もらう""".split()

_ICHIDAN_VERBS = """見る 食べる 寝る 起きる 出る 着る 開ける 閉める 教える
覚える 忘れる 借りる 降りる できる 考える 伝える 見せる 入れる 続ける
あげる くれる 調べる 始める 決める 感じる 信じる 受ける 与える 比べる
別れる 生まれる 変える 迎える 助ける 育てる 捨てる 並べる 逃げる
投げる 上げる 下げる 集める 認める 求める 進める 止める 辞める
答える 数える 加える 抱える 超える 越える""".split()

_I_ADJECTIVES = """高い 安い 新しい 古い 大きい 小さい 良い 悪い 早い 遅い
長い 短い 暑い 寒い 楽しい 難しい 面白い 美しい 強い 弱い 近い 遠い 多い
少ない 白い 黒い 赤い 青い 忙しい 嬉しい""".split()

_CONJ_COST = 240  # between closed-class morphemes and bare-noun kanji runs


#: surface -> POS for generated paradigm forms (merged into _JA_POS below)
_PARADIGM_POS: dict = {}


def _expand_verb_paradigms(lexicon: dict) -> None:
    def add(form: str, pos: str = "動詞") -> None:
        lexicon.setdefault(form, _CONJ_COST)
        _PARADIGM_POS.setdefault(form, pos)

    for verb in _GODAN_VERBS:
        stem, ending = verb[:-1], verb[-1]
        a, i, e, o, te_suf = _GODAN_ROWS[ending]
        te = stem + ("って" if verb == "行く" else te_suf)  # 行く is irregular
        past = te[:-1] + ("だ" if te.endswith("で") else "た")
        for f in (verb, te, past, stem + i, stem + i + "ます",
                  stem + i + "ました", stem + i + "ません", stem + a + "ない",
                  stem + a + "なかった", stem + e + "る", stem + e + "ば",
                  stem + o + "う", stem + i + "たい"):
            add(f)
    for verb in _ICHIDAN_VERBS:
        stem = verb[:-1]
        for f in (verb, stem + "て", stem + "た", stem + "ない",
                  stem + "なかった", stem + "ます", stem + "ました",
                  stem + "ません", stem + "られる", stem + "よう",
                  stem + "れば", stem + "たい"):
            add(f)
    for adj in _I_ADJECTIVES:
        stem = adj[:-1]
        for f in (adj, stem + "く", stem + "くて", stem + "かった",
                  stem + "くない", stem + "くなかった", stem + "ければ"):
            add(f, pos="形容詞")


_expand_verb_paradigms(_JA_LEXICON)

# ---- POS table (kuromoji emits POS per token; coarse tag set here) --------
_JA_POS = {}
for _w in ("は が を に で と の へ も や か ね よ な から まで より ので "
           "のに には では とは でも だけ など について").split():
    _JA_POS[_w] = "助詞"
for _w in ("です だ である でした ます ました ません れる られる せる "
           "たい ない なかった").split():
    _JA_POS[_w] = "助動詞"
for _v in (_GODAN_VERBS + _ICHIDAN_VERBS
           + ("する した して します いる いた いて ある あった なる "
              "なった という").split()):
    _JA_POS.setdefault(_v, "動詞")
for _a in _I_ADJECTIVES:
    _JA_POS.setdefault(_a, "形容詞")
for _w, _p in _PARADIGM_POS.items():
    _JA_POS.setdefault(_w, _p)

# ---- open-class dictionary (nlp/ja_lexicon.py): the hand-built stand-in
# for IPADIC's open-class coverage. Merged AFTER the closed-class tables so
# function-word costs keep priority; adds ~1.1k nouns/verbal-nouns/
# na-adjectives/proper nouns with POS tags, which is what lets compound
# kanji runs split at real word boundaries (日本語勉強中 -> 日本語/勉強/中).
from .ja_lexicon import OPEN_CLASS as _JA_OPEN_CLASS

for _w, (_cost, _pos) in _JA_OPEN_CLASS.items():
    _JA_LEXICON.setdefault(_w, _cost)
    _JA_POS.setdefault(_w, _pos)

_JA_MAX_WORD = max(len(w) for w in _JA_LEXICON)
_JA_EDGE_COST = 50          # connection penalty per lattice edge
_JA_UNK_BASE = 700          # unknown-word base cost
_JA_UNK_PER_CHAR = {"kanji": 120, "hiragana": 400, "katakana": 60,
                    "latin": 40, "other": 80}


def _ja_char_class(ch: str) -> str:
    o = ord(ch)
    if 0x4E00 <= o <= 0x9FFF:
        return "kanji"
    if 0x3040 <= o <= 0x309F:
        return "hiragana"
    if 0x30A0 <= o <= 0x30FF or ch == "ー":
        return "katakana"
    if ch.isascii() and (ch.isalnum()):
        return "latin"
    return "other"


def _ja_viterbi(chunk: str) -> List[str]:
    """Minimum-cost segmentation of one whitespace-free chunk."""
    n = len(chunk)
    INF = float("inf")
    best = [INF] * (n + 1)
    back = [0] * (n + 1)
    best[0] = 0.0
    for i in range(n):
        if best[i] == INF:
            continue
        # lexicon edges
        for L in range(1, min(_JA_MAX_WORD, n - i) + 1):
            cost = _JA_LEXICON.get(chunk[i:i + L])
            if cost is not None:
                c = best[i] + cost + _JA_EDGE_COST
                if c < best[i + L]:
                    best[i + L] = c
                    back[i + L] = i
        # unknown edges: every prefix of the maximal same-class run
        # (kuromoji's unknown-word processing groups by character class);
        # the per-edge base cost keeps whole runs preferred unless a lexicon
        # split (e.g. a particle boundary inside a hiragana run) pays for it
        cls = _ja_char_class(chunk[i])
        j = i + 1
        while j < n and _ja_char_class(chunk[j]) == cls:
            j += 1
        per = _JA_UNK_PER_CHAR[cls]
        for end in range(i + 1, j + 1):
            c = best[i] + _JA_UNK_BASE + per * (end - i) + _JA_EDGE_COST
            if c < best[end]:
                best[end] = c
                back[end] = i
    out = []
    pos = n
    while pos > 0:
        out.append(chunk[back[pos]:pos])
        pos = back[pos]
    return out[::-1]


def ja_pos(token: str) -> str:
    """Coarse POS for a segmented token (kuromoji's per-token POS seam):
    lexicon tag if known, else a char-class-derived unknown tag."""
    pos = _JA_POS.get(token)
    if pos is not None:
        return pos
    if not token:
        return "記号"
    cls = _ja_char_class(token[0])
    return {"kanji": "名詞", "katakana": "名詞", "latin": "名詞",
            "hiragana": "未知語", "other": "記号"}[cls]


def ja_tokenize_with_pos(text: str) -> List[tuple]:
    """(surface, pos) pairs — the kuromoji Token.getPartOfSpeech analog."""
    out = []
    for chunk in text.split():
        out.extend((t, ja_pos(t)) for t in _ja_viterbi(chunk))
    return out


class JapaneseTokenizerFactory(TokenizerFactory):
    """Lattice-Viterbi segmentation for Japanese (kuromoji-seam equivalent;
    reference deeplearning4j-nlp-japanese). Closed-class morphemes and the
    hand-built open-class dictionary (nlp/ja_lexicon.py, ~1.1k entries with
    POS) come from the merged lexicon; unknown words are maximal script
    runs with per-class costs — e.g. 私は東京へ行きます ->
    [私, は, 東京, へ, 行きます] with particles split correctly. POS per
    token via ``ja_tokenize_with_pos``/``ja_pos``."""

    def create(self, text: str) -> Tokenizer:
        tokens: List[str] = []
        for chunk in text.split():
            tokens.extend(_ja_viterbi(chunk))
        return Tokenizer(self._apply_pre(tokens))


_KO_PARTICLES = ("은", "는", "이", "가", "을", "를", "에", "의", "로", "과",
                 "와", "도", "만", "에서", "까지", "부터", "하고")
_KO_RUNS = re.compile("([가-힯]+|[A-Za-z0-9]+|[^가-힯"
                      "A-Za-z0-9\\s]+)")


class KoreanTokenizerFactory(TokenizerFactory):
    """Hangul-run segmentation with common particle stripping (open-korean-
    text-seam equivalent)."""

    def __init__(self, strip_particles: bool = True):
        super().__init__()
        self.strip_particles = strip_particles

    def create(self, text: str) -> Tokenizer:
        tokens = []
        for m in _KO_RUNS.finditer(text):
            tok = m.group(0)
            if self.strip_particles and len(tok) > 1:
                for p in sorted(_KO_PARTICLES, key=len, reverse=True):
                    if tok.endswith(p) and len(tok) > len(p):
                        tok = tok[: -len(p)]
                        break
            tokens.append(tok)
        return Tokenizer(self._apply_pre(tokens))


class Windows:
    """Moving context windows over a token sequence (reference
    text/movingwindow/Windows.java): fixed-size windows centered on each
    token, padded with <s>/</s> edge markers."""

    @staticmethod
    def windows(tokens: Sequence[str], window_size: int = 5) -> Iterator[List[str]]:
        half = window_size // 2
        padded = ["<s>"] * half + list(tokens) + ["</s>"] * half
        for i in range(len(tokens)):
            yield padded[i:i + 2 * half + 1]
