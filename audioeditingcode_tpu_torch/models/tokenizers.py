"""The text towers' tokenizers, read from the ``tokenizer.json`` and
``tokenizer_config.json`` that ``AutoTokenizer.save_pretrained`` writes into
a converted checkpoint's ``t5/`` and ``clap_text/`` directories.

The port's counterpart of the ``AutoTokenizer`` calls of the JAX registry:
``Tokenizer.__call__`` gives the ``input_ids`` and ``attention_mask`` that a
transformers fast tokenizer gives for ``tok(prompts, padding=...,
max_length=..., truncation=True, return_tensors="np")``. It implements the
components of the two tokenizers the audio models use:

- T5 (FLAN-T5): a ``Unigram`` model (Viterbi over the piece scores, as the
  ``tokenizers`` crate's ``encode_optimized``), the ``Precompiled`` and
  ``Replace`` normalizers, the ``Metaspace`` pre-tokenizer and the
  ``TemplateProcessing`` post-processor (``$A </s>``);
- RoBERTa (CLAP's text tower): a byte-level ``BPE`` model (merges by rank),
  the ``ByteLevel`` pre-tokenizer (GPT-2's split regex, written as a
  scanner over Unicode categories, and its byte-to-unicode table) and the
  ``RobertaProcessing`` post-processor (``<s> $A </s>``);
- CLIP (Stable Diffusion's text tower): the ``NFC``, ``Replace`` (each
  whitespace run to one space) and ``Lowercase`` normalizers, a
  ``Sequence`` of CLIP's ``Split`` (its regex written as a scanner, as
  GPT-2's is) and ``ByteLevel``, a byte-level ``BPE`` with the ``</w>``
  end-of-word suffix, and ``RobertaProcessing`` with ``<|startoftext|>``
  and ``<|endoftext|>``.

Added tokens are split out first, leftmost-longest, as the crate's added
vocabulary does. A component the file names that is not implemented here
raises ``NotImplementedError`` naming it; nothing is approximated.
"""

from __future__ import annotations

import base64
import json
import os
import re
import struct
import unicodedata
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

_HUGE = int(1e30)  # transformers' VERY_LARGE_INTEGER: no model_max_length
# Unicode White_Space (Rust's char::is_whitespace and the regex \s)
_WHITE_SPACE = frozenset(map(chr, [*range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680,
                                   *range(0x2000, 0x200B), 0x2028, 0x2029, 0x202F,
                                   0x205F, 0x3000]))


def _unsupported(kind: str, spec) -> NotImplementedError:
    name = spec.get("type") if isinstance(spec, dict) else spec
    return NotImplementedError(f"tokenizer {kind} {name!r} is not implemented in the port")


# --------------------------------------------------------------- graphemes
def _hangul(c: str) -> str:
    cp = ord(c)
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    return ""


def _extends(c: str) -> bool:
    """Grapheme_Extend, ZWJ, SpacingMark and the emoji modifiers."""
    return (unicodedata.category(c) in ("Mn", "Me", "Mc") or c in "‌‍"
            or 0x1F3FB <= ord(c) <= 0x1F3FF or 0xE0020 <= ord(c) <= 0xE007F)


def _pictographic(c: str) -> bool:
    cp = ord(c)
    return 0x1F000 <= cp <= 0x1FAFF or 0x2600 <= cp <= 0x27BF


def graphemes(s: str) -> List[str]:
    """Extended grapheme clusters (UAX #29: CR LF, controls, Hangul
    syllables, extend and spacing marks, emoji ZWJ sequences and regional
    indicator pairs; the rare Prepend class is not joined)."""
    out: List[str] = []
    i, n = 0, len(s)
    while i < n:
        j = i + 1
        c = s[i]
        if c == "\r" and j < n and s[j] == "\n":
            out.append(s[i:j + 1])
            i = j + 1
            continue
        if unicodedata.category(c) in ("Cc", "Zl", "Zp"):
            out.append(c)
            i = j
            continue
        if 0x1F1E6 <= ord(c) <= 0x1F1FF and j < n and 0x1F1E6 <= ord(s[j]) <= 0x1F1FF:
            j += 1
        prev = _hangul(c)
        while j < n and prev:
            h = _hangul(s[j])
            if (prev == "L" and h in ("L", "V", "LV", "LVT")) or \
               (prev in ("LV", "V") and h in ("V", "T")) or (prev in ("LVT", "T") and h == "T"):
                prev = h
                j += 1
            else:
                break
        while j < n:
            if _extends(s[j]):
                j += 1
            elif s[j - 1] == "‍" and _pictographic(s[j]):
                j += 1
            else:
                break
        out.append(s[i:j])
        i = j
    return out


# -------------------------------------------------------------- normalizers
class Precompiled:
    """sentencepiece's precompiled charsmap: a Darts double-array over the
    UTF-8 keys, and the replacement strings (NUL-terminated) they point
    to (the ``spm_precompiled`` crate's format)."""

    def __init__(self, blob: bytes):
        (size,) = struct.unpack_from("<I", blob, 0)
        self.units = np.frombuffer(blob, "<u4", size // 4, 4).astype(np.int64).tolist()
        self.normalized = blob[4 + size:]

    def _prefix_values(self, key: bytes) -> List[int]:
        units = self.units
        pos = 0
        pos ^= (units[0] >> 10) << ((units[0] & (1 << 9)) >> 6)
        out = []
        for c in key:
            if c == 0:
                break
            pos ^= c
            unit = units[pos]
            if (unit & ((1 << 31) | 0xFF)) != c:
                return out
            pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                out.append(units[pos] & ((1 << 31) - 1))
        return out

    def transform(self, chunk: str) -> Optional[str]:
        found = self._prefix_values(chunk.encode("utf-8"))
        if not found:
            return None
        start = found[0]
        end = self.normalized.index(b"\0", start) if b"\0" in self.normalized[start:] \
            else len(self.normalized)
        return self.normalized[start:end].decode("utf-8")

    def __call__(self, s: str) -> str:
        out = []
        for g in graphemes(s):
            if len(g.encode("utf-8")) < 6:
                norm = self.transform(g)
                if norm is not None:
                    out.append(norm)
                    continue
            for c in g:
                norm = self.transform(c)
                out.append(c if norm is None else norm)
        return "".join(out)


_WS_CLASS = "".join(re.escape(c) for c in sorted(_WHITE_SPACE))


def _pattern(spec: dict) -> "re.Pattern":
    """A Replace pattern in Python ``re``: ``\\s`` becomes the Unicode
    White_Space class of the Rust regex (Python's own ``\\s`` also takes the
    separators U+001C-U+001F)."""
    if "Regex" not in spec:
        return re.compile(re.escape(spec["String"]))
    out, i, pat, in_class = [], 0, spec["Regex"], False
    while i < len(pat):
        c = pat[i]
        if c == "\\" and i + 1 < len(pat):
            if pat[i + 1] == "s":
                out.append(_WS_CLASS if in_class else f"[{_WS_CLASS}]")
            elif pat[i + 1] in "pPS":
                raise _unsupported("regex", pat)
            else:
                out.append(pat[i:i + 2])
            i += 2
            continue
        in_class = (in_class and c != "]") or (not in_class and c == "[")
        out.append(c)
        i += 1
    return re.compile("".join(out))


def _normalizer(spec: Optional[dict]) -> Callable[[str], str]:
    if spec is None:
        return lambda s: s
    kind = spec["type"]
    if kind == "Sequence":
        parts = [_normalizer(n) for n in spec["normalizers"]]

        def seq(s: str) -> str:
            for p in parts:
                s = p(s)
            return s
        return seq
    if kind == "Precompiled":
        return Precompiled(base64.b64decode(spec["precompiled_charsmap"]))
    if kind == "Replace":
        pat, content = _pattern(spec["pattern"]), spec["content"]
        return lambda s: pat.sub(lambda m: content, s)
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda s: unicodedata.normalize(kind, s)
    if kind == "Lowercase":
        # char by char, as the crate does (no final-sigma rule)
        return lambda s: "".join(c.lower() for c in s)
    raise _unsupported("normalizer", spec)


# ---------------------------------------------------------- pre-tokenizers
def _metaspace(spec: dict) -> Callable[[str, bool], List[str]]:
    rep = spec.get("replacement", "▁")
    scheme = spec.get("prepend_scheme")
    if scheme is None:
        scheme = "always" if spec.get("add_prefix_space", True) else "never"
    split = spec.get("split", True)

    def pre(s: str, first: bool) -> List[str]:
        s = s.replace(" ", rep)
        if s and not s.startswith(rep) and (scheme == "always" or (scheme == "first" and first)):
            s = rep + s
        if not split:
            return [s] if s else []
        words, cur = [], ""
        for c in s:  # split before every replacement char (MergedWithNext)
            if c == rep and cur:
                words.append(cur)
                cur = ""
            cur += c
        return words + [cur] if cur else words
    return pre


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable unicode char table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTE_CHARS = _bytes_to_unicode()
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def _cls(c: str) -> str:
    if c in _WHITE_SPACE:
        return "s"
    cat = unicodedata.category(c)[0]
    return cat if cat in ("L", "N") else "o"


def gpt2_split(s: str) -> List[str]:
    """The matches of ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+|
    ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+`` over s, left to right."""
    out, i, n = [], 0, len(s)
    while i < n:
        if s[i] == "'":
            m = next((c for c in _CONTRACTIONS if s.startswith(c, i + 1)), None)
            if m is not None:
                out.append(s[i:i + 1 + len(m)])
                i += 1 + len(m)
                continue
        j = i + 1 if s[i] == " " and i + 1 < n and _cls(s[i + 1]) != "s" else i
        k = _cls(s[j])
        if k != "s":
            e = j + 1
            while e < n and _cls(s[e]) == k:
                e += 1
            out.append(s[i:e])
            i = e
            continue
        e = i
        while e < n and _cls(s[e]) == "s":
            e += 1
        if e < n and e - i > 1:  # \s+(?!\S): leave the last space to the next word
            e -= 1
        out.append(s[i:e])
        i = e
    return out


# CLIP's Split pattern, which ``clip_split`` implements
CLIP_SPLIT = r"""'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""


def clip_split(s: str) -> List[str]:
    """The matches of CLIP's ``'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|
    [^\\s\\p{L}\\p{N}]+`` over s, left to right; whitespace between them is
    dropped (``Split`` with ``behavior: Removed, invert: true``)."""
    out, i, n = [], 0, len(s)
    while i < n:
        if s[i] == "'":
            m = next((c for c in _CONTRACTIONS if s.startswith(c, i + 1)), None)
            if m is not None:
                out.append(s[i:i + 1 + len(m)])
                i += 1 + len(m)
                continue
        k = _cls(s[i])
        if k == "s":
            i += 1
            continue
        e = i + 1
        if k != "N":  # a digit is a match of its own
            while e < n and _cls(s[e]) == k:
                e += 1
        out.append(s[i:e])
        i = e
    return out


def _split(spec: dict) -> Callable[[str, bool], List[str]]:
    regex = spec.get("pattern", {}).get("Regex")
    if regex != CLIP_SPLIT or spec.get("behavior") != "Removed" or not spec.get("invert"):
        raise _unsupported("pre-tokenizer", f"Split {spec.get('pattern')} "
                           f"{spec.get('behavior')} invert={spec.get('invert')}")
    return lambda s, first: clip_split(s)


def _sequence(spec: dict, config: dict) -> Callable[[str, bool], List[str]]:
    parts = [_pre_tokenizer(p, config) for p in spec["pretokenizers"]]

    def pre(s: str, first: bool) -> List[str]:
        pieces = [s]
        for part in parts:
            pieces = [w for j, piece in enumerate(pieces) for w in part(piece, first and j == 0)]
        return pieces
    return pre


def _byte_level(spec: dict, config: dict) -> Callable[[str, bool], List[str]]:
    prefix = spec.get("add_prefix_space", False)
    if isinstance(config.get("add_prefix_space", False), bool) and "add_prefix_space" in spec:
        prefix = config.get("add_prefix_space", False)  # as transformers' fast tokenizers
    use_regex = spec.get("use_regex", True)

    def pre(s: str, first: bool) -> List[str]:
        if prefix and s and not s.startswith(" "):
            s = " " + s
        words = gpt2_split(s) if use_regex else ([s] if s else [])
        return ["".join(_BYTE_CHARS[b] for b in w.encode("utf-8")) for w in words]
    return pre


def _pre_tokenizer(spec: Optional[dict], config: dict) -> Callable[[str, bool], List[str]]:
    if spec is None:
        return lambda s, first: [s] if s else []
    kind = spec["type"]
    if kind == "Metaspace":
        return _metaspace(spec)
    if kind == "ByteLevel":
        return _byte_level(spec, config)
    if kind == "Split":
        return _split(spec)
    if kind == "Sequence":
        return _sequence(spec, config)
    raise _unsupported("pre-tokenizer", spec)


# ------------------------------------------------------------------ models
class Unigram:
    """The ``tokenizers`` crate's Unigram model (``encode_optimized``): the
    best-scoring segmentation, unknown characters scored min - 10 and
    consecutive unknowns fused into one token."""

    def __init__(self, spec: dict):
        if spec.get("byte_fallback"):
            raise _unsupported("model option", "Unigram byte_fallback")
        self.vocab = [(p, float(s)) for p, s in spec["vocab"]]
        self.ids = {}
        for i, (p, _) in enumerate(self.vocab):
            self.ids.setdefault(p, i)
        self.unk_id = spec.get("unk_id")
        self.unk_score = min(s for _, s in self.vocab) - 10.0
        self.max_len = max(len(p) for p, _ in self.vocab)

    def __call__(self, word: str) -> List[int]:
        n = len(word)
        if n == 0:
            return []
        best: List[Optional[Tuple[float, int, int]]] = [None] * (n + 1)  # (score, start, id)
        best[0] = (0.0, 0, -1)
        for i in range(n):
            here = best[i][0]
            single = False
            for L in range(1, min(self.max_len, n - i) + 1):
                tid = self.ids.get(word[i:i + L])
                if tid is None:
                    continue
                cand = here + self.vocab[tid][1]
                if best[i + L] is None or cand > best[i + L][0]:
                    best[i + L] = (cand, i, tid)
                single = single or L == 1
            if not single:
                if self.unk_id is None:
                    raise ValueError(f"Unigram: no piece for {word[i]!r} and no unk_id")
                cand = here + self.unk_score
                if best[i + 1] is None or cand > best[i + 1][0]:
                    best[i + 1] = (cand, i, self.unk_id)
        ids: List[int] = []
        end = n
        fused = False
        while end > 0:
            _, start, tid = best[end]
            if tid == self.unk_id:
                if not fused:
                    ids.append(tid)
                fused = True
            else:
                ids.append(tid)
                fused = False
            end = start
        return ids[::-1]


class BPE:
    """A BPE model, as the ``tokenizers`` crate's: each pre-tokenized word's
    characters, the last one with ``end_of_word_suffix`` (CLIP's ``</w>``),
    become symbols; a symbol not in the vocabulary becomes the unknown token
    and takes part in no merge; the others merge by rank."""

    def __init__(self, spec: dict):
        if spec.get("dropout"):
            raise _unsupported("model option", "BPE dropout")
        if spec.get("continuing_subword_prefix"):
            raise _unsupported("model option", "BPE continuing_subword_prefix")
        if spec.get("byte_fallback"):
            raise _unsupported("model option", "BPE byte_fallback")
        self.vocab = spec["vocab"]
        merges = [m.split(" ") if isinstance(m, str) else m for m in spec["merges"]]
        self.ranks = {tuple(m): r for r, m in enumerate(merges)}
        self.unk = spec.get("unk_token")
        self.fuse_unk = spec.get("fuse_unk", False)
        self.ignore_merges = spec.get("ignore_merges", False)
        self.suffix = spec.get("end_of_word_suffix") or ""

    def _merge(self, syms: List[Optional[str]]) -> List[Optional[str]]:
        while len(syms) > 1:
            ranked = [(self.ranks.get((a, b)), i) for i, (a, b) in enumerate(zip(syms, syms[1:]))
                      if a is not None and b is not None]
            ranked = [(r, i) for r, i in ranked if r is not None]
            if not ranked:
                break
            _, first = min(ranked)
            a, b = syms[first], syms[first + 1]
            out, i = [], 0
            while i < len(syms):
                if i < len(syms) - 1 and syms[i] == a and syms[i + 1] == b:
                    out.append(a + b)
                    i += 2
                else:
                    out.append(syms[i])
                    i += 1
            syms = out
        return syms

    def __call__(self, word: str) -> List[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        syms = [c + (self.suffix if i == len(word) - 1 else "") for i, c in enumerate(word)]
        ids: List[int] = []
        prev_unk = False
        for tok in self._merge([t if t in self.vocab else None for t in syms]):
            if tok is not None:
                ids.append(self.vocab[tok])
                prev_unk = False
            elif self.unk is not None:
                if not (self.fuse_unk and prev_unk):
                    ids.append(self.vocab[self.unk])
                prev_unk = True
        return ids


def _model(spec: dict):
    kind = spec.get("type")
    if kind == "Unigram":
        return Unigram(spec)
    if kind == "BPE":
        return BPE(spec)
    raise _unsupported("model", spec)


# ----------------------------------------------------------- post-process
def _post_processor(spec: Optional[dict]) -> Tuple[List[int], List[int]]:
    """(ids before, ids after) the sequence of a single input."""
    if spec is None:
        return [], []
    kind = spec["type"]
    if kind == "RobertaProcessing":
        return [spec["cls"][1]], [spec["sep"][1]]
    if kind == "TemplateProcessing":
        before, after, seen = [], [], False
        for piece in spec["single"]:
            if "Sequence" in piece:
                seen = True
            else:
                ids = spec["special_tokens"][piece["SpecialToken"]["id"]]["ids"]
                (after if seen else before).extend(ids)
        return before, after
    raise _unsupported("post-processor", spec)


# --------------------------------------------------------------- tokenizer
class Tokenizer:
    """One tokenizer.json with its tokenizer_config.json."""

    def __init__(self, spec: dict, config: Optional[dict] = None):
        config = config or {}
        if spec.get("truncation") or spec.get("padding"):
            raise _unsupported("setting", "truncation/padding stored in tokenizer.json")
        self.normalize = _normalizer(spec.get("normalizer"))
        self.pre_tokenize = _pre_tokenizer(spec.get("pre_tokenizer"), config)
        self.model = _model(spec["model"])
        self.before, self.after = _post_processor(spec.get("post_processor"))
        self.added = []
        for t in spec.get("added_tokens", []):
            if t.get("single_word"):
                raise _unsupported("added-token option", "single_word")
            self.added.append(t)
        self.model_max_length = int(config.get("model_max_length", _HUGE))
        pad = config.get("pad_token")
        pad = pad.get("content") if isinstance(pad, dict) else pad
        self.pad_token_id = None if pad is None else self.token_to_id(pad)

    @classmethod
    def from_dir(cls, d: str) -> "Tokenizer":
        with open(os.path.join(d, "tokenizer.json"), encoding="utf-8") as f:
            spec = json.load(f)
        config = {}
        path = os.path.join(d, "tokenizer_config.json")
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                config = json.load(f)
        return cls(spec, config)

    def token_to_id(self, token: str) -> int:
        for t in self.added:
            if t["content"] == token:
                return t["id"]
        vocab = getattr(self.model, "ids", None) or getattr(self.model, "vocab")
        if token not in vocab:
            raise KeyError(f"token {token!r} is not in the vocabulary")
        return vocab[token]

    def _split_added(self, s: str, normalized: bool) -> List[Tuple[int, int, Optional[int]]]:
        """(start, end, id or None) pieces of s, the added tokens whose
        ``normalized`` flag is ``normalized`` matched leftmost-longest."""
        toks = [t for t in self.added if bool(t.get("normalized")) == normalized]
        out, i, last = [], 0, 0
        while i < len(s):
            m = max((t for t in toks if s.startswith(t["content"], i)),
                    key=lambda t: len(t["content"]), default=None)
            if m is None or not m["content"]:
                i += 1
                continue
            start, end = i, i + len(m["content"])
            if m.get("lstrip"):
                while start > last and s[start - 1] in _WHITE_SPACE:
                    start -= 1
            if m.get("rstrip"):
                while end < len(s) and s[end] in _WHITE_SPACE:
                    end += 1
            if start > last:
                out.append((last, start, None))
            out.append((start, end, m["id"]))
            i = last = end
        if last < len(s):
            out.append((last, len(s), None))
        return out

    def encode(self, text: str) -> List[int]:
        """Token ids of one text, without the post-processor's tokens."""
        ids: List[int] = []
        for start, end, tid in self._split_added(text, normalized=False):
            if tid is not None:
                ids.append(tid)
                continue
            norm = self.normalize(text[start:end])
            for s2, e2, tid2 in self._split_added(norm, normalized=True):
                if tid2 is not None:
                    ids.append(tid2)
                    continue
                for word in self.pre_tokenize(norm[s2:e2], start == 0 and s2 == 0):
                    ids.extend(self.model(word))
        return ids

    def __call__(self, prompts: Sequence[str], padding="max_length",
                 max_length: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """(input_ids, attention_mask), int64 (B, K), as a transformers
        fast tokenizer's call with ``truncation=True``: each sequence cut to
        ``max_length`` with its special tokens, then right-padded with
        ``pad_token_id`` to ``max_length`` (``padding="max_length"``) or to
        the longest (``padding=True``)."""
        if max_length is None:
            max_length = self.model_max_length
        n_special = len(self.before) + len(self.after)
        rows = []
        for p in prompts:
            ids = self.encode(p)[: max(max_length - n_special, 0)]
            rows.append(self.before + ids + self.after)
        if padding == "max_length":
            width = max_length
        elif padding is True:
            width = max(len(r) for r in rows)
        else:
            raise ValueError(f"padding={padding!r}")
        width = max([width] + [len(r) for r in rows])
        ids = np.full((len(rows), width), self.pad_token_id or 0, np.int64)
        mask = np.zeros((len(rows), width), np.int64)
        for i, r in enumerate(rows):
            ids[i, :len(r)] = r
            mask[i, :len(r)] = 1
        return ids, mask


# ------------------------------------------------------ slow -> fast export
# special tokens of transformers' slow tokenizers, by kind, where the
# tokenizer_config.json (or special_tokens_map.json) names none
_SPECIAL_DEFAULTS = {
    "roberta": {"bos_token": "<s>", "eos_token": "</s>", "sep_token": "</s>",
                "cls_token": "<s>", "unk_token": "<unk>", "pad_token": "<pad>",
                "mask_token": "<mask>"},
    "clip": {"bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
             "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>"},
    "t5": {"eos_token": "</s>", "unk_token": "<unk>", "pad_token": "<pad>"},
}
_TOKENIZER_CLASSES = {"roberta": "RobertaTokenizer", "clip": "CLIPTokenizer",
                      "t5": "T5Tokenizer"}
# keys of a tokenizer_config.json carried over as they are
_CONFIG_KEYS = ("model_max_length", "add_prefix_space", "trim_offsets", "errors",
                "do_lower_case", "extra_ids", "additional_special_tokens",
                "clean_up_tokenization_spaces")
CLIP_MAX_MERGES = 49152 - 256 - 2  # CLIPTokenizer reads at most this many merges


def _read_json(path: str, default=None):
    if not os.path.exists(path):
        return default
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _content(token) -> Optional[str]:
    return token.get("content") if isinstance(token, dict) else token


def tokenizer_settings(d: str, kind: str) -> dict:
    """The settings of a tokenizer directory as transformers' slow
    tokenizer of ``kind`` resolves them: its class defaults, then
    special_tokens_map.json, then tokenizer_config.json."""
    config = _read_json(os.path.join(d, "tokenizer_config.json"), {})
    special = _read_json(os.path.join(d, "special_tokens_map.json"), {})
    out = dict(_SPECIAL_DEFAULTS[kind])
    for source in (special, config):
        out.update({k: v for k, v in source.items()
                    if k in _SPECIAL_DEFAULTS[kind] and v is not None})
    out.update({k: config[k] for k in _CONFIG_KEYS if k in config})
    out["tokenizer_class"] = config.get("tokenizer_class") or _TOKENIZER_CLASSES[kind]
    return out


def _read_merges(path: str, kind: str) -> List[List[str]]:
    """The merges of a ``merges.txt`` as the slow tokenizer reads them:
    RoBERTa drops the first and the last line (the version header and the
    empty string after the final newline), CLIP strips the text, drops the
    header and keeps at most ``CLIP_MAX_MERGES``; a repeated merge keeps
    its first place."""
    with open(path, encoding="utf-8") as f:
        text = f.read()
    lines = (text.split("\n")[1:-1] if kind == "roberta"
             else text.strip().split("\n")[1:CLIP_MAX_MERGES + 1])
    return [list(m) for m in dict.fromkeys(tuple(line.split()) for line in lines)]


def fast_tokenizer_json(d: str, kind: str) -> dict:
    """The ``tokenizer.json`` that transformers' slow -> fast converter
    builds from ``vocab.json`` and ``merges.txt`` (``RobertaConverter`` or
    ``CLIPConverter``), with the special tokens the fast tokenizer adds."""
    settings = tokenizer_settings(d, kind)
    vocab = _read_json(os.path.join(d, "vocab.json"))
    merges = _read_merges(os.path.join(d, "merges.txt"), kind)
    specials = {k: _content(settings[k]) for k in _SPECIAL_DEFAULTS[kind]}
    vocab = dict(vocab)
    for tok in specials.values():  # a special token outside the vocabulary is appended
        vocab.setdefault(tok, len(vocab))
    added = []
    for name, tok in sorted(specials.items(), key=lambda kv: vocab[kv[1]]):
        if any(t["content"] == tok for t in added):
            continue
        lstrip = kind == "roberta" and name == "mask_token"
        added.append({"id": vocab[tok], "content": tok, "single_word": False,
                      "lstrip": lstrip, "rstrip": False, "normalized": not lstrip,
                      "special": True})
    prefix = bool(settings.get("add_prefix_space", False))
    byte_level = {"type": "ByteLevel", "add_prefix_space": prefix, "trim_offsets": True,
                  "use_regex": True}
    model = {"type": "BPE", "dropout": None, "unk_token": None,
             "continuing_subword_prefix": "", "end_of_word_suffix": "", "fuse_unk": False,
             "byte_fallback": False, "ignore_merges": False, "vocab": vocab,
             "merges": merges}
    spec = {"version": "1.0", "truncation": None, "padding": None, "added_tokens": added,
            "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                        "use_regex": True}}
    if kind == "roberta":
        return {**spec, "normalizer": None, "pre_tokenizer": byte_level,
                "post_processor": {"type": "RobertaProcessing",
                                   "sep": [specials["sep_token"], vocab[specials["sep_token"]]],
                                   "cls": [specials["cls_token"], vocab[specials["cls_token"]]],
                                   "trim_offsets": True, "add_prefix_space": prefix},
                "model": model}
    return {**spec,
            "normalizer": {"type": "Sequence", "normalizers": [
                {"type": "NFC"}, {"type": "Replace", "pattern": {"Regex": "\\s+"},
                                  "content": " "}, {"type": "Lowercase"}]},
            "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
                {"type": "Split", "pattern": {"Regex": CLIP_SPLIT}, "behavior": "Removed",
                 "invert": True}, dict(byte_level, add_prefix_space=False)]},
            "post_processor": {"type": "RobertaProcessing",
                               "sep": [specials["eos_token"], vocab[specials["eos_token"]]],
                               "cls": [specials["bos_token"], vocab[specials["bos_token"]]],
                               "trim_offsets": False, "add_prefix_space": False},
            "model": dict(model, unk_token=specials["unk_token"], end_of_word_suffix="</w>")}


def export_tokenizer(src: str, out: str, kind: str) -> None:
    """Write the tokenizer of directory ``src`` into ``out`` as
    ``Tokenizer.from_dir`` and ``AutoTokenizer.from_pretrained`` read it:
    its ``tokenizer.json`` copied, or built from ``vocab.json`` and
    ``merges.txt`` (``kind`` ``roberta`` or ``clip``), and a
    ``tokenizer_config.json`` with the class, ``model_max_length`` and the
    special tokens of the source. A T5 directory without ``tokenizer.json``
    (a sentencepiece ``spiece.model`` only) raises: no sentencepiece reader
    is ported."""
    if not os.path.isdir(src):
        raise FileNotFoundError(f"missing tokenizer directory: {src}")
    os.makedirs(out, exist_ok=True)
    spec_path = os.path.join(src, "tokenizer.json")
    if os.path.exists(spec_path):
        with open(spec_path, "rb") as f:
            blob = f.read()
    elif kind in ("roberta", "clip") and all(
            os.path.exists(os.path.join(src, f)) for f in ("vocab.json", "merges.txt")):
        blob = json.dumps(fast_tokenizer_json(src, kind), ensure_ascii=False).encode("utf-8")
    else:
        raise ValueError(f"{src}: no tokenizer.json (and no vocab.json + merges.txt to "
                         f"build a {kind} one from); a sentencepiece-only tokenizer is "
                         f"not read by the port")
    with open(os.path.join(out, "tokenizer.json"), "wb") as f:
        f.write(blob)
    with open(os.path.join(out, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump(tokenizer_settings(src, kind), f, indent=2, ensure_ascii=False)
