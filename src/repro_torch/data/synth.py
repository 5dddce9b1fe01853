"""Synthetic data generators.

Two families:
* the paper's eight random-access benchmark types (§6.1, table p.8) with the
  exact average sizes and 10% top-level nulls;
* scenario datasets standing in for the §6.2 compression corpus (names,
  prompts, dates, reviews, code, images, embeddings, websites) — synthetic
  with matching statistics (zipfian vocab for text, sorted dates, random
  bytes for compressed images, unit-norm float vectors).
"""

from __future__ import annotations

import numpy as np

from ..core import arrays as A
from ..core import types as T

__all__ = ["paper_type", "PAPER_TYPES", "scenario", "SCENARIOS", "token_corpus"]

PAPER_TYPES = [
    "scalar", "string", "scalar-list", "string-list",
    "vector", "vector-list", "image", "image-list",
]


def _nulls(rng, n, frac=0.10):
    return rng.random(n) >= frac


def paper_type(name: str, n: int, seed: int = 0) -> A.Array:
    """The §6.1 table: avg sizes 8B/16B/40B/80B/3Ki/15Ki/20Ki/100Ki."""
    rng = np.random.default_rng(seed)
    v = _nulls(rng, n)
    if name == "scalar":
        return A.PrimitiveArray(T.uint64(), v, rng.integers(0, 1 << 60, n).astype(np.uint64))
    if name == "string":  # avg 16 bytes
        lens = rng.integers(8, 25, n)
        return _strings(rng, v, lens)
    if name == "scalar-list":  # avg 40 bytes = ~5 u64
        return _list_of(rng, v, lambda m: A.PrimitiveArray(
            T.uint64(nullable=False), np.ones(m, bool),
            rng.integers(0, 1 << 60, m).astype(np.uint64)), lo=2, hi=8, n=n)
    if name == "string-list":  # avg 80 bytes = ~5 strings of 16
        def mk(m):
            s = _strings(rng, np.ones(m, bool), rng.integers(8, 25, m))
            s.type = s.type.with_nullable(False)
            return s
        return _list_of(rng, v, mk, lo=2, hi=8, n=n)
    if name == "vector":  # FSL<f32,768> = 3 KiB
        return A.FixedSizeListArray(
            T.FixedSizeList(T.Primitive("float32", nullable=False), 768), v,
            rng.standard_normal((n, 768)).astype(np.float32))
    if name == "vector-list":  # ~5 vectors = 15 KiB
        def mkv(m):
            return A.FixedSizeListArray(
                T.FixedSizeList(T.Primitive("float32", nullable=False), 768, nullable=False),
                np.ones(m, bool), rng.standard_normal((m, 768)).astype(np.float32))
        return _list_of(rng, v, mkv, lo=3, hi=8, n=n)
    if name == "image":  # Binary ~20 KiB (already-compressed payload)
        lens = rng.integers(15_000, 25_000, n)
        return _binary(rng, v, lens)
    if name == "image-list":  # ~5 images = 100 KiB
        def mkb(m):
            b = _binary(rng, np.ones(m, bool), rng.integers(15_000, 25_000, m))
            b.type = b.type.with_nullable(False)
            return b
        return _list_of(rng, v, mkb, lo=3, hi=8, n=n)
    raise KeyError(name)


def _strings(rng, validity, lens) -> A.VarBinaryArray:
    lens = np.where(validity, lens, 0).astype(np.int64)
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    data = rng.integers(97, 123, int(offsets[-1])).astype(np.uint8)
    return A.VarBinaryArray(T.utf8(), validity.copy(), offsets, data)


def _binary(rng, validity, lens) -> A.VarBinaryArray:
    lens = np.where(validity, lens, 0).astype(np.int64)
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    data = rng.integers(0, 256, int(offsets[-1])).astype(np.uint8)
    return A.VarBinaryArray(T.binary(), validity.copy(), offsets, data)


def _list_of(rng, validity, make_child, lo, hi, n) -> A.ListArray:
    lens = np.where(validity, rng.integers(lo, hi, n), 0).astype(np.int64)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    child = make_child(int(offsets[-1]))
    return A.ListArray(T.List(child.type), validity.copy(), offsets, child)


# ---------------------------------------------------------------------------
# compression scenario corpus (synthetic stand-ins, §6.2)
# ---------------------------------------------------------------------------

SCENARIOS = ["names", "prompts", "dates", "reviews", "code", "images",
             "embeddings", "websites"]

_WORDS = None


def _word_bank(rng, n_words=2000, zipf=1.3):
    global _WORDS
    if _WORDS is None:
        lens = rng.integers(3, 10, n_words)
        _WORDS = [bytes(rng.integers(97, 123, l, dtype=np.uint8)) for l in lens]
    probs = 1.0 / np.arange(1, n_words + 1) ** zipf
    return _WORDS, probs / probs.sum()


def _text(rng, n, words_per, zipf=1.3) -> A.VarBinaryArray:
    bank, p = _word_bank(rng)
    vals = []
    for _ in range(n):
        k = rng.integers(*words_per)
        idx = rng.choice(len(bank), k, p=p)
        vals.append(b" ".join(bank[i] for i in idx))
    return A.VarBinaryArray.build(vals, utf8=True)


def scenario(name: str, n: int, seed: int = 0) -> A.Array:
    rng = np.random.default_rng(seed)
    if name == "names":  # low-cardinality (dictionary-friendly)
        bank = [bytes(rng.integers(65, 91, rng.integers(4, 9), dtype=np.uint8))
                for _ in range(800)]
        vals = [bank[i] for i in rng.integers(0, len(bank), n)]
        return A.VarBinaryArray.build(vals, utf8=True)
    if name == "prompts":
        return _text(rng, n, (20, 120))
    if name == "dates":  # TPC-H ship date: sorted-ish int32 days
        base = rng.integers(8000, 12000, n).astype(np.int32)
        return A.PrimitiveArray(T.int32(), np.ones(n, bool), np.sort(base))
    if name == "reviews":
        return _text(rng, n, (30, 200))
    if name == "code":  # repetitive structured text
        lines = [b"def f_%d(x):\n    return x + %d\n" % (i % 97, i % 13) for i in range(64)]
        vals = [b"".join(lines[rng.integers(0, 64)] for _ in range(rng.integers(5, 40)))
                for _ in range(n)]
        return A.VarBinaryArray.build(vals)
    if name == "images":  # already-compressed: incompressible bytes
        return _binary(rng, np.ones(n, bool), rng.integers(8_000, 30_000, n))
    if name == "embeddings":  # CLIP-like unit vectors f32[512]
        x = rng.standard_normal((n, 512)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        return A.FixedSizeListArray(
            T.FixedSizeList(T.Primitive("float32", nullable=False), 512),
            np.ones(n, bool), x)
    if name == "websites":  # html-ish with heavy tag repetition
        tags = [b"<div class='c%d'>" % (i % 23) for i in range(23)] + [b"</div>", b"<p>", b"</p>"]
        bank, p = _word_bank(rng)
        vals = []
        for _ in range(n):
            parts = []
            for _ in range(rng.integers(10, 80)):
                parts.append(tags[rng.integers(0, len(tags))])
                parts.append(bank[rng.choice(len(bank), p=p)])
            vals.append(b"".join(parts))
        return A.VarBinaryArray.build(vals)
    raise KeyError(name)


def token_corpus(n_rows: int, seq_len: int, vocab: int, seed: int = 0) -> A.Array:
    """Tokenized documents as List<int32> (the training-pipeline column)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(seq_len // 2, seq_len * 2, n_rows).astype(np.int64)
    offsets = np.zeros(n_rows + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    # zipfian tokens compress realistically under bitpack/RLE
    flat = (rng.zipf(1.3, int(offsets[-1])) % vocab).astype(np.int32)
    child = A.PrimitiveArray(T.int32(nullable=False), np.ones(len(flat), bool), flat)
    return A.ListArray(T.List(child.type, nullable=False), np.ones(n_rows, bool),
                       offsets, child)
