"""Text conditioning pipeline: spatial relations -> sentences -> token embeddings.

Port of ``diffuscene_tpu/data/text.py`` (numpy only), so the port does not
import the JAX package; the reference is the ``Add_Text`` decorator and
``utils_text`` (``scene_synthesis/datasets/threed_front_dataset.py:637-819``,
``scene_synthesis/datasets/utils_text.py:5-78``).  The relation classifier,
the sentence templates and the order of the numpy generator's draws are the
JAX package's, so one seed gives the same sentences in both packages.

The tokens embed through a GloVe text file when one is given
(``glove_path``), else through :class:`HashedEmbedder`, a fixed random table
(offline; swap in real GloVe for paper parity).  num2words, nltk's
word_tokenize and cmudict are small local versions, so nothing is
downloaded.  The BERT and CLIP sentence-encoder precomputes of the JAX module
are not ported: they load ``from_pretrained`` weights, which are not in the
repository, through ``transformers``, which is not among the port's
dependencies.

One departure from the JAX module: :class:`HashedEmbedder` seeds each token's
vector from a CRC-32 of the seed and the token, not from Python's ``hash``,
which is salted per process (``PYTHONHASHSEED``); with ``hash`` a model
trained in one process meets other token vectors when it is sampled in
another.
"""
from __future__ import annotations

import math
import re
import zlib
from collections import Counter, defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# small local replacements for num2words / nltk
# ---------------------------------------------------------------------------

_CARDINALS = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen", "twenty", "twenty-one",
]
_ORDINALS = [
    "zeroth", "first", "second", "third", "fourth", "fifth", "sixth",
    "seventh", "eighth", "ninth", "tenth", "eleventh", "twelfth",
    "thirteenth", "fourteenth", "fifteenth", "sixteenth", "seventeenth",
    "eighteenth", "nineteenth", "twentieth", "twenty-first",
]


def num2words(n: int, ordinal: bool = False) -> str:
    """English number words for the small counts this pipeline needs (<=21)."""
    table = _ORDINALS if ordinal else _CARDINALS
    if 0 <= n < len(table):
        return table[n]
    return str(n)


# domain words taking "an" by pronunciation: "l" covers "l_shaped_sofa",
# whose cleaned first word is the bare letter (CMU "EH L" = vowel sound)
_VOWEL_WORDS_AN = {"armchair", "l", "l-shaped", "hour"}


def get_article(word: str) -> str:
    """'a'/'an' choice.  The reference uses cmudict pronunciations
    (utils_text.py:71-78); a letter heuristic with domain exceptions covers
    the furniture vocabulary exactly."""
    w = word.split(" ")[0].lower()
    if w in _VOWEL_WORDS_AN or (w[:1] in "aeiou"):
        return "an"
    return "a"


_TOKEN_RE = re.compile(r"[A-Za-z][A-Za-z\-']*|\d+|[.,!?;]")


def word_tokenize(sentence: str) -> List[str]:
    """Lightweight tokenizer matching nltk's behavior on the generated
    template sentences (words, numbers, punctuation)."""
    return _TOKEN_RE.findall(sentence)


def clean_obj_name(name: str) -> str:
    """(threed_front_dataset.py:633-634)"""
    return name.replace("_", " ")


# ---------------------------------------------------------------------------
# spatial relation classifier (utils_text.py:5-55, reproduced exactly)
# ---------------------------------------------------------------------------

def compute_rel(box1: Sequence[float], box2: Sequence[float]) -> Tuple[Optional[str], float]:
    """Pairwise spatial relation between two axis-aligned boxes.

    boxes are [x0, y0, z0, x1, y1, z1]; returns (relation|None, planar distance).
    """
    center1 = np.array([(box1[0] + box1[3]) / 2, (box1[1] + box1[4]) / 2, (box1[2] + box1[5]) / 2])
    center2 = np.array([(box2[0] + box2[3]) / 2, (box2[1] + box2[4]) / 2, (box2[2] + box2[5]) / 2])

    sx0, sy0, sz0, sx1, sy1, sz1 = box1
    ox0, oy0, oz0, ox1, oy1, oz1 = box2
    d = center1 - center2
    theta = math.atan2(d[2], d[0])
    distance = float((d[2] ** 2 + d[0] ** 2) ** 0.5)

    p = None
    # "on"/"above": this-center inside other's footprint
    if ox0 <= center1[0] <= ox1:
        if oz0 <= center1[2] <= oz1:
            delta1 = center1[1] - center2[1]
            delta2 = (sy1 - sy0 + oy1 - oy0) / 2
            if 0 < (delta1 - delta2) < 0.05:
                p = "on"
            elif 0.05 < (delta1 - delta2):
                p = "above"
        return p, distance

    if abs(d[1]) > 0.5:
        return p, distance

    area_s = (sx1 - sx0) * (sz1 - sz0)
    area_o = (ox1 - ox0) * (oz1 - oz0)
    ix0, ix1 = max(sx0, ox0), min(sx1, ox1)
    iz0, iz1 = max(sz0, oz0), min(sz1, oz1)
    area_i = max(0, ix1 - ix0) * max(0, iz1 - iz0)
    iou = area_i / (area_s + area_o - area_i)
    touching = 0.0001 < iou < 0.5

    if sx0 < ox0 and sx1 > ox1 and sz0 < oz0 and sz1 > oz1:
        p = "surrounding"
    elif sx0 > ox0 and sx1 < ox1 and sz0 > oz0 and sz1 < oz1:
        p = "inside"
    elif theta >= 5 * math.pi / 6 or theta <= -5 * math.pi / 6:
        p = "right touching" if touching else "left of"
    elif -2 * math.pi / 3 <= theta < -math.pi / 3:
        p = "behind touching" if touching else "behind"
    elif -math.pi / 6 <= theta < math.pi / 6:
        p = "left touching" if touching else "right of"
    elif math.pi / 3 <= theta < 2 * math.pi / 3:
        p = "front touching" if touching else "in front of"

    return p, distance


def extract_relations(translations: np.ndarray,
                      sizes: np.ndarray) -> List[Tuple[int, str, int, float]]:
    """All backward pairwise relations of a scene.

    (threed_front_dataset.py:658-687): for each object, relations to every
    earlier object, keeping only classified pairs.
    """
    relations = []
    n = len(translations)
    for ndx in range(n):
        t1, s1 = translations[ndx], sizes[ndx]
        box1 = list(t1 - s1) + list(t1 + s1)
        for other in range(ndx):
            t2, s2 = translations[other], sizes[other]
            box2 = list(t2 - s2) + list(t2 + s2)
            rel, dist = compute_rel(box1, box2)
            if rel is not None:
                relations.append((ndx, rel, other, dist))
    return relations


# ---------------------------------------------------------------------------
# sentence generation (threed_front_dataset.py:689-813, same templates)
# ---------------------------------------------------------------------------

def generate_sentences(
    obj_names: List[str],
    relations: List[Tuple[int, str, int, float]],
    rng: np.random.Generator,
    eval_mode: bool = False,
) -> List[str]:
    sentences: List[str] = []
    first_n = 3 if eval_mode else int(rng.choice([2, 3]))
    first_n_names = obj_names[:first_n]
    first_n_counts = Counter(first_n_names)

    uniq = sorted(set(first_n_names), key=first_n_names.index)
    s = "The room has "
    for ndx, name in enumerate(uniq):
        if ndx == len(uniq) - 1 and len(uniq) >= 2:
            s += "and "
        if first_n_counts[name] > 1:
            s += f"{num2words(first_n_counts[name])} {name}s "
        else:
            s += f"{get_article(name)} {name} "
        if ndx == len(uniq) - 1:
            s += ". "
        if ndx < len(uniq) - 2:
            s += ", "
    sentences.append(s)
    refs = set(range(first_n))

    seen_counts: Dict[str, int] = defaultdict(int)
    in_cls_pos = [0 for _ in obj_names]
    for ndx, name in enumerate(first_n_names):
        seen_counts[name] += 1
        in_cls_pos[ndx] = seen_counts[name]

    for ndx in range(1, len(obj_names)):
        prob_thresh = 0.3
        random_num = 1.0 if eval_mode else float(rng.random())
        if random_num > prob_thresh:
            possible = [
                r for r in relations if r[0] == ndx and r[2] in refs and r[3] < 1.5
            ]
            if not possible:
                continue
            refs.add(ndx)
            if in_cls_pos[ndx] == 0:
                seen_counts[obj_names[ndx]] += 1
                in_cls_pos[ndx] = seen_counts[obj_names[ndx]]
            pick = 0 if eval_mode else int(rng.integers(len(possible)))
            (n1, rel, n2, dist) = possible[pick]
            o1, o2 = obj_names[n1], obj_names[n2]
            if seen_counts[o1] > 1:
                o1 = f"{num2words(in_cls_pos[n1], ordinal=True)} {o1}"
            if seen_counts[o2] > 1:
                o2 = f"{num2words(in_cls_pos[n2], ordinal=True)} {o2}"
            if o1 == o2:
                continue
            a1 = get_article(o1)
            if "touching" in rel:
                if ndx in (1, 2):
                    s = f"The {o1} is next to the {o2}"
                else:
                    s = f"There is {a1} {o1} next to the {o2}"
            elif rel in ("left of", "right of"):
                if ndx in (1, 2):
                    s = f"The {o1} is to the {rel} the {o2}"
                else:
                    s = f"There is {a1} {o1} to the {rel} the {o2}"
            elif rel in ("surrounding", "inside", "behind", "in front of", "on", "above"):
                if ndx in (1, 2):
                    s = f"The {o1} is {rel} the {o2}"
                else:
                    s = f"There is {a1} {o1} {rel} the {o2}"
            else:  # pragma: no cover - compute_rel only emits the above
                continue
            sentences.append(s + " . ")
    return sentences


# ---------------------------------------------------------------------------
# token embedders
# ---------------------------------------------------------------------------

class GloveEmbedder:
    """50-d token embeddings from a GloVe text file (same vectors the
    reference loads via torchtext when `glove.6B.50d.txt` is available)."""

    def __init__(self, path: str, dim: int = 50):
        self.dim = dim
        self.table: Dict[str, np.ndarray] = {}
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip().split(" ")
                if len(parts) != dim + 1:
                    continue
                self.table[parts[0]] = np.asarray(parts[1:], np.float32)
        if not self.table:
            raise ValueError(
                f"no {dim}-d vectors found in {path!r} — the requested "
                f"embedding width does not match the GloVe file (every token "
                f"would silently embed to zeros)"
            )
        self._zero = np.zeros(dim, np.float32)

    def __call__(self, token: str) -> np.ndarray:
        return self.table.get(token.lower(), self._zero)


class HashedEmbedder:
    """Deterministic offline table: each token maps to a fixed pseudo-random
    unit-variance vector, the same in every process.  Same interface and
    shape as GloVe, so the rest of the pipeline (and the model) is
    unchanged; ``<pad>`` is the zero vector.

    The vector's generator is seeded with ``zlib.crc32(f"{seed}\\x00{token}")``.
    The JAX package seeds it with ``hash((seed, token))``, which Python salts
    per process, so its table changes from one process to the next; the two
    packages' tables therefore differ, and a test that holds the pipelines
    against each other gives both the same embedder."""

    def __init__(self, dim: int = 50, seed: int = 1234):
        self.dim = dim
        self.seed = seed
        self._cache: Dict[str, np.ndarray] = {}

    def __call__(self, token: str) -> np.ndarray:
        token = token.lower()
        v = self._cache.get(token)
        if v is None:
            h = zlib.crc32(f"{self.seed}\x00{token}".encode())
            v = np.random.default_rng(h).normal(0, 1, self.dim).astype(np.float32)
            if token == "<pad>":
                v = np.zeros(self.dim, np.float32)
            self._cache[token] = v
        return v


class TextDescriptionGenerator:
    """Per-sample text pipeline: relations -> description -> desc_emb.

    Drop-in equivalent of the reference Add_Text decorator
    (threed_front_dataset.py:637-819).  Operates on the *unscaled* sample
    dict (translations/sizes in world units) and adds:
      - sample['description']: joined sentence string
      - sample['desc_emb']: (max_token_length, emb_dim) float32
    """

    def __init__(
        self,
        class_labels: Sequence[str],
        eval: bool = False,
        max_sentences: int = 3,
        max_token_length: int = 50,
        glove_path: Optional[str] = None,
        emb_dim: int = 50,
    ):
        self.class_labels = list(class_labels)
        self.eval = eval
        self.max_sentences = max_sentences
        self.max_token_length = max_token_length
        if glove_path:
            self.embedder = GloveEmbedder(glove_path, emb_dim)
        else:
            self.embedder = HashedEmbedder(emb_dim)

    def __call__(self, sample: Dict[str, np.ndarray], rng: np.random.Generator) -> Dict:
        out = dict(sample)
        relations = extract_relations(out["translations"], out["sizes"])
        class_index = out["class_labels"].argmax(-1)
        obj_names = [clean_obj_name(self.class_labels[i]) for i in class_index]
        sentences = generate_sentences(obj_names, relations, rng, self.eval)
        sentence = "".join(sentences[: self.max_sentences])
        out["description"] = sentence
        tokens = word_tokenize(sentence)
        tokens = tokens[: self.max_token_length]
        tokens += ["<pad>"] * (self.max_token_length - len(tokens))
        out["desc_emb"] = np.stack([self.embedder(t) for t in tokens]).astype(np.float32)
        return out
