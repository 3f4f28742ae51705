"""Parity of the port's text pipeline (diffuscene_tpu_torch/data/text.py and
the text step of data/encoding.py) with the JAX package's
(diffuscene_tpu/data/text.py): the relation classifier, the sentence
templates with the numpy generator drawn in the same order, the small
tokenizer, GloVe files, the per-sample generator and the ``text`` /
``textfix`` encodings of a synthetic dataset, every key equal.

The JAX ``HashedEmbedder`` seeds its vectors with Python's salted ``hash``,
so its table differs from process to process; the port's uses a CRC-32 and
is the same in every process (a test below runs two interpreters with
different ``PYTHONHASHSEED``).  Tests that hold the two pipelines against
each other inject one embedder into both.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from diffuscene_tpu.data import make_synthetic_cached_dataset as j_make_synthetic
from diffuscene_tpu.data import text as jt
from diffuscene_tpu.data.factory import get_dataset_raw_and_encoded as j_get_dataset
from diffuscene_tpu_torch.data import text as tt
from diffuscene_tpu_torch.data.factory import get_dataset_raw_and_encoded
from test_torch_threads import one_thread_per_worker  # noqa: F401 (autouse)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENCODING = "cached_diffusion_text_cosin_angle_objfeatsnorm_lat32_wocm"


def _box(cx, cy, cz, sx, sy, sz):
    return [cx - sx, cy - sy, cz - sz, cx + sx, cy + sy, cz + sz]


# the JAX package's relation goldens (tests/test_text.py) and what each gives
GOLDEN = [
    ((_box(0, 2, 0, 0.2, 0.2, 0.2), _box(0, 0.2, 0, 1, 0.2, 1)), "above"),
    ((_box(0, 0.42, 0, 1, 0.2, 1), _box(0, 0.0, 0, 2, 0.2, 2)), "on"),
    ((_box(2, 0, 0, 0.3, 0.3, 0.3), _box(0, 0, 0, 0.3, 0.3, 0.3)), "right of"),
    ((_box(-2, 0, 0, 0.3, 0.3, 0.3), _box(0, 0, 0, 0.3, 0.3, 0.3)), "left of"),
    ((_box(0.5, 0, 2, 0.1, 0.3, 0.3), _box(0, 0, 0, 0.3, 0.3, 0.3)), "in front of"),
    ((_box(0.5, 0, -2, 0.1, 0.3, 0.3), _box(0, 0, 0, 0.3, 0.3, 0.3)), "behind"),
    ((_box(0, 0, 2, 0.3, 0.3, 0.3), _box(0, 0, 0, 0.3, 0.3, 0.3)), None),
    ((_box(0, 0, 0, 3, 0.3, 3), _box(1.0, 0, 0, 0.2, 0.3, 0.2)), "surrounding"),
    ((_box(2, 3, 0, 0.2, 0.2, 0.2), _box(0, 0, 0, 0.3, 0.3, 0.3)), None),
]

NAMES = ["double bed", "nightstand", "nightstand", "wardrobe", "armchair", "l shaped sofa",
         "nightstand", "ceiling lamp"]


def _scene(rng, n):
    """A room of ``n`` objects close enough to relate to each other."""
    trans = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    trans[:, 1] = rng.uniform(0, 0.6, n)
    sizes = rng.uniform(0.1, 0.8, (n, 3)).astype(np.float32)
    return trans, sizes


@pytest.mark.parametrize("case", range(len(GOLDEN)))
def test_compute_rel_matches_jax_goldens(case):
    (b1, b2), rel = GOLDEN[case]
    got, want = tt.compute_rel(b1, b2), jt.compute_rel(b1, b2)
    assert got == want and got[0] == rel


def test_extract_relations_matches_jax():
    """Every backward pair of 40 random rooms: the same classified pairs,
    relations and planar distances, in the same order."""
    rng = np.random.default_rng(0)
    n_rel = 0
    for _ in range(40):
        trans, sizes = _scene(rng, int(rng.integers(2, 13)))
        got = tt.extract_relations(trans, sizes)
        assert got == jt.extract_relations(trans, sizes)
        n_rel += len(got)
    assert n_rel > 100


@pytest.mark.parametrize("eval_mode", [False, True], ids=["train", "eval"])
def test_generate_sentences_matches_jax(eval_mode):
    """The same sentences from generators of one seed, and the generators
    left in the same state (the same draws, in the same order)."""
    rng = np.random.default_rng(1)
    for seed in range(30):
        n = int(rng.integers(2, len(NAMES) + 1))
        names = [NAMES[i] for i in rng.permutation(len(NAMES))[:n]]
        trans, sizes = _scene(rng, n)
        rels = tt.extract_relations(trans, sizes)
        g_t, g_j = np.random.default_rng(seed), np.random.default_rng(seed)
        got = tt.generate_sentences(names, rels, g_t, eval_mode)
        assert got == jt.generate_sentences(names, rels, g_j, eval_mode)
        assert g_t.random() == g_j.random()
        assert got[0].startswith("The room has ")


def test_tokenizer_number_words_and_articles():
    for n in range(25):
        for ordinal in (False, True):
            assert tt.num2words(n, ordinal) == jt.num2words(n, ordinal)
    for word in ("armchair", "l shaped sofa", "bed", "ottoman", "hour", "wardrobe", "unit"):
        assert tt.get_article(word) == jt.get_article(word)
    s = "The room has a bed , and two chairs . The l-shaped sofa's 3rd cushion is on it!"
    assert tt.word_tokenize(s) == jt.word_tokenize(s)
    assert tt.clean_obj_name("double_bed") == jt.clean_obj_name("double_bed") == "double bed"


def test_glove_embedder_reads_a_file(tmp_path):
    """Vectors of the file's width, lower-cased lookups, zeros for unknown
    tokens, the same arrays as the JAX reader; a width the file does not
    have raises."""
    rng = np.random.default_rng(2)
    words = ["the", "room", "has", "a", "bed", ".", ","]
    vecs = rng.normal(size=(len(words), 8)).astype(np.float32)
    path = tmp_path / "glove.8d.txt"
    path.write_text("".join(f"{w} {' '.join(f'{v:.6f}' for v in row)}\n"
                            for w, row in zip(words, vecs)) + "short 1.0 2.0\n")
    got, want = tt.GloveEmbedder(str(path), 8), jt.GloveEmbedder(str(path), 8)
    for w in words + ["Bed", "unknown"]:
        assert got(w).dtype == np.float32 and np.array_equal(got(w), want(w)), w
    np.testing.assert_allclose(got("bed"), vecs[4], atol=1e-6)
    assert not got("unknown").any()
    with pytest.raises(ValueError, match="no 50-d vectors"):
        tt.GloveEmbedder(str(path), 50)


def test_text_generator_with_one_embedder_matches_jax():
    """TextDescriptionGenerator in train and eval mode on random rooms, the
    port's hashed table injected into both: the same description and
    desc_emb (50, 24), pads zero, and the generators in the same state."""
    labels = ["double_bed", "nightstand", "wardrobe", "armchair", "start", "end"]
    emb = tt.HashedEmbedder(24)
    rng = np.random.default_rng(3)
    for eval_mode in (False, True):
        g_t, g_j = tt.TextDescriptionGenerator(labels, eval_mode), \
            jt.TextDescriptionGenerator(labels, eval_mode)
        g_t.embedder = g_j.embedder = emb
        for seed in range(10):
            n = int(rng.integers(2, 9))
            trans, sizes = _scene(rng, n)
            sample = {"class_labels": np.eye(len(labels), dtype=np.float32)[
                          rng.integers(0, 4, n)],
                      "translations": trans, "sizes": sizes,
                      "angles": np.zeros((n, 1), np.float32)}
            r_t, r_j = np.random.default_rng(seed), np.random.default_rng(seed)
            got, want = g_t(sample, r_t), g_j(sample, r_j)
            assert got.keys() == want.keys()
            assert got["description"] == want["description"]
            assert got["desc_emb"].shape == (50, 24) and got["desc_emb"].dtype == np.float32
            assert np.array_equal(got["desc_emb"], want["desc_emb"])
            n_tok = len(tt.word_tokenize(got["description"]))
            assert not got["desc_emb"][n_tok:].any()
            assert r_t.random() == r_j.random()


def _text_config(data_dir, encoding):
    return {"dataset_type": "cached_threedfront", "encoding_type": encoding,
            "dataset_directory": data_dir,
            "annotation_file": os.path.join(data_dir, "splits.csv"),
            "augmentations": ["fixed_rotations"], "train_stats": "dataset_stats.txt",
            "room_layout_size": "64,64", "max_length": 12, "text_emb_dim": 768}


@pytest.mark.parametrize("encoding,split", [
    (ENCODING, ("train", "val")),
    (ENCODING.replace("text", "textfix") + "_no_prm", ("test",))], ids=["text", "textfix"])
def test_text_encodings_match_jax(tmp_path, encoding, split):
    """The bedroom text config's encoding (fixed rotations, the text step on
    the pipeline's generator between the rotation and the permutation, 768
    wide tokens) and generate's eval rewrite of it (``textfix``, no
    permutation) over two passes of a synthetic dataset, seed 5: every key
    of every sample equal to JAX's, desc_emb exactly (one embedder in both)."""
    data_dir = str(tmp_path / "cached")
    j_make_synthetic(data_dir, n_scenes=24, seed=0)
    cfg = _text_config(data_dir, encoding)
    _, ds_t = get_dataset_raw_and_encoded(cfg, augmentations=cfg["augmentations"], split=split,
                                          seed=5)
    _, ds_j = j_get_dataset(cfg, augmentations=cfg["augmentations"], split=split, seed=5)
    assert ds_t.encoding.text_eval == ("textfix" in encoding)
    ds_t.encoding._text_encoder.embedder = ds_j.encoding._text_encoder.embedder = \
        tt.HashedEmbedder(768)
    assert len(ds_t) == len(ds_j) > 0
    for _ in range(2):
        for i in range(len(ds_j)):
            got, want = ds_t[i], ds_j[i]
            assert got.keys() == want.keys() and "desc_emb" in got
            assert got["description"] == want["description"]
            assert got["desc_emb"].shape == (50, 768)
            for k in want:
                if k != "description":
                    assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), (i, k)


def test_hashed_embedder_is_the_same_in_every_process():
    """Two interpreters with different string-hash salts give the same
    vectors (the JAX table would not); <pad> is zero."""
    code = ("from diffuscene_tpu_torch.data.text import HashedEmbedder as H; "
            "import json; e = H(16); print(json.dumps(e('bed').tolist() + "
            "e('Nightstand').tolist() + e('<pad>').tolist()))")
    outs = []
    for salt in ("1", "2"):
        env = dict(os.environ, PYTHONHASHSEED=salt, PYTHONPATH=REPO)
        outs.append(subprocess.run([sys.executable, "-c", code], env=env, check=True,
                                   capture_output=True, text=True, timeout=120).stdout)
    assert outs[0] == outs[1]
    here = tt.HashedEmbedder(16)
    vals = json.loads(outs[0])
    assert vals == here("bed").tolist() + here("nightstand").tolist() + [0.0] * 16
