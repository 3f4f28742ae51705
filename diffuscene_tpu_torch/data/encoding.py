"""Host-side encoding pipeline: raw cached rooms -> fixed-shape training arrays.

Copy of ``diffuscene_tpu/data/encoding.py`` (numpy only), so the port does
not import the JAX package.  The ``text`` / ``textfix`` encodings run the
port's ``data/text.py`` on the pipeline's own generator, after the
augmentations and before scaling, as the JAX pipeline does.

Functional re-design of the reference decorator stack
(`scene_synthesis/datasets/threed_front_dataset.py:228-1072`).  Instead of a
chain of decorator Dataset classes, each encoding step is a pure numpy
function over a per-sample dict; `build_encoding` composes them from the same
`encoding_type` string micro-DSL the reference uses
(threed_front_dataset.py:942-1072), so reference configs work unchanged.

All outputs are padded to ``max_length`` with the "end"/empty one-hot so every
batch is a fixed-shape (B, N, C) tensor — nothing ragged reaches the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

Sample = Dict[str, np.ndarray]


@dataclasses.dataclass
class Bounds:
    """Train-set normalization bounds (dataset_stats.txt fields).

    Mirrors CachedThreedFront._parse_train_stats (threed_front.py:383-415).
    """

    translations: tuple  # (min(3,), max(3,))
    sizes: tuple
    angles: tuple  # (min, max) scalars
    objfeats: tuple = (np.array([1.0]), np.array([-1.0]), np.array([1.0]))  # (std, min, max)
    objfeats_32: tuple = (np.array([1.0]), np.array([-1.0]), np.array([1.0]))

    @classmethod
    def from_train_stats(cls, stats: Dict) -> "Bounds":
        t = np.asarray(stats["bounds_translations"], np.float64)
        s = np.asarray(stats["bounds_sizes"], np.float64)
        a = np.asarray(stats["bounds_angles"], np.float64)
        kw = {}
        if "bounds_objfeats" in stats:
            o = np.asarray(stats["bounds_objfeats"], np.float64)
            kw["objfeats"] = (np.array([o[0]]), np.array([o[1]]), np.array([o[2]]))
        if "bounds_objfeats_32" in stats:
            o = np.asarray(stats["bounds_objfeats_32"], np.float64)
            kw["objfeats_32"] = (np.array([o[0]]), np.array([o[1]]), np.array([o[2]]))
        return cls(
            translations=(t[:3], t[3:]),
            sizes=(s[:3], s[3:]),
            angles=(np.asarray(a[0]), np.asarray(a[1])),
            **kw,
        )

    def as_device_bounds(self) -> Dict[str, np.ndarray]:
        """Bounds dict consumed by the IoU loss (diffusion_ddpm.py:137-152)."""
        return {
            "translations_min": np.asarray(self.translations[0], np.float32),
            "translations_max": np.asarray(self.translations[1], np.float32),
            "sizes_min": np.asarray(self.sizes[0], np.float32),
            "sizes_max": np.asarray(self.sizes[1], np.float32),
        }


# ---------------------------------------------------------------------------
# elementary transforms
# ---------------------------------------------------------------------------

def scale(x: np.ndarray, minimum, maximum) -> np.ndarray:
    """min/max -> [-1, 1] (threed_front_dataset.py:377-382)."""
    x = np.clip(x.astype(np.float32), minimum, maximum)
    x = (x - minimum) / (maximum - minimum)
    return 2.0 * x - 1.0


def descale(x: np.ndarray, minimum, maximum) -> np.ndarray:
    x = (x + 1.0) / 2.0
    return x * (maximum - minimum) + minimum


def rotation_matrix_around_y(theta: float) -> np.ndarray:
    R = np.zeros((3, 3))
    R[0, 0] = np.cos(theta)
    R[0, 2] = -np.sin(theta)
    R[2, 0] = np.sin(theta)
    R[2, 2] = np.cos(theta)
    R[1, 1] = 1.0
    return R


def apply_rotation(sample: Sample, rot_angle: float, angle_bounds) -> Sample:
    """Rotate the scene around +y (threed_front_dataset.py:348-371)."""
    out = dict(sample)
    R = rotation_matrix_around_y(rot_angle)
    angle_min = np.asarray(angle_bounds[0])
    if "translations" in out:
        out["translations"] = out["translations"].dot(R).astype(np.float32)
    if "angles" in out:
        out["angles"] = ((out["angles"] + rot_angle - angle_min) % (2 * np.pi) + angle_min).astype(np.float32)
    if "room_layout" in out:
        from scipy.ndimage import rotate as nd_rotate

        img = np.transpose(out["room_layout"], (1, 2, 0))
        out["room_layout"] = np.transpose(
            nd_rotate(img, rot_angle * 180 / np.pi, reshape=False), (2, 0, 1)
        ).astype(np.float32)
    return out


def random_rotation_angle(rng: np.random.Generator, fixed: bool,
                          min_rad=0.174533, max_rad=5.06145) -> float:
    """(threed_front_dataset.py:330-346).  ``fixed`` draws from 90-degree steps.

    The reference ``fixed_rot_angle`` property re-draws ``np.random.rand()``
    at every elif (threed_front_dataset.py:338-346), so the four angles are
    NOT uniform: P(1.5pi)=0.25, P(pi)=0.75*0.5=0.375, P(0.5pi)=0.28125,
    P(0)=0.09375.  Reproduced here with a single draw against the
    cascade-equivalent cumulative thresholds.
    """
    if fixed:
        u = rng.random()
        if u < 0.25:
            return np.pi * 1.5
        elif u < 0.625:
            return np.pi
        elif u < 0.90625:
            return np.pi * 0.5
        return 0.0
    if rng.random() < 0.5:
        return float(rng.uniform(min_rad, max_rad))
    return 0.0


def scale_sample(sample: Sample, bounds: Bounds, cosin_angle: bool,
                 objfeats_norm: bool) -> Sample:
    """Scale/cos-sin/objfeat normalization (threed_front_dataset.py:375-539)."""
    out = dict(sample)
    if "translations" in out:
        out["translations"] = scale(out["translations"], bounds.translations[0], bounds.translations[1])
    if "sizes" in out:
        out["sizes"] = scale(out["sizes"], bounds.sizes[0], bounds.sizes[1])
    if "angles" in out:
        if cosin_angle:
            a = out["angles"]
            out["angles"] = np.concatenate([np.cos(a), np.sin(a)], axis=-1).astype(np.float32)
        else:
            out["angles"] = scale(out["angles"], bounds.angles[0], bounds.angles[1])
    if objfeats_norm:
        # bounds tuple is (std, min, max); scaling uses (min, max) — matches
        # Scale_CosinAngle_ObjfeatsNorm (threed_front_dataset.py:504-507)
        if "objfeats" in out:
            out["objfeats"] = scale(out["objfeats"], bounds.objfeats[1], bounds.objfeats[2])
        if "objfeats_32" in out:
            out["objfeats_32"] = scale(out["objfeats_32"], bounds.objfeats_32[1], bounds.objfeats_32[2])
    return out


def descale_sample(sample: Sample, bounds: Bounds, cosin_angle: bool,
                   objfeats_norm: bool) -> Sample:
    """Inverse of scale_sample over batched (B, N, C) arrays — the
    `post_process` path (threed_front_dataset.py:515-535)."""
    out = {}
    for k, v in sample.items():
        if k in ("room_layout", "class_labels", "relations", "description", "desc_emb",
                 "objectness", "is_empty", "lengths"):
            out[k] = v
        elif k == "angles" and cosin_angle:
            out[k] = np.arctan2(v[..., 1:2], v[..., 0:1])
        elif k == "angles":
            out[k] = descale(v, bounds.angles[0], bounds.angles[1])
        elif k == "translations":
            out[k] = descale(v, bounds.translations[0], bounds.translations[1])
        elif k == "sizes":
            out[k] = descale(v, bounds.sizes[0], bounds.sizes[1])
        elif k == "objfeats" and objfeats_norm:
            out[k] = descale(v, bounds.objfeats[1], bounds.objfeats[2])
        elif k == "objfeats_32" and objfeats_norm:
            out[k] = descale(v, bounds.objfeats_32[1], bounds.objfeats_32[2])
        elif k in ("objfeats", "objfeats_32"):
            # plain Scale.post_process DROPS un-normalized objfeats keys
            # (threed_front_dataset.py:410-411 `continue` while building a
            # new dict) — reproduce, retrieval reads them pre-post_process
            continue
        else:
            out[k] = v
    return out


def permute_objects(sample: Sample, rng: np.random.Generator, keys: Sequence[str]) -> Sample:
    """Random object-order permutation — the set-symmetry augmentation
    (threed_front_dataset.py:570-584)."""
    out = dict(sample)
    n = out["class_labels"].shape[0]
    ordering = rng.permutation(n)
    for k in keys:
        if k in out:
            out[k] = out[k][ordering]
    return out


def order_by_class_frequency(sample: Sample, class_labels: List[str],
                             class_frequencies: Dict[str, float],
                             keys: Sequence[str]) -> Sample:
    """Class-frequency ordering (threed_front_dataset.py:587-616)."""
    out = dict(sample)
    t = out["translations"]
    c = out["class_labels"].argmax(-1)
    f = np.array([[class_frequencies[class_labels[ci]]] for ci in c])
    order = np.lexsort(np.hstack([t, f]).T)[::-1]
    for k in keys:
        if k in out:
            out[k] = out[k][order]
    return out


def jitter_sample(sample: Sample, rng: np.random.Generator) -> Sample:
    """(threed_front_dataset.py:559-567)"""
    out = dict(sample)
    skip = {"room_layout", "class_labels", "relations", "description", "desc_emb",
            "objfeats", "objfeats_32"}
    for k, v in out.items():
        if k not in skip:
            out[k] = v + rng.normal(0, 0.01)
    return out


def diffusion_encode(sample: Sample, max_length: int) -> Sample:
    """Final Diffusion encoding (threed_front_dataset.py:888-925).

    - drop the "start" class channel, keep "end" as the last (empty) channel
    - pad object slots to max_length with the end one-hot
    - map class one-hots to {-1, +1}
    - zero-pad all other attributes
    """
    out = dict(sample)
    out["length"] = np.int32(sample["class_labels"].shape[0])
    for k, v in sample.items():
        if k in ("room_layout", "length", "relations", "description", "desc_emb"):
            continue
        if k == "class_labels":
            cl = np.concatenate([v[:, :-2], v[:, -1:]], axis=-1)
            L, C = cl.shape
            end_label = np.eye(C)[-1]
            out[k] = (
                np.vstack([cl, np.tile(end_label[None, :], [max_length - L, 1])]).astype(np.float32)
                * 2.0
                - 1.0
            )
        else:
            v = np.asarray(v, np.float32)
            L, C = v.shape
            out[k] = np.vstack([v, np.tile(np.zeros(C, np.float32)[None, :], [max_length - L, 1])])
    return out


# ---------------------------------------------------------------------------
# composed pipeline
# ---------------------------------------------------------------------------

PERMUTE_KEYS = ["class_labels", "translations", "sizes", "angles"]

ATTRIBUTE_KEYS = ("class_labels", "translations", "sizes", "angles",
                  "objfeats", "objfeats_32")
_PASSTHROUGH_KEYS = ("room_layout", "length", "relations", "description", "desc_emb")


def autoregressive_encode(sample: Sample) -> Sample:
    """ATISS-style autoregressive targets (threed_front_dataset.py:822-859).

    Appends `<k>_tr` target sequences: class labels get an extra "end"
    one-hot row, all other attributes an extra zero row.
    """
    out = dict(sample)
    target = {}
    for k, v in sample.items():
        if k in _PASSTHROUGH_KEYS:
            continue
        if k == "class_labels":
            end_label = np.eye(v.shape[1])[-1]
            target[k + "_tr"] = np.vstack([np.copy(v), end_label])
        else:
            target[k + "_tr"] = np.vstack([np.copy(v), np.zeros(v.shape[1])])
    out.update(target)
    out["length"] = sample["class_labels"].shape[0]
    return out


def autoregressive_wocm_encode(sample: Sample, rng: np.random.Generator) -> Sample:
    """Autoregressive 'without conditional masking': random prefix as input,
    the next box as the target (threed_front_dataset.py:863-885)."""
    out = autoregressive_encode(sample)
    L = out["class_labels"].shape[0]
    n_boxes = int(rng.integers(0, L + 1))
    for k, v in list(out.items()):
        if k in _PASSTHROUGH_KEYS:
            continue
        if k.endswith("_tr"):
            out[k] = v[n_boxes]
        else:
            out[k] = v[:n_boxes]
    out["length"] = n_boxes
    return out


@dataclasses.dataclass
class EncodingPipeline:
    """Composed per-sample encoding, built from the `encoding_type` string.

    Equivalent of dataset_encoding_factory (threed_front_dataset.py:942-1072)
    for the `cached_diffusion_*` family; autoregressive encodings are provided
    by `AutoregressiveEncoding` for ATISS-parity (see `encoding_autoregressive`).
    """

    bounds: Bounds
    max_length: int
    class_labels: List[str]
    class_frequencies: Dict[str, float]
    cosin_angle: bool = True
    objfeats_norm: bool = True
    use_objfeats: bool = True
    lat32: bool = True
    permute: bool = True
    augmentations: Sequence[str] = ()
    add_text: bool = False
    text_eval: bool = False
    text_emb_dim: int = 50   # 50 GloVe-style | 768 BERT-style | 512 CLIP
    glove_path: Optional[str] = None
    box_ordering: Optional[str] = None
    eval_mode: bool = False  # "eval" in name: stop after scaling
    mode: str = "diffusion"  # "diffusion" | "autoregressive" | "autoregressive_wocm"
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self.permute_keys = list(PERMUTE_KEYS)
        if self.use_objfeats:
            self.permute_keys.append("objfeats_32" if self.lat32 else "objfeats")
        self._text_encoder = None
        if self.add_text:
            from .text import TextDescriptionGenerator

            self._text_encoder = TextDescriptionGenerator(
                self.class_labels, eval=self.text_eval,
                emb_dim=self.text_emb_dim, glove_path=self.glove_path,
            )

    def reseed(self, seed: int):
        self._rng = np.random.default_rng(seed)

    def __call__(self, raw: Sample) -> Sample:
        s = dict(raw)
        if self.box_ordering == "class_frequencies":
            s = order_by_class_frequency(
                s, self.class_labels, self.class_frequencies, self.permute_keys
            )
        for aug in self.augmentations:
            if aug == "rotations":
                ang = random_rotation_angle(self._rng, fixed=False)
                s = apply_rotation(s, ang, self.bounds.angles)
            elif aug == "fixed_rotations":
                ang = random_rotation_angle(self._rng, fixed=True)
                s = apply_rotation(s, ang, self.bounds.angles)
            elif aug == "jitter":
                s = jitter_sample(s, self._rng)
        if self._text_encoder is not None:
            s = self._text_encoder(s, self._rng)
        s = scale_sample(s, self.bounds, self.cosin_angle, self.objfeats_norm)
        if self.eval_mode:
            return s
        if self.permute:
            s = permute_objects(s, self._rng, self.permute_keys)
        if self.mode == "autoregressive":
            return autoregressive_encode(s)
        if self.mode == "autoregressive_wocm":
            return autoregressive_wocm_encode(s, self._rng)
        return diffusion_encode(s, self.max_length)

    def post_process(self, batch: Sample) -> Sample:
        return descale_sample(batch, self.bounds, self.cosin_angle, self.objfeats_norm)


def build_encoding(
    name: str,
    bounds: Bounds,
    max_length: int,
    class_labels: List[str],
    class_frequencies: Dict[str, float],
    augmentations: Sequence[str] = (),
    box_ordering: Optional[str] = None,
    text_emb_dim: int = 50,
    glove_path: Optional[str] = None,
    seed: int = 0,
) -> EncodingPipeline:
    """Parse the reference `encoding_type` micro-DSL into a pipeline.

    Recognized tokens (threed_front_dataset.py:942-1072): cached, diffusion,
    autoregressive, text / textfix, cosin_angle, objfeatsnorm, objfeats,
    lat32, wocm, no_prm, eval.

    Note the reference's 'wocm' token means different things per family: for
    diffusion encodings it is part of the canonical name (no behavior), for
    autoregressive encodings it selects the random-prefix WOCM targets
    (threed_front_dataset.py:863-885) — reproduced here.
    """
    if "autoregressive" in name:
        mode = "autoregressive_wocm" if "wocm" in name else "autoregressive"
    elif "diffusion" in name:
        mode = "diffusion"
    else:
        raise NotImplementedError(f"encoding '{name}'")
    # the reference factory picks Scale_CosinAngle_ObjfeatsNorm whenever
    # EITHER token appears (threed_front_dataset.py:1027-1029 `or`), and that
    # class both cos/sins the angles AND min/max-normalizes objfeats — the
    # two behaviors are coupled, never independent
    cosin_or_norm = "cosin_angle" in name or "objfeatsnorm" in name
    return EncodingPipeline(
        mode=mode,
        bounds=bounds,
        max_length=max_length,
        class_labels=class_labels,
        class_frequencies=class_frequencies,
        cosin_angle=cosin_or_norm,
        objfeats_norm=cosin_or_norm,
        # permute-key selection keys off the literal "objfeats" token
        # (threed_front_dataset.py:1038; "objfeatsnorm" also contains it)
        use_objfeats="objfeats" in name,
        lat32="lat32" in name,
        permute="no_prm" not in name and "eval" not in name,
        augmentations=augmentations,
        add_text="text" in name,
        text_eval="textfix" in name,
        text_emb_dim=text_emb_dim,
        glove_path=glove_path,
        box_ordering=box_ordering,
        eval_mode="eval" in name,
        seed=seed,
    )
