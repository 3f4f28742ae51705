"""The port stands alone on the card's machine, which has no JAX, flax,
pyyaml or Pillow: no file of diffuscene_tpu_torch/ (nor chip_smoke.py)
imports them or the JAX package, and none imports Pillow at module level
(it is tried only inside a function, for an image the port's PNG codec
does not read)."""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "diffuscene_tpu")


def _sources():
    root = os.path.join(REPO, "diffuscene_tpu_torch")
    for d, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.relpath(os.path.join(d, f), REPO)
    yield "chip_smoke.py"


def _imported_roots(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", list(_sources()))
def test_port_imports_no_jax_yaml_or_jax_package(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", list(_sources()))
def test_port_imports_no_pillow_at_module_level(path):
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), filename=path)
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    roots = {a.name.split(".")[0] for n in top if isinstance(n, ast.Import) for a in n.names}
    roots |= {n.module.split(".")[0] for n in top
              if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module}
    assert "PIL" not in roots, f"{path} imports PIL at module level"


def test_port_sources_found():
    paths = list(_sources())
    for module in ("ops/fused_level.py", "ops/build.py", "ops/chamfer.py", "ops/knn.py",
                   "ops/fused_resblock.py", "ops/attention.py", "models/inference.py",
                   "models/autoencoder.py", "train/optim.py", "train/ae_trainer.py",
                   "utils/checkpoint.py", "utils/config.py", "data/threed_future.py",
                   "data/raw.py", "cli/train_objautoencoder.py",
                   "cli/generate_objautoencoder.py", "ops/iou3d.py", "train/trainer.py",
                   "data/splits.py", "data/encoding.py", "data/threed_front.py",
                   "data/filters.py", "data/loader.py", "data/factory.py", "data/synthetic.py",
                   "eval/postprocess.py", "eval/metrics.py", "cli/train_diffusion.py",
                   "cli/generate_diffusion.py", "data/text.py", "cli/completion_rearrange.py",
                   "cli/_scene_output.py", "cli/compute_fid_scores.py",
                   "cli/improved_precision_recall.py", "eval/png.py", "eval/render.py",
                   "eval/retrieval.py", "eval/mesh_intersect.py", "eval/backbones.py",
                   "eval/fid.py", "eval/ipr.py", "models/feature_extractors.py",
                   "utils/image.py", "data/utils_io.py", "cli/preprocess_data.py",
                   "cli/pickle_threed_future_dataset.py",
                   "cli/pickle_threed_future_pointcloud.py", "utils/profiling.py",
                   "utils/export.py", "models/factory.py", "native/__init__.py",
                   "parallel/__init__.py", "parallel/distributed.py", "parallel/mesh.py",
                   "parallel/sampler.py", "parallel/tp.py", "utils/graphs.py",
                   "cli/eval_protocol.py"):
        assert f"diffuscene_tpu_torch/{module}" in paths, module
    assert len(paths) >= 73


# the raw-data pipeline and the room-mask path compute the same with or
# without Pillow, so they import it nowhere, not even inside a function
PILLOW_FREE = ("data/raw.py", "data/threed_front.py", "data/synthetic.py", "data/utils_io.py",
               "utils/image.py", "models/feature_extractors.py", "cli/preprocess_data.py",
               "cli/pickle_threed_future_dataset.py", "cli/pickle_threed_future_pointcloud.py",
               "native/__init__.py")


@pytest.mark.parametrize("module", PILLOW_FREE)
def test_data_pipeline_imports_no_pillow(module):
    roots = set(_imported_roots(os.path.join("diffuscene_tpu_torch", module)))
    assert "PIL" not in roots, f"{module} imports PIL"
