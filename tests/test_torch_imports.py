"""The port stands alone: no module of it imports JAX, the JAX package or
Pillow.

``test_no_jax_imports`` walks the syntax tree of every module of
``focalformer3d_tpu_torch/`` (imports inside functions included) and
fails on any import of ``jax``, ``jaxlib``, ``flax``, ``optax``,
``orbax``, ``focalformer3d_tpu`` or ``PIL`` (the card's machine has no
Pillow: the port decodes and resamples the cameras itself,
``data/image_io.py``). The port's copy
of the reference checkpoint's key inventory and key mapping
(``utils/jax_keys.py``) is held here against the JAX package's originals,
for the LiDAR, camera and Waymo configs: the same keys, shapes and flax
paths, and transforms that rearrange an index array the same way.
"""
import ast
import pathlib

import numpy as np
import pytest

from focalformer3d_tpu.configs import get_config as jax_get_config
from focalformer3d_tpu.utils import convert as jconvert
from focalformer3d_tpu.utils import ref_keys as jref_keys
from focalformer3d_tpu_torch import configs as tconfigs
from focalformer3d_tpu_torch.utils import jax_keys

REPO = pathlib.Path(__file__).resolve().parent.parent
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "focalformer3d_tpu",
          "PIL")


def _port_files():
    return sorted((REPO / "focalformer3d_tpu_torch").rglob("*.py"))


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


def test_no_jax_imports():
    files = _port_files()
    assert len(files) > 20
    bad = []
    for f in files:
        tree = ast.parse(f.read_text(), filename=str(f))
        bad += [f"{f.relative_to(REPO)}:{line} imports {root}"
                for line, root in _imported_roots(tree) if root in BANNED]
    assert not bad, bad


def test_walk_covers_the_entry_points_and_training_modules():
    files = {str(f.relative_to(REPO)) for f in _port_files()}
    pkg = "focalformer3d_tpu_torch/"
    for mod in ("tools/train.py", "tools/benchmark.py", "training/loop.py",
                "training/checkpoint.py", "training/train_step.py",
                "training/optim.py", "data/prefetch.py", "utils/profiler.py",
                "configs.py"):
        assert pkg + mod in files, mod


def test_guard_sees_nested_imports():
    src = ("def f():\n    from focalformer3d_tpu.ops import x\n"
           "    import jax.numpy as jnp\n"
           "    importlib.import_module('flax.linen')\n")
    roots = [r for _, r in _imported_roots(ast.parse(src))]
    assert roots == ["focalformer3d_tpu", "jax", "flax"]


def test_walk_covers_the_camera_data_layer():
    files = {str(f.relative_to(REPO)) for f in _port_files()}
    pkg = "focalformer3d_tpu_torch/"
    for mod in ("data/image_io.py", "data/native/__init__.py",
                "data/transforms.py", "data/nuscenes.py", "data/pipelines.py",
                "data/synthetic.py", "data/synthetic_dirs.py"):
        assert pkg + mod in files, mod
    roots = [r for _, r in _imported_roots(ast.parse(
        "def f():\n    from PIL import Image\n"))]
    assert roots == ["PIL"] and "PIL" in BANNED


def test_walk_covers_the_tta_and_checkpoint_modules():
    files = {str(f.relative_to(REPO)) for f in _port_files()}
    pkg = "focalformer3d_tpu_torch/"
    for mod in ("core/boxes.py", "core/merge_augs.py", "core/nms.py",
                "tools/convert_checkpoint.py",
                "tools/make_fake_checkpoint.py"):
        assert pkg + mod in files, mod


def test_walk_covers_the_camera_modules():
    files = {str(f.relative_to(REPO)) for f in _port_files()}
    pkg = "focalformer3d_tpu_torch/"
    for mod in ("ops/scatter.py", "ops/local_attn.py", "models/resnet.py",
                "models/lss.py", "models/grid_mask.py", "models/i2p.py",
                "models/focal_encoder.py", "utils/jax_keys.py"):
        assert pkg + mod in files, mod


def test_walk_covers_the_waymo_modules():
    files = {str(f.relative_to(REPO)) for f in _port_files()}
    pkg = "focalformer3d_tpu_torch/"
    for mod in ("models/vfe.py", "data/waymo.py", "core/eval_waymo.py",
                "ops/voxelize.py", "models/focal_decoder.py"):
        assert pkg + mod in files, mod


def test_walk_covers_the_data_parallel_modules():
    files = {str(f.relative_to(REPO)) for f in _port_files()}
    pkg = "focalformer3d_tpu_torch/"
    for mod in ("parallel/__init__.py", "parallel/mesh.py",
                "tools/dryrun_ddp.py", "ops/points_in_boxes.py"):
        assert pkg + mod in files, mod


# FocalFormer3D_Waymo15_L's class-aware heads are wider than JAX's inventory
# lists them (tests/test_torch_waymo_model.py)
@pytest.mark.parametrize("name", ["Tiny_L", "FocalFormer3D_L",
                                  "DeformFormer3D_L", "FocalFormer3D_LC",
                                  "FocalFormer3D_LC_Proj",
                                  "DeformFormer3D_C_R50",
                                  "FocalFormer3D_Waymo_L", "Tiny_Waymo_L",
                                  "DeformFormer3D_Waymo_L",
                                  "DeformFormer3D_Waymo15_L"])
def test_jax_keys_match_the_jax_package(name):
    jcfg = jax_get_config(name)["model"]
    tcfg = tconfigs.get_config(name)["model"]
    shapes = jref_keys.reference_state_shapes(jcfg)
    got_shapes = jax_keys.reference_state_shapes(tcfg)
    assert list(got_shapes.items()) == list(shapes.items())

    ref = jconvert.build_mapping(shapes)
    got = jax_keys.build_mapping(shapes)
    assert list(got) == list(ref)
    for key, targets in ref.items():
        assert len(got[key]) == len(targets), key
        idx = np.arange(int(np.prod(shapes[key], dtype=np.int64))).reshape(
            shapes[key])
        for (coll, path, tf), (gcoll, gpath, gtf) in zip(targets, got[key]):
            assert (gcoll, gpath) == (coll, path), key
            assert (gtf is None) == (tf is None), key
            if tf is not None:
                np.testing.assert_array_equal(gtf(idx), tf(idx), err_msg=key)


def test_walk_covers_the_analysis_tools():
    files = {str(f.relative_to(REPO)) for f in _port_files()}
    pkg = "focalformer3d_tpu_torch/"
    for mod in ("tools/get_flops.py", "tools/analyze_logs.py",
                "tools/browse_dataset.py", "utils/png.py"):
        assert pkg + mod in files, mod
