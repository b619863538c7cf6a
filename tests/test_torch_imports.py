"""The port imports torch, never jax, and nothing of the JAX package."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _is_jax_package(name: str) -> bool:
    # motionbert_tpu_torch starts with "motionbert_tpu": match the module
    # name itself or its submodules, not the prefix. The repo's tools/ import
    # the JAX package, so the port keeps away from them too.
    return name in ("jax", "motionbert_tpu", "tools") or name.startswith(
        ("jax.", "jaxlib", "flax", "optax", "motionbert_tpu.", "tools."))


def test_port_imports_no_jax():
    code = (
        "import sys, json\n"
        "import motionbert_tpu_torch, motionbert_tpu_torch.api, "
        "motionbert_tpu_torch.serve\n"
        "import motionbert_tpu_torch.ops.fused_pair, "
        "motionbert_tpu_torch.core.checkpoint\n"
        "import motionbert_tpu_torch.train.pose3d, "
        "motionbert_tpu_torch.train.state, motionbert_tpu_torch.losses.pose, "
        "motionbert_tpu_torch.data.readers, motionbert_tpu_torch.data.datasets, "
        "motionbert_tpu_torch.geometry.transforms, "
        "motionbert_tpu_torch.geometry.procrustes, "
        "motionbert_tpu_torch.core.metrics, motionbert_tpu_torch.core.logging\n"
        "import motionbert_tpu_torch.ops.pair_q8, "
        "motionbert_tpu_torch.data.dataset_wild, "
        "motionbert_tpu_torch.infer.wild_pose\n"
        "import motionbert_tpu_torch.ops.attention, "
        "motionbert_tpu_torch.ops.fused_mlp, "
        "motionbert_tpu_torch.data.augment, "
        "motionbert_tpu_torch.geometry.skeleton\n"
        "import motionbert_tpu_torch.models.action_heads, "
        "motionbert_tpu_torch.data.dataset_action, "
        "motionbert_tpu_torch.data.clipstore, "
        "motionbert_tpu_torch.losses.supcon, "
        "motionbert_tpu_torch.train.action, "
        "motionbert_tpu_torch.train.action_1shot\n"
        "import motionbert_tpu_torch.ops.fused_stream, "
        "motionbert_tpu_torch.geometry.rotations, "
        "motionbert_tpu_torch.models.smpl, "
        "motionbert_tpu_torch.models.mesh_head, "
        "motionbert_tpu_torch.losses.mesh, "
        "motionbert_tpu_torch.data.dataset_mesh, "
        "motionbert_tpu_torch.train.mesh, "
        "motionbert_tpu_torch.infer.wild_mesh\n"
        "import motionbert_tpu_torch.parallel.mesh, "
        "motionbert_tpu_torch.viz.render, motionbert_tpu_torch.infer, "
        "motionbert_tpu_torch.data.amass\n"
        "import motionbert_tpu_torch.train.anchor, "
        "motionbert_tpu_torch.data.synthetic\n"
        "import runpy; runpy.run_module('motionbert_tpu_torch.train.pose3d', "
        "run_name='not_main')\n"
        "runpy.run_module('motionbert_tpu_torch.train.action', "
        "run_name='not_main')\n"
        "runpy.run_module('motionbert_tpu_torch.train.action_1shot', "
        "run_name='not_main')\n"
        "runpy.run_module('motionbert_tpu_torch.infer.wild_pose', "
        "run_name='not_main')\n"
        "runpy.run_module('motionbert_tpu_torch.train.mesh', "
        "run_name='not_main')\n"
        "runpy.run_module('motionbert_tpu_torch.infer.wild_mesh', "
        "run_name='not_main')\n"
        "runpy.run_module('motionbert_tpu_torch.train.anchor', "
        "run_name='not_main')\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    import json

    mods = json.loads(out.stdout.strip().splitlines()[-1])
    for m in ("motionbert_tpu_torch.api", "motionbert_tpu_torch.train.pose3d",
              "motionbert_tpu_torch.data.datasets",
              "motionbert_tpu_torch.losses.pose",
              "motionbert_tpu_torch.ops.pair_q8",
              "motionbert_tpu_torch.data.dataset_wild",
              "motionbert_tpu_torch.infer.wild_pose",
              "motionbert_tpu_torch.ops.attention",
              "motionbert_tpu_torch.ops.fused_mlp",
              "motionbert_tpu_torch.data.augment",
              "motionbert_tpu_torch.models.action_heads",
              "motionbert_tpu_torch.data.dataset_action",
              "motionbert_tpu_torch.data.clipstore",
              "motionbert_tpu_torch.losses.supcon",
              "motionbert_tpu_torch.train.action",
              "motionbert_tpu_torch.train.action_1shot",
              "motionbert_tpu_torch.ops.fused_stream",
              "motionbert_tpu_torch.models.smpl",
              "motionbert_tpu_torch.models.mesh_head",
              "motionbert_tpu_torch.losses.mesh",
              "motionbert_tpu_torch.data.dataset_mesh",
              "motionbert_tpu_torch.train.mesh",
              "motionbert_tpu_torch.infer.wild_mesh",
              "motionbert_tpu_torch.parallel.mesh",
              "motionbert_tpu_torch.viz.render",
              "motionbert_tpu_torch.infer",
              "motionbert_tpu_torch.data.amass",
              "motionbert_tpu_torch.train.anchor",
              "motionbert_tpu_torch.data.synthetic"):
        assert m in mods, m
    bad = [m for m in mods if _is_jax_package(m)]
    assert not bad, bad


def _imported_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_sources_and_chip_smoke_import_no_jax():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "motionbert_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for path in files:
        bad = [m for m in _imported_names(path) if _is_jax_package(m)]
        assert not bad, (path, bad)


def test_name_check_tells_the_packages_apart():
    assert _is_jax_package("motionbert_tpu")
    assert _is_jax_package("motionbert_tpu.ops.fused_pair")
    assert _is_jax_package("jax.numpy")
    assert not _is_jax_package("motionbert_tpu_torch")
    assert not _is_jax_package("motionbert_tpu_torch.ops")
    assert _is_jax_package("tools.make_synthetic_data")
    assert not _is_jax_package("toolshed")
