"""The port runs without JAX and without the reference package.

In a fresh interpreter where ``import jax`` and ``import repro`` fail
(``sys.modules`` entries set to None), every module of ``repro_torch``
imports (the serving, distributed, launch, data, models and configs
subpackages named, the LM modules and configs among them, and GraphSAGE
and the training stack: ``models.gnn``, ``optim``, ``training``,
``launch.train``, ``configs.graphsage_reddit``; the model-sharding
modules ``distributed.sharding``, ``distributed.ctx`` and
``optim.compress``, each driven once over a ``[cpu] * 4`` mesh),
``chip_smoke.py``, the port's four examples
(``examples/torch_quickstart.py``, ``examples/torch_serve_ann.py``,
``examples/torch_train_lm.py``, ``examples/torch_sasrec_retrieval.py``)
and the probe scripts import as modules (without running ``main``),
and a snapshot written by the reference -- whose pickles name the
reference's classes -- loads into the port and serves the reference's
results.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_BLOCK = """
import sys
for name in ("jax", "jaxlib", "repro"):
    sys.modules[name] = None
"""


def _run(code: str) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", _BLOCK + code], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_port_and_chip_smoke_import_without_jax_or_reference():
    out = _run("""
import importlib, importlib.util, pkgutil
import torch
torch.set_num_threads(1)
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
for path in ("chip_smoke.py", "examples/torch_quickstart.py",
             "examples/torch_serve_ann.py", "examples/torch_train_lm.py",
             "examples/torch_sasrec_retrieval.py",
             "scripts/torch_lm_probe.py", "scripts/torch_train_probe.py",
             "scripts/torch_lm_parity_probe.py"):
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.main)
from repro_torch.distributed import (activation_sharding, gathered,
                                     host_mesh, shard_act, shard_tree)
from repro_torch.optim import bf16_all_reduce, int8_all_gather_reduce
mesh = host_mesh(model=2, devices=["cpu"] * 4)
tree = shard_tree(mesh, {"w": torch.ones(4, 6)}, lambda p, x: ("data",))
with activation_sharding(mesh):
    assert shard_act(gathered(tree["w"]), "batch").shape == (4, 6)
assert bf16_all_reduce([tree, tree])["w"].blocks[0].shape == (2, 6)
assert not any(k == "jax" or k.startswith(("jax.", "repro."))
               for k in sys.modules if sys.modules[k] is not None)
print(" ".join(names))
""")
    names = set(out.split())
    assert len(names) >= 40
    for sub in ("serving", "distributed", "launch", "data", "models",
                "configs"):
        assert f"repro_torch.{sub}" in names
    for mod in ("serving.steps", "serving.scheduler", "serving.replica",
                "distributed.sharding", "distributed.ctx",
                "launch.ann_steps", "launch.serve", "data.pipelines",
                "core.autotune", "models.recsys", "models.layers",
                "models.moe", "models.transformer", "configs.common",
                "configs.fm", "configs.deepfm", "configs.xdeepfm",
                "configs.sasrec", "configs.freshdiskann_1b",
                "configs.qwen3_14b", "configs.qwen2_1_5b",
                "configs.gemma3_12b", "configs.mixtral_8x7b",
                "configs.qwen3_moe_30b", "models.gnn", "optim",
                "optim.adamw", "optim.compress", "training",
                "training.steps",
                "training.loop", "launch.train", "checkpoint.store", "tree",
                "configs.graphsage_reddit"):
        assert f"repro_torch.{mod}" in names


def test_reference_snapshot_loads_without_the_reference(tmp_path):
    """The reference writes a snapshot (a layout, RO and RW tiers, a
    DeleteList); the port, with JAX and the reference unimportable, loads
    it and returns the reference's search results."""
    import jax.numpy as jnp  # noqa: F401  (the reference needs JAX)
    from repro.core import config as jconfig
    from repro.core import system as jsystem

    g = np.random.default_rng(4)
    d = 16
    base = g.integers(-3, 4, (150, d)).astype(np.float32)
    new = g.integers(-3, 4, (60, d)).astype(np.float32)
    qs = g.integers(-3, 4, (6, d)).astype(np.float32)

    def cfg(mod, root):
        return mod.SystemConfig(
            index=mod.IndexConfig(capacity=256, dim=d, R=8, L_build=16,
                                  L_search=24, alpha=1.2),
            pq=mod.PQConfig(dim=d, m=4, ksub=16, kmeans_iters=3),
            ro_snapshot_points=32, temp_capacity=64, insert_batch=16,
            storage_dir=str(root / "store"))

    ref = jsystem.bootstrap_system(base, np.arange(150),
                                   cfg(jconfig, tmp_path / "ref"), batch=32)
    for i in range(60):
        ref.insert(1000 + i, new[i])
    for e in (3, 1010):
        ref.delete(e)
    ref.save(str(tmp_path / "snap"))
    want_ids, want_d = ref.search_batch(qs, k=5)
    ref.close_storage()
    np.save(tmp_path / "qs.npy", qs)
    out = _run(f"""
import json
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.core import config as tconfig
from repro_torch.core.system import FreshDiskANN
cfg = tconfig.SystemConfig(
    index=tconfig.IndexConfig(capacity=256, dim={d}, R=8, L_build=16,
                              L_search=24, alpha=1.2),
    pq=tconfig.PQConfig(dim={d}, m=4, ksub=16, kmeans_iters=3),
    ro_snapshot_points=32, temp_capacity=64, insert_batch=16)
s = FreshDiskANN.load({str(tmp_path / "snap")!r}, cfg, device="cpu")
ids, dd = s.search_batch(np.load({str(tmp_path / "qs.npy")!r}), k=5)
print(json.dumps({{"size": s.size, "ro": len(s.ro),
                  "deleted": sorted(s.deleted_ext), "ids": ids.tolist(),
                  "d": dd.tolist()}}))
""")
    got = json.loads(out.strip().splitlines()[-1])
    assert got["size"] == ref.size and got["ro"] == len(ref.ro) > 0
    assert got["deleted"] == sorted(ref.deleted_ext)
    np.testing.assert_array_equal(np.array(got["ids"]), want_ids)
    np.testing.assert_array_equal(np.array(got["d"], np.float32), want_d)
