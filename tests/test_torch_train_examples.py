"""The port's two training examples, run on the CPU in a subprocess
(``--device cpu``): ``examples/torch_train_lm.py`` (the small LM trained,
checkpointed and resumed) and ``examples/torch_sasrec_retrieval.py`` (the
paper's integration: SASRec trained 40 steps, its item embeddings in a
streaming FreshDiskANN).

The retrieval example's bound: the reference example
(``examples/sasrec_retrieval.py``) prints an ANN-vs-exact top-10 overlap
of 0.93 on the CPU; the port draws its SASRec weights with torch, not
``jax.random``, so its overlap must lie within 0.05 below that (0.88),
and no retired item may be returned.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _example(name, *args):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    out = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                          "--device", "cpu", *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_torch_train_lm_example(tmp_path):
    """``--small`` for 40 steps: the loss falls ("improved"); run again
    with the same checkpoint directory to 50 steps, it resumes from the
    step-40 checkpoint."""
    ck = str(tmp_path / "ck")
    out = _example("torch_train_lm.py", "--small", "--steps", "40",
                   "--ckpt-dir", ck)
    m = re.search(r"loss ([0-9.]+) -> ([0-9.]+) \(improved\)", out)
    assert m and float(m.group(2)) < float(m.group(1)), out
    out = _example("torch_train_lm.py", "--small", "--steps", "50",
                   "--ckpt-dir", ck)
    assert "restored checkpoint at step 40 onto cpu" in out
    assert "[loop] step 50 " in out


def test_torch_sasrec_retrieval_example():
    out = _example("torch_sasrec_retrieval.py")
    assert "[sasrec] trained 40 steps" in out
    assert "+64 new items, -64 retired (live size 511)" in out
    assert "retired items absent from results: True" in out
    overlap = float(re.search(r"top-10 overlap: ([0-9.]+)", out).group(1))
    assert overlap >= 0.88
