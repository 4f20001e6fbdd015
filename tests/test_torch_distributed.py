"""The freshdiskann-1b shard deployment and the sharded serving step against
the reference on 4 devices.

One subprocess runs the reference with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (the device census
is fixed when JAX starts, as in ``tests/test_serving.py``) and writes its
inputs and results to an ``.npz``:

* ``make_distributed_search``, ``make_distributed_insert`` and
  ``make_distributed_merge`` over 4 integer-coordinate sub-indices in the
  stacked layout, a search after each update;
* ``make_sharded_unified_step`` on a 4-device mesh over a live system (LTI,
  two RO tiers and the RW tier, deletes in each), beside the system's
  unsharded ``unified_search``;
* ``launch.serve.main`` at a tiny size.

The port runs the same inputs on a CPU group of 4 shards (every shard the
host, ``distributed.sharding``): the LTI after each step, every search (one
at k 129, past ``block_topk``'s 128) and the sharded step's ids, dists,
hops and cmps must equal the reference's bit for bit.  The driver's run is
Gaussian; the port takes the codebook the reference trained there, and its
counts must be equal and its recall within 0.01 (1 of its 160 hits).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread per test process: the suite runs in several
# processes at once, and torch's default of one thread per core makes them
# contend for the cores.
torch.set_num_threads(1)

from repro_torch import convert  # noqa: E402
from repro_torch.core import pq as tpq  # noqa: E402
from repro_torch.core.config import IndexConfig, PQConfig, SystemConfig  # noqa: E402
from repro_torch.core.system import FreshDiskANN  # noqa: E402
from repro_torch.distributed.sharding import data_mesh  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.ann_steps import (make_distributed_insert,  # noqa: E402
                                          make_distributed_merge,
                                          make_distributed_search)
from repro_torch.serving.steps import make_sharded_unified_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
D, CAP, N = 16, 128, 96
F = ("vectors", "adjacency", "active", "deleted", "start", "n_total")
SERVE_ARGS = ["--points", "256", "--dim", "16", "--updates", "256",
              "--searches", "2"]
# A search wider than block_topk's k <= 128: the merge takes a stable sort.
K_WIDE, L_WIDE = 129, 160

_REFERENCE = r"""
import contextlib, io, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core import pq as pqm
from repro.core import index as mem
from repro.core.config import IndexConfig, PQConfig, SystemConfig
from repro.core.graph import GraphState, LaneStack, shard_lti
from repro.core.index import build
from repro.core.lti import LTIState
from repro.core.system import FreshDiskANN
from repro.launch.ann_steps import (make_distributed_insert,
                                    make_distributed_merge,
                                    make_distributed_search)
from repro.serving.steps import make_sharded_unified_step

assert len(jax.devices()) == 4
D, CAP, N = %(D)d, %(CAP)d, %(N)d
g = np.random.default_rng(5)
cfg = IndexConfig(capacity=CAP, dim=D, R=8, L_build=16, L_search=24,
                  alpha=1.2, beam_width=2)
pq = PQConfig(dim=D, m=4, ksub=16, kmeans_iters=3)
cent = g.integers(-3, 4, (4, 16, 4)).astype(np.float32)
cb = pqm.PQCodebook(jnp.asarray(cent))
pts = g.integers(-3, 4, (4, N, D)).astype(np.float32)
res = {"cent": cent}

def dump(prefix, lti):
    for f in GraphState._fields:
        res[f"{prefix}_{f}"] = np.asarray(getattr(lti.graph, f))
    res[f"{prefix}_codes"] = np.asarray(lti.codes)

graphs = [build(pts[s], cfg, batch=32, seed=s) for s in range(4)]
codes = [jnp.zeros((CAP, pq.m), jnp.uint8).at[:N].set(
    pqm.encode(cb, jnp.asarray(pts[s]), pq)) for s in range(4)]
cat = lambda f: jnp.concatenate([getattr(x, f) for x in graphs])
lti = LTIState(GraphState(cat("vectors"), cat("adjacency"), cat("active"),
                          cat("deleted"),
                          jnp.stack([x.start for x in graphs]),
                          jnp.stack([x.n_total for x in graphs])),
               jnp.concatenate(codes), cb)
dump("lti0", lti)
mesh = Mesh(np.asarray(jax.devices()), ("data",))
qs = g.integers(-3, 4, (12, D)).astype(np.float32)
res["qs"] = qs
search = make_distributed_search(mesh, cfg, k=5)
res["s0_ids"], res["s0_d"] = map(np.asarray, search(lti, jnp.asarray(qs)))
res["ins_new"] = g.integers(-3, 4, (24, D)).astype(np.float32)
lti = make_distributed_insert(mesh, cfg, per_shard=8)(
    lti, jnp.asarray(res["ins_new"]))
dump("lti1", lti)
res["s1_ids"], res["s1_d"] = map(np.asarray, search(lti, jnp.asarray(qs)))
res["m_new"] = g.integers(-3, 4, (16, D)).astype(np.float32)
res["m_valid"] = g.random(16) > 0.2
dmask = np.zeros(4 * CAP, bool)
dmask[(np.arange(4) * CAP)[:, None] + g.choice(N, (4, 3))] = True
res["m_dmask"] = dmask
lti = make_distributed_merge(mesh, cfg, pq, insert_chunk=8, block=32)(
    lti, jnp.asarray(res["m_new"]), jnp.asarray(res["m_valid"]),
    jnp.asarray(dmask))
dump("lti2", lti)
res["s2_ids"], res["s2_d"] = map(np.asarray, search(lti, jnp.asarray(qs)))
search129 = make_distributed_search(mesh, cfg, k=%(K_WIDE)d, L=%(L_WIDE)d)
res["s3_ids"], res["s3_d"] = map(np.asarray,
                                 search129(lti, jnp.asarray(qs)))

# The sharded serving step over a live system (the merge donated the
# codebook's buffer with the LTI).
cb = pqm.PQCodebook(jnp.asarray(cent))
scfg = SystemConfig(
    index=IndexConfig(capacity=320, dim=D, R=8, L_build=16, L_search=24,
                      alpha=1.2, beam_width=4),
    pq=PQConfig(dim=D, m=4, ksub=16, kmeans_iters=3),
    ro_snapshot_points=48, merge_threshold=100_000, temp_capacity=96,
    insert_batch=16)
base = g.integers(-3, 4, (256, D)).astype(np.float32)
stream = g.integers(-3, 4, (120, D)).astype(np.float32)
sq = g.integers(-3, 4, (20, D)).astype(np.float32)
res.update(sys_base=base, sys_stream=stream, sys_qs=sq)
bg = build(base, scfg.index, batch=32, seed=0)
bcodes = jnp.zeros((320, 4), jnp.uint8).at[:256].set(
    pqm.encode(cb, jnp.asarray(base), scfg.pq))
dump("sys_lti", LTIState(bg, bcodes, cb))
table = np.full(320, -1, np.int64)
table[:256] = np.arange(256)
s = FreshDiskANN(scfg, lti=LTIState(bg, bcodes, cb), lti_ext_ids=table)
for i in range(120):
    s.insert(1000 + i, stream[i])
for e in (3, 17, 1005, 1050, 1100, 1119):
    s.delete(e)
rw_t, ro_temps, lti_entry = s._capture_lanes()
key, stack, t_tabs, l_tab, tables_np, _ = s._lane_bundle(rw_t, ro_temps,
                                                         lti_entry)
t_drop, l_drop = s._drop_mask(key, tables_np)
step = make_sharded_unified_step(mesh, scfg.index, k=5, k_lane=13, L=24,
                                 beam_width=4)
sg, sc = shard_lti(stack.lti, stack.codes, 4, mesh=mesh)
out = step(LaneStack(stack.temps, sg, sc, stack.codebook), t_tabs, l_tab,
           t_drop, l_drop, jnp.asarray(sq))
for name, x in zip(("ids", "d", "hops", "cmps"), out):
    res[f"step_{name}"] = np.asarray(x)
out = mem.unified_search(stack, t_tabs, l_tab, t_drop, l_drop,
                         jnp.asarray(sq), scfg.index, k=5, k_lane=13, L=24,
                         beam_width=4)
for name, x in zip(("ids", "d", "hops", "cmps"), out):
    res[f"dense_{name}"] = np.asarray(x)

from repro.launch import serve
train_pq = pqm.train_pq

def keep_codebook(data, cfg):
    cb = train_pq(data, cfg)
    res["serve_cent"] = np.asarray(cb.centroids)
    return cb

pqm.train_pq = keep_codebook
sys.argv = ["serve"] + %(SERVE_ARGS)r
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    serve.main()
res["serve_out"] = np.array(buf.getvalue())
np.savez(%(OUT)r, **res)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist") / "reference.npz"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    code = _REFERENCE % dict(D=D, CAP=CAP, N=N, SERVE_ARGS=SERVE_ARGS,
                             K_WIDE=K_WIDE, L_WIDE=L_WIDE, OUT=str(out))
    run = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert run.returncode == 0, run.stderr[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _lti(z, prefix):
    return convert.lti_state({f: z[f"{prefix}_{f}"] for f in F},
                             z[f"{prefix}_codes"], z["cent"], "cpu")


@pytest.fixture(scope="module")
def port_run(reference):
    """The port's pipeline on the reference's inputs, over 4 CPU shards."""
    z = reference
    devs = data_mesh(4, device="cpu")
    cfg = IndexConfig(capacity=CAP, dim=D, R=8, L_build=16, L_search=24,
                      alpha=1.2, beam_width=2)
    pq = PQConfig(dim=D, m=4, ksub=16, kmeans_iters=3)
    search = make_distributed_search(devs, cfg, k=5)
    qs = torch.from_numpy(z["qs"])
    lti = _lti(z, "lti0")
    out = {"s0": search(lti, qs)}
    lti = make_distributed_insert(devs, cfg, per_shard=8)(
        lti, torch.from_numpy(z["ins_new"]))
    out["lti1"] = lti
    out["s1"] = search(lti, qs)
    merged = make_distributed_merge(devs, cfg, pq, insert_chunk=8, block=32)(
        lti, torch.from_numpy(z["m_new"]), torch.from_numpy(z["m_valid"]),
        torch.from_numpy(z["m_dmask"]))
    out["lti2"] = merged
    out["s2"] = search(merged, qs)
    out["s3"] = make_distributed_search(devs, cfg, k=K_WIDE, L=L_WIDE)(
        merged, qs)
    return out


@pytest.mark.parametrize("stage", ["s0", "s1", "s2"])
def test_distributed_search_matches_reference(reference, port_run, stage):
    """Before any update, after the insert and after the merge: the
    cross-shard merge (``block_topk``'s plain version here) returns the
    reference's ids and dists, shard-order ties and all."""
    ids, d = port_run[stage]
    np.testing.assert_array_equal(ids.numpy(), reference[f"{stage}_ids"])
    np.testing.assert_array_equal(d.numpy(), reference[f"{stage}_d"])
    assert ids.shape == (12, 5) and (ids >= 0).all()


def test_distributed_search_wide_k_matches_reference(reference, port_run):
    """k 129 > block_topk's 128: the stable-sort merge returns the
    reference's ids and dists, ids -1 past the live candidates."""
    ids, d = port_run["s3"]
    np.testing.assert_array_equal(ids.numpy(), reference["s3_ids"])
    np.testing.assert_array_equal(d.numpy(), reference["s3_d"])
    assert ids.shape == (12, K_WIDE)
    assert ((ids >= 0) == np.isfinite(d.numpy())).all()
    assert (ids[:, 0] >= 0).all()


@pytest.mark.parametrize("stage", ["lti1", "lti2"])
def test_distributed_updates_match_reference(reference, port_run, stage):
    """The hash-routed insert and the shard-local merge leave every field
    of the stacked LTI equal to the reference's."""
    lti = port_run[stage]
    for f in F:
        np.testing.assert_array_equal(getattr(lti.graph, f).numpy(),
                                      reference[f"{stage}_{f}"], err_msg=f)
    np.testing.assert_array_equal(lti.codes.numpy(),
                                  reference[f"{stage}_codes"])


def test_distributed_updates_took_effect(reference, port_run):
    """The insert filled new slots in every shard; the merge removed the
    deleted points and added every valid staged row (freed slots may be
    reused)."""
    z = reference
    n_total = port_run["lti1"].graph.n_total.numpy()
    assert (n_total > z["lti0_n_total"]).all()
    before = int(port_run["lti1"].graph.active.sum())
    after = int(port_run["lti2"].graph.active.sum())
    n_dead = int(z["m_dmask"].sum())
    assert after == before - n_dead + int(z["m_valid"].sum())


def test_sharded_unified_step_matches_reference(reference):
    """The port's step over a CPU group of 4 equals the reference's over 4
    devices (and its unsharded program): ids, dists, hops, cmps."""
    z = reference
    scfg = SystemConfig(
        index=IndexConfig(capacity=320, dim=D, R=8, L_build=16, L_search=24,
                          alpha=1.2, beam_width=4),
        pq=PQConfig(dim=D, m=4, ksub=16, kmeans_iters=3),
        ro_snapshot_points=48, merge_threshold=100_000, temp_capacity=96,
        insert_batch=16)
    table = np.full(320, -1, np.int64)
    table[:256] = np.arange(256)
    s = FreshDiskANN(scfg, lti=_lti(z, "sys_lti"), lti_ext_ids=table,
                     device="cpu")
    for i in range(120):
        s.insert(1000 + i, z["sys_stream"][i])
    for e in (3, 17, 1005, 1050, 1100, 1119):
        s.delete(e)
    rw_t, ro_temps, lti_entry = s._capture_lanes()
    key, stack, t_tabs, l_tab, tables_np = s._lane_bundle(rw_t, ro_temps,
                                                          lti_entry)[:5]
    t_drop, l_drop = s._drop_mask(key, tables_np)
    from repro_torch.core.graph import LaneStack, shard_lti
    devs = data_mesh(4, device="cpu")
    step = make_sharded_unified_step(devs, scfg.index, k=5, k_lane=13, L=24,
                                     beam_width=4)
    sg, sc = shard_lti(stack.lti, stack.codes, 4, devices=devs)
    out = step(LaneStack(stack.temps, sg, sc, stack.codebook), t_tabs, l_tab,
               t_drop, l_drop, torch.from_numpy(z["sys_qs"]))
    for name, x in zip(("ids", "d", "hops", "cmps"), out):
        np.testing.assert_array_equal(x.numpy(), z[f"step_{name}"],
                                      err_msg=name)
        np.testing.assert_array_equal(x.numpy(), z[f"dense_{name}"],
                                      err_msg=name)


def _summary(text: str) -> dict:
    """The numbers of the driver's last line ("[serve] final: ...")."""
    last = [ln for ln in text.splitlines() if "final:" in ln][-1]
    return {k: float(v) for k, v in re.findall(r"(\w+)=([0-9.]+)", last)}


def test_serve_main_tiny_on_cpu(reference, capsys, monkeypatch):
    """The driver at a tiny size on the CPU, on the reference's PQ codebook
    (the parity rules: ``jax.random`` draws are not the port's): the
    reference's update and merge counts, and its recall within 0.01."""
    cent = reference["serve_cent"]
    monkeypatch.setattr(tpq, "train_pq", lambda data, cfg: tpq.PQCodebook(
        torch.from_numpy(cent).to(data.device)))
    got = serve.main(SERVE_ARGS + ["--device", "cpu"])
    want = _summary(str(reference["serve_out"]))
    assert _summary(capsys.readouterr().out)["inserts"] == got["inserts"]
    for key in ("inserts", "deletes", "merges"):
        assert got[key] == want[key], key
    assert got["size"] == 256
    assert abs(got["recall_mean"] - want["recall_mean"]) <= 0.01
    assert got["recall_mean"] >= 0.9
