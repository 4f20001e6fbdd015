"""The recsys slice: FM, DeepFM, xDeepFM and SASRec serving in the port
against the reference, on the CPU at the smoke configs.

Reference parameters come from ``repro.models.recsys.init_recsys_params``
and cross to the port through ``convert.recsys_model``; inputs are numpy
draws from fixed seeds.  Tolerances:

* forwards, losses, user embeddings, serve steps: rtol 1e-5, atol 1e-6
  (the same f32 products summed in another order);
* ``retrieval_topk`` on integer-valued tables: ids and scores equal (every
  sum is exact, so ties are real ties and must come out lowest id
  first); on Gaussian data ids equal except where two scores are within
  1e-5 relative of each other;
* ``embedding_bag``: rtol 1e-6, atol 1e-7 (sums of a few terms);
* streams: byte-equal; configs: field for field;
* the retrieval twin (``examples/sasrec_retrieval.py`` steps 2-4): ids
  equal except at near ties (dists within 1e-5 relative), 10-recall@10
  against exact scoring within 0.01, no retired item from either.

The two port examples run in a subprocess with ``--device cpu``.
"""
import dataclasses
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

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.core import config as jconfig  # noqa: E402
from repro.core import system as jsystem  # noqa: E402
from repro.data import pipelines as jpipe  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro.serving import steps as jsteps  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import config as tconfig  # noqa: E402
from repro_torch.core import system as tsystem  # noqa: E402
from repro_torch.data import pipelines as tpipe  # noqa: E402
from repro_torch.models import recsys as trec  # noqa: E402
from repro_torch.serving import steps as tsteps  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KINDS = ["fm", "deepfm", "xdeepfm", "sasrec"]
TOL = dict(rtol=1e-5, atol=1e-6)


def _tcfg(cfg):
    """The port's config with the reference config's fields."""
    return trec.RecsysConfig(**dataclasses.asdict(cfg))


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module", params=KINDS)
def pair(request):
    """(kind, reference cfg, reference params, port cfg, port model)."""
    cfg = jconfigs.get_arch(request.param).smoke_config
    params = jrec.init_recsys_params(jax.random.PRNGKey(0), cfg)
    tcfg = _tcfg(cfg)
    return (request.param, cfg, params, tcfg,
            convert.recsys_model(_np_tree(params), tcfg, "cpu"))


def _ids(cfg, B, seed):
    g = np.random.default_rng(seed)
    return (g.integers(0, cfg.rows_per_field, (B, cfg.n_sparse))
            + np.arange(cfg.n_sparse) * cfg.rows_per_field).astype(np.int32)


def _seqs(cfg, B, seed):
    """Sequences with left padding, a fully padded row and a row with
    padding inside it."""
    g = np.random.default_rng(seed)
    seq = g.integers(1, cfg.n_items, (B, cfg.seq_len)).astype(np.int32)
    seq[0, :4] = 0
    seq[1] = 0
    seq[2, 3:5] = 0
    return seq


def _np(t):
    return t.detach().cpu().numpy()


def test_forward_and_loss_parity(pair):
    """The forward values and the loss of each model equal the reference's;
    the parameters make the round trip exactly."""
    kind, cfg, params, tcfg, model = pair
    back = convert.recsys_to_numpy(model)
    ref_tree = _np_tree(params)
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(ref_tree))
    for a, b in zip(jax.tree_util.tree_leaves(ref_tree),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with torch.no_grad():
        if kind == "sasrec":
            seq = _seqs(cfg, 9, 1)
            g = np.random.default_rng(2)
            pos = g.integers(0, cfg.n_items, seq.shape).astype(np.int32)
            pos[0, :3] = 0
            neg = g.integers(1, cfg.n_items, seq.shape).astype(np.int32)
            js = jnp.asarray(seq)
            ts = torch.from_numpy(seq)
            np.testing.assert_allclose(
                _np(trec.sasrec_encode(model, ts, tcfg)),
                np.asarray(jrec.sasrec_encode(params, js, cfg)), **TOL)
            np.testing.assert_allclose(
                _np(trec.sasrec_user_embedding(model, ts, tcfg)),
                np.asarray(jrec.sasrec_user_embedding(params, js, cfg)),
                **TOL)
            np.testing.assert_allclose(
                float(trec.sasrec_loss(model, ts, torch.from_numpy(pos),
                                       torch.from_numpy(neg), tcfg)),
                float(jrec.sasrec_loss(params, js, jnp.asarray(pos),
                                       jnp.asarray(neg), cfg)), **TOL)
            assert np.isfinite(_np(trec.sasrec_encode(model, ts, tcfg))).all()
        else:
            ids = _ids(cfg, 33, 1)
            labels = np.random.default_rng(3).integers(0, 2, 33).astype(
                np.int32)
            np.testing.assert_allclose(
                _np(trec.recsys_forward(model, torch.from_numpy(ids), tcfg)),
                np.asarray(jrec.recsys_forward(params, jnp.asarray(ids),
                                               cfg)), **TOL)
            np.testing.assert_allclose(
                float(trec.recsys_loss(model, torch.from_numpy(ids),
                                       torch.from_numpy(labels), tcfg)),
                float(jrec.recsys_loss(params, jnp.asarray(ids),
                                       jnp.asarray(labels), cfg)), **TOL)


def test_serve_and_retrieval_steps_match_reference(pair):
    kind, cfg, params, tcfg, model = pair
    g = np.random.default_rng(5)
    if kind != "sasrec":
        ids = _ids(cfg, 40, 6)
        np.testing.assert_allclose(
            _np(tsteps.make_recsys_serve_step(tcfg)(model,
                                                    torch.from_numpy(ids))),
            np.asarray(jsteps.make_recsys_serve_step(cfg)(
                params, jnp.asarray(ids))), **TOL)
        user = _ids(cfg, 3, 7)
    else:
        user = _seqs(cfg, 3, 7)
    # An integer-valued candidate table: the FM query (a sum of field
    # rows) and SASRec's are not integers, but scores of equal rows tie
    # exactly, and 40 % of the rows repeat another.
    table = g.integers(-2, 3, (2048, cfg.embed_dim)).astype(np.float32)
    table[g.random(2048) < 0.4] = table[0]
    want_s, want_i = jsteps.make_retrieval_step(cfg, k=20)(
        params, jnp.asarray(user), jnp.asarray(table))
    got_s, got_i = tsteps.make_retrieval_step(tcfg, k=20)(
        model, torch.from_numpy(user), torch.from_numpy(table))
    np.testing.assert_allclose(_np(got_s), np.asarray(want_s), **TOL)
    np.testing.assert_array_equal(_np(got_i), np.asarray(want_i))


@pytest.mark.parametrize("C,k,data", [
    (4096, 10, "integer"), (4096, 300, "integer"), (4000, 10, "integer"),
    (4096, 10, "gaussian"), (4000, 64, "gaussian")])
def test_retrieval_topk_both_branches(C, k, data):
    """The port's one stable sort against both of the reference's
    branches: two-stage (C 4096 in 16 blocks of 256) and direct (C 4000:
    16 does not divide it; k 300 > a block of 256).  Integer tables and
    queries make scores exact, so ids must be the reference's tie order."""
    g = np.random.default_rng(C + k)
    if data == "integer":
        q = g.integers(-2, 3, (6, 8)).astype(np.float32)
        table = g.integers(-1, 2, (C, 8)).astype(np.float32)
    else:
        q = g.standard_normal((6, 8)).astype(np.float32)
        table = g.standard_normal((C, 8)).astype(np.float32)
    want_s, want_i = jrec.retrieval_topk(jnp.asarray(q), jnp.asarray(table),
                                         k)
    got_s, got_i = trec.retrieval_topk(torch.from_numpy(q),
                                       torch.from_numpy(table), k)
    want_s, want_i = np.asarray(want_s), np.asarray(want_i)
    got_s, got_i = _np(got_s), _np(got_i)
    np.testing.assert_allclose(got_s, want_s, **TOL)
    if data == "integer":
        assert len(np.unique(want_s)) < want_s.size / 4     # tie-rich
        np.testing.assert_array_equal(got_i, want_i)
    else:
        scores = q @ table.T
        diff = got_i != want_i
        # A differing id must sit at a near tie: its score within 1e-5
        # relative of the reference's at that rank.
        rows = np.nonzero(diff)[0]
        near = np.isclose(scores[rows, got_i[diff]],
                          scores[rows, want_i[diff]], rtol=1e-5)
        assert near.all() and diff.mean() < 0.01


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_reference(mode):
    """Bags of 0 (empty: zeros), 1 and many ids, segments in no order."""
    g = np.random.default_rng(9)
    table = g.standard_normal((50, 6)).astype(np.float32)
    ids = g.integers(0, 50, 40).astype(np.int32)
    segments = g.integers(0, 7, 40).astype(np.int32)
    segments[segments == 3] = 4                  # bag 3 is empty
    segments[0] = 6
    segments[segments == 6] = 5
    segments[0] = 6                              # bag 6 holds one id
    want = np.asarray(jrec.embedding_bag(jnp.asarray(table),
                                         jnp.asarray(ids),
                                         jnp.asarray(segments), 8, mode))
    got = _np(trec.embedding_bag(torch.from_numpy(table),
                                 torch.from_numpy(ids),
                                 torch.from_numpy(segments), 8, mode))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert not got[3].any() and not got[7].any()
    empty = trec.embedding_bag(torch.from_numpy(table),
                               torch.zeros(0, dtype=torch.int32),
                               torch.zeros(0, dtype=torch.int32), 3, mode)
    assert empty.shape == (3, 6) and not empty.any()


def test_embedding_bag_skewed_bag():
    """One hot bag of 20,000 ids among 1,024 bags of 0-3 ids: the sums
    equal the reference's, and the port's memory follows the ids, not
    bags x the longest bag (a padded block would be 1.3 GB here)."""
    g = np.random.default_rng(4)
    table = g.standard_normal((5000, 16)).astype(np.float32)
    small = g.integers(0, 1024, 1500).astype(np.int32)
    segments = np.concatenate([small, np.full(20_000, 17, np.int32)])
    g.shuffle(segments)
    ids = g.integers(0, 5000, len(segments)).astype(np.int32)
    for mode in ("sum", "mean"):
        want = np.asarray(jrec.embedding_bag(
            jnp.asarray(table), jnp.asarray(ids), jnp.asarray(segments),
            1024, mode))
        got = _np(trec.embedding_bag(
            torch.from_numpy(table), torch.from_numpy(ids),
            torch.from_numpy(segments), 1024, mode))
        # Both sum each bag in id order, so even the hot bag's 20,000
        # terms agree to the other bags' tolerance.
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_chip_check_rows_cover_every_cin_chunk():
    """``chip_smoke.py`` holds 512 rows of each batch against the CPU: at
    serve_bulk the first 256 and 256 spread to the last row, so that each
    of xDeepFM's 39 CIN chunks holds checked rows."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert list(smoke.check_rows(512)) == list(range(512))
    B = smoke.RECSYS_BATCHES["serve_bulk"]
    rows = smoke.check_rows(B)
    assert len(np.unique(rows)) == 512 and rows[0] == 0 and rows[-1] == B - 1
    full = tconfigs.get_arch("xdeepfm").full_config
    m, d = full.n_sparse, full.embed_dim
    hs = [m] + list(full.cin_layers)
    ws = [torch.empty(hs[i + 1], hs[i], m, device="meta")
          for i in range(len(full.cin_layers))]
    chunk = trec.cin_chunk_rows(ws, (B, m, d))
    per_chunk = np.bincount(rows // chunk, minlength=-(-B // chunk))
    assert len(per_chunk) == 39 and per_chunk.min() >= 1


def test_xdeepfm_cin_chunks_equal_reference(monkeypatch):
    """The CIN in row chunks (forced small: 3 rows a chunk) equals the
    reference's unchunked forward row for row, and the port's own
    unchunked form; at the full config a serve_bulk batch is cut into
    chunks whose outer products fit ``CIN_CHUNK_BYTES``."""
    cfg = jconfigs.get_arch("xdeepfm").smoke_config
    params = jrec.init_recsys_params(jax.random.PRNGKey(1), cfg)
    tcfg = _tcfg(cfg)
    model = convert.recsys_model(_np_tree(params), tcfg, "cpu")
    ids = _ids(cfg, 20, 11)
    with torch.no_grad():
        whole = _np(trec.recsys_forward(model, torch.from_numpy(ids), tcfg))
        h_max, m, d = 8, cfg.n_sparse, cfg.embed_dim
        monkeypatch.setattr(trec, "CIN_CHUNK_BYTES", 3 * 4 * d * h_max * m)
        emb = trec.field_lookup(model.V, torch.from_numpy(ids), tcfg)
        assert trec.cin_chunk_rows(model.cin, emb.shape) == 3
        chunked = _np(trec.recsys_forward(model, torch.from_numpy(ids),
                                          tcfg))
    want = np.asarray(jrec.recsys_forward(params, jnp.asarray(ids), cfg))
    np.testing.assert_allclose(chunked, want, **TOL)
    np.testing.assert_allclose(chunked, whole, rtol=1e-6, atol=1e-7)
    monkeypatch.undo()
    full = tconfigs.get_arch("xdeepfm").full_config
    m, d = full.n_sparse, full.embed_dim
    hs = [m] + list(full.cin_layers)
    ws = [torch.empty(hs[i + 1], hs[i], m, device="meta")
          for i in range(len(full.cin_layers))]
    rows = trec.cin_chunk_rows(ws, (262_144, m, d))
    per_row = 4 * d * max(hs) * m          # one row's products, bytes
    assert rows * per_row <= trec.CIN_CHUNK_BYTES < (rows + 1) * per_row
    assert -(-262_144 // rows) == 39       # serve_bulk: 39 chunks


def test_init_draws_on_a_cpu_generator():
    """One seed gives the same weights twice, at the reference's shapes,
    dtypes and init scales."""
    for name in KINDS:
        cfg = jconfigs.get_arch(name).smoke_config
        ref = _np_tree(jrec.init_recsys_params(jax.random.PRNGKey(0), cfg))
        a = convert.recsys_to_numpy(trec.init_recsys_params(
            torch.Generator().manual_seed(3), _tcfg(cfg), "cpu"))
        b = convert.recsys_to_numpy(trec.init_recsys_params(
            torch.Generator().manual_seed(3), _tcfg(cfg), "cpu"))
        assert (jax.tree_util.tree_structure(a)
                == jax.tree_util.tree_structure(ref))
        for x, y, z in zip(jax.tree_util.tree_leaves(ref),
                           jax.tree_util.tree_leaves(a),
                           jax.tree_util.tree_leaves(b)):
            assert x.shape == y.shape and x.dtype == y.dtype
            assert np.array_equal(y, z)
            if x.size >= 256:             # the same scale, to 15 %
                assert abs(y.std() / x.std() - 1) < 0.15
            else:
                assert (x == 0).all() == (y == 0).all()


@pytest.mark.parametrize("seed", [0, 7])
def test_streams_byte_equal(seed):
    for make in ("click_stream", "sasrec_stream"):
        args = ((16, 5, 128) if make == "click_stream" else (16, 12, 512))
        ref = getattr(jpipe, make)(*args, seed=seed, start_step=2)
        port = getattr(tpipe, make)(*args, seed=seed, start_step=2)
        for _ in range(3):
            a, b = next(ref), next(port)
            assert a.keys() == b.keys()
            for key in a:
                assert a[key].dtype == b[key].dtype
                assert a[key].tobytes() == b[key].tobytes()


def _fields(x):
    return {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}


def _spec_eq(a, b):
    """A reference ``ShapeDtypeStruct`` and a port ``TensorSpec``."""
    return (tuple(a.shape) == tuple(b.shape)
            and np.dtype(a.dtype).name == str(b.dtype).split(".")[-1])


def test_configs_match_reference():
    for name in ("fm", "deepfm", "xdeepfm", "sasrec"):
        ja, ta = jconfigs.get_arch(name), tconfigs.get_arch(name)
        assert (ja.name, ja.family) == (ta.name, ta.family)
        for which in ("full_config", "smoke_config"):
            assert _fields(getattr(ja, which)) == _fields(getattr(ta,
                                                                  which))
        assert [c.shape for c in ja.cells] == [c.shape for c in ta.cells]
        for jc, tc in zip(ja.cells, ta.cells):
            assert (jc.kind, jc.meta, jc.skip) == (tc.kind, tc.meta, tc.skip)
            js, ts = jc.specs(), tc.specs()
            assert js.keys() == ts.keys()
            assert all(_spec_eq(js[k], ts[k]) for k in js)
    ja, ta = jconfigs.get_arch("freshdiskann-1b"), tconfigs.get_arch(
        "freshdiskann-1b")
    for which in ("full_config", "smoke_config"):
        a, b = getattr(ja, which), getattr(ta, which)
        fa, fb = _fields(a), _fields(b)
        assert _fields(fa.pop("index")) == _fields(fb.pop("index"))
        assert _fields(fa.pop("pq")) == _fields(fb.pop("pq"))
        assert fa == fb
    for jc, tc in zip(ja.cells, ta.cells, strict=True):
        assert (jc.shape, jc.kind, jc.meta) == (tc.shape, tc.kind, tc.meta)
        js, ts = jc.specs(), tc.specs()
        assert js.keys() == ts.keys()
        assert all(_spec_eq(js[k], ts[k]) for k in js)
    # every arch of the reference is ported, in the reference's order
    assert tconfigs.list_archs() == jconfigs.list_archs()
    with pytest.raises(KeyError):
        tconfigs.get_arch("no-such-arch")


def _scfg(mod, dim):
    """``examples/sasrec_retrieval.py``'s index config."""
    return mod.SystemConfig(
        index=mod.IndexConfig(capacity=4 * 512, dim=dim, R=24,
                              L_build=32, L_search=64, alpha=1.2),
        pq=mod.PQConfig(dim=dim, m=8, ksub=32, kmeans_iters=4),
        ro_snapshot_points=128, merge_threshold=256,
        temp_capacity=1024, insert_batch=64)


def test_sasrec_retrieval_twin():
    """``examples/sasrec_retrieval.py`` steps 2-4 at the smoke size: the
    reference bootstraps the index of normalized item embeddings, the
    port takes that LTI; both insert 64 new items, retire 64 and answer
    the same SASRec queries (the port's user embeddings equal the
    reference's to rtol 1e-5, and both search with the reference's)."""
    cfg = jconfigs.get_arch("sasrec").smoke_config
    n_items, d = cfg.n_items, cfg.embed_dim
    params = jrec.init_recsys_params(jax.random.PRNGKey(0), cfg)
    tcfg = _tcfg(cfg)
    model = convert.recsys_model(_np_tree(params), tcfg, "cpu")
    items = np.asarray(params["item_emb"])
    norm = items / np.maximum(np.linalg.norm(items, axis=1, keepdims=True),
                              1e-6)
    ref = jsystem.bootstrap_system(norm[1:], np.arange(1, n_items),
                                   _scfg(jconfig, d))
    lti = ref.lti
    port = tsystem.FreshDiskANN(
        _scfg(tconfig, d),
        lti=convert.lti_state(lti.graph, lti.codes, lti.codebook.centroids,
                              "cpu"),
        lti_ext_ids=convert.ext_table(ref.lti_ext_ids), device="cpu")
    rng = np.random.default_rng(5)
    new_vecs = rng.standard_normal((64, d)).astype(np.float32)
    new_vecs /= np.linalg.norm(new_vecs, axis=1, keepdims=True)
    retired = rng.choice(np.arange(1, n_items), 64, replace=False)
    for s in (ref, port):
        for i, v in enumerate(new_vecs):
            s.insert(n_items + i, v)
        for e in retired:
            s.delete(int(e))
    assert port.size == ref.size == n_items - 1
    seq = next(jpipe.sasrec_stream(64, cfg.seq_len, n_items, seed=2))["seq"]
    qv = np.asarray(jrec.sasrec_user_embedding(params, jnp.asarray(seq),
                                               cfg))
    with torch.no_grad():
        tqv = _np(trec.sasrec_user_embedding(model, torch.from_numpy(seq),
                                             tcfg))
    np.testing.assert_allclose(tqv, qv, **TOL)
    qv = qv / np.maximum(np.linalg.norm(qv, axis=1, keepdims=True), 1e-6)
    a_ids, a_d = ref.search(qv, k=10)
    b_ids, b_d = port.search(qv, k=10)
    assert not np.isin(a_ids, retired).any()
    assert not np.isin(b_ids, retired).any()
    diff = a_ids != b_ids
    assert diff.mean() < 0.05
    np.testing.assert_allclose(b_d[diff], a_d[diff], rtol=1e-5, atol=1e-6)
    old_live = np.setdiff1d(np.arange(1, n_items), retired)
    live = np.concatenate([old_live, np.arange(n_items, n_items + 64)])
    table = np.concatenate([norm[old_live], new_vecs])
    _, exact = trec.retrieval_topk(torch.from_numpy(qv),
                                   torch.from_numpy(table), 10)
    exact = live[_np(exact)]

    def recall(ids):
        return ((ids[:, :, None] == exact[:, None, :]).any(2)).sum(1).mean() \
            / 10

    assert abs(recall(a_ids) - recall(b_ids)) <= 0.01
    assert recall(b_ids) >= 0.8


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


def test_torch_quickstart_example():
    """The reference example prints 5-recall@5 0.775; the port trains its
    PQ start on a torch generator, so it must land within 0.05 of it."""
    out = _example("torch_quickstart.py")
    assert "size=2360 merges=1" in out
    rec = float(re.search(r"5-recall@5 vs brute force: ([0-9.]+)",
                          out).group(1))
    assert abs(rec - 0.775) <= 0.05


def test_torch_serve_ann_example():
    """A short steady state: 8,192 points and 0.02 minutes serve several
    search batches before the first threshold merge (2,048 staged points,
    32 cycles) is due -- the CPU's plain delete engine takes about a
    minute for a merge at this config."""
    out = _example("torch_serve_ann.py", "--minutes", "0.02", "--points",
                   "8192", "--batch-queries", "8")
    assert re.search(r"\[steady-state\] .* recall@5=0\.\d+", out)
    assert re.search(r"final: mean recall 0\.\d+, .* unified fan-out on cpu: "
                     r"2\.0 device programs per search batch", out)
