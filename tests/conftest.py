"""Shared fixtures.  NOTE: no XLA_FLAGS here — tests run on 1 CPU device;
only launch/dryrun.py forces 512 placeholder devices."""
import gc

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.core.config import IndexConfig, PQConfig


DIM = 24
N = 1200


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (CUDA kernels have no CPU "
        "mode); the test skips without one")


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables between test modules — the suite compiles
    hundreds of jit variants (5 LM archs x forward/decode/train, the ANN
    core, kernels in interpret mode); without this the CPU jaxlib arena
    grows monotonically and aborts natively near the end of the suite."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def points(rng):
    """Gaussian-mixture points (clustered, like real embeddings)."""
    centers = rng.standard_normal((24, DIM)) * 3.0
    which = rng.integers(0, 24, N)
    return (centers[which]
            + rng.standard_normal((N, DIM))).astype(np.float32)


@pytest.fixture(scope="session")
def queries(rng, points):
    # Depends on ``points`` (unused) to pin the draw order on the shared rng:
    # otherwise fixture instantiation order — which varies with the module
    # execution order — would change both streams and every recall number.
    del points
    centers = rng.standard_normal((24, DIM)) * 3.0
    which = rng.integers(0, 24, 64)
    return (centers[which]
            + rng.standard_normal((64, DIM))).astype(np.float32)


@pytest.fixture(scope="session")
def index_cfg():
    return IndexConfig(capacity=2048, dim=DIM, R=24, L_build=32,
                       L_search=48, alpha=1.2)


@pytest.fixture(scope="session")
def pq_cfg():
    return PQConfig(dim=DIM, m=8, ksub=32, kmeans_iters=5)


@pytest.fixture(scope="session")
def built_index(points, index_cfg):
    from repro.core.index import build
    return build(points, index_cfg, batch=128)
