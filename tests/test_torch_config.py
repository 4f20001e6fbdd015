"""The port's configuration dataclasses carry the reference's field names,
order and defaults, so one configuration describes both packages."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.core import config as jconfig  # noqa: E402
from repro_torch.core import config as tconfig  # noqa: E402


def _fields(cls):
    return [(f.name, f.default, f.default_factory)
            for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["IndexConfig", "PQConfig",
                                  "SystemConfig"])
def test_fields_and_defaults_match_reference(name):
    assert _fields(getattr(tconfig, name)) == _fields(getattr(jconfig, name))


@pytest.mark.parametrize("L", [16, 75, 100])
@pytest.mark.parametrize("max_visits", [0, 48])
def test_visits_bound_matches_reference(L, max_visits):
    j = jconfig.IndexConfig(capacity=8, dim=4, max_visits=max_visits)
    t = tconfig.IndexConfig(capacity=8, dim=4, max_visits=max_visits)
    assert t.visits_bound(L) == j.visits_bound(L)


def test_pq_config_checks_and_paper_point():
    with pytest.raises(ValueError):
        tconfig.PQConfig(dim=30, m=8)
    assert tconfig.PQConfig(dim=128).dsub == jconfig.PQConfig(dim=128).dsub
    assert (dataclasses.asdict(tconfig.PAPER_BILLION)
            == dataclasses.asdict(jconfig.PAPER_BILLION))
