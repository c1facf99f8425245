"""The port's ``runtime/dispatch.py`` against the JAX package: the bucket
schedule (``bucket_for``, ``quantize_capacity``) over 1..70,000 at the
reference's default options and at other ``bucket_base`` /
``max_waste_frac`` values, passed to the port as arguments. Exact."""

from __future__ import annotations

import pytest

from spark_rapids_jni_tpu.runtime import dispatch as jdispatch
from spark_rapids_jni_tpu.utils import config as jconfig
from spark_rapids_jni_tpu_torch.runtime import dispatch

OPTIONS = ("dispatch.enabled", "dispatch.bucket_base",
           "dispatch.max_waste_frac")
SPAN = range(1, 70_001)


@pytest.fixture(autouse=True)
def _default_options():
    yield
    for name in OPTIONS:
        jconfig.reset_option(name)


def test_defaults_match_reference():
    assert jdispatch.bucket_config() == \
        (True, dispatch.BUCKET_BASE, dispatch.MAX_WASTE_FRAC)
    assert [dispatch.bucket_for(n) for n in SPAN] == \
        [jdispatch.bucket_for(n) for n in SPAN]
    assert [dispatch.quantize_capacity(n) for n in SPAN] == \
        [jdispatch.quantize_capacity(n) for n in SPAN]


@pytest.mark.parametrize("base,waste", [
    (16, 1.0), (1, 1.0), (16, 0.0), (7, 0.0), (32, 0.5), (16, 0.25),
    (100, 3.0), (3, 0.1), (0, 1.0), (16, -1.0), (64, 1.0), (16, 2.0),
    (8, 0.75), (1, 0.0)])
def test_bucket_schedule_matches_reference(base, waste):
    jconfig.set_option("dispatch.bucket_base", base)
    jconfig.set_option("dispatch.max_waste_frac", waste)
    got = [dispatch.bucket_for(n, base, waste) for n in SPAN]
    assert got == [jdispatch.bucket_for(n) for n in SPAN]
    assert all(b >= n for b, n in zip(got, SPAN))
    assert [dispatch.quantize_capacity(n, base, waste) for n in SPAN] == \
        [jdispatch.quantize_capacity(n) for n in SPAN]
    assert dispatch.bucket_for(0, base, waste) == jdispatch.bucket_for(0)
