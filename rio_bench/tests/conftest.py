"""The benchmark's folder copied at CPU sizes (:mod:`.tiny`), as a fixture."""

import pytest

from .tiny import make_tiny


@pytest.fixture
def tiny(tmp_path):
    """``(registry, spec)`` of the benchmark's folder copied at CPU sizes."""
    return make_tiny(tmp_path)
