"""Tests of the port that need a CUDA card.  Each is marked `card` and
skips without one; the files import no JAX, so on the card they run
without the conftest above, which does:

    python -m pytest tests/card -q --noconftest -p no:cacheprovider
"""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
