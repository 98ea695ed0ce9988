"""CPU tests of the benchmark: python -m pytest benchmark/tests -q from
the root. Tests marked cuda need a card, decide inside the test, and skip
here; run them on the card's machine with
python -m pytest -p no:cacheprovider benchmark/tests -m cuda."""
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; decides inside the test and "
        "skips without one")
