"""The benchmark's own tests: ``python -m pytest perfbench/tests -q`` from
the root of the checkout.  Tests marked ``cuda`` need a card and skip
without one."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card; skips without one")
