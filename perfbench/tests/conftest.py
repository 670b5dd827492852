"""The benchmark's own tests: ``python -m pytest -q perfbench/tests`` from
the root of the repository (the repository's ``pytest.ini`` keeps them
out of ``tests/``'s run). Tests marked ``cuda`` run on the card only."""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
