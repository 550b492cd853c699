"""Tests of the benchmark itself (run: ``python -m pytest portbench/tests
-q -p no:cacheprovider``; the ``cuda`` ones need the card)."""
