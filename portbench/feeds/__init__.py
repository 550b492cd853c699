"""The feeds of the program: one module per entry point a traffic mix
names (``traffic/<mix>.json``'s ``entry``). Each holds ``Cell(run)`` with
``warm()``, ``window(seconds)``, ``traced()``, ``e2e(window)``,
``release()`` and ``check()``, and ``reference_in_place(kind)``, which
puts the plain reference in the program's place (``calibrate.py``)."""
