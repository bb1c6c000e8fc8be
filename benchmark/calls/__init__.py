"""What one call of the window does, one module per kind of call, named by a
traffic mix's ``call`` key.  Each module has ``make(program)``, which returns
a function of (instance, mark) that does one call through
``program.entry`` and returns (seconds building, seconds solving, the
solution).  ``mark(name)`` opens a range of the trace around a phase."""
