"""How a window drives the program, one module per ``entry`` of a traffic
mix (``traffic/<mix>.json``), each with ``drive(run, mix, seed, seconds,
traced, solver, program)``. ``run.py`` finds the module by the entry's name,
so a new way of driving the program is a new file here."""
